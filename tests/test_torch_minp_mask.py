"""The serving sampler's min-p mask: the port against JAX.

``repro.kernels.ops.sample_threshold_mask`` runs here through the
``minp_mask`` Pallas kernel in interpret mode; the port's runs through the
kernel's plain version on CPU tensors.  The Pallas source is the spec, so
the two must agree bit for bit (compared as int32 bit patterns, so NaN
payloads count), -0.0, NaN, infinities and denormals included.  The
reference's float oracle ``minp_mask_ref`` differs from the kernel on a
logit -0.0 against tau +0.0 and on NaN logits; the tests pin both
differences and hold the two equal everywhere else.  Inputs are made
with NumPy from a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro_torch.kernels as K
from repro.kernels import common as jcommon
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import common, ops, ref

EDGE = np.array([0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf, 1e-45, -1e-45,
                 1e-38, -1e-38, 1.17549435e-38, -1e30, 3.0, -3.0, 1e30,
                 3.4028235e38, -3.4028235e38], np.float32)


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


def _jax_mask(logits: np.ndarray, tau: np.ndarray, **kw) -> np.ndarray:
    return np.asarray(jops.sample_threshold_mask(jnp.asarray(logits),
                                                 jnp.asarray(tau), **kw))


def _port_mask(logits: np.ndarray, tau: np.ndarray, **kw) -> np.ndarray:
    return ops.sample_threshold_mask(logits, tau, device="cpu", **kw).numpy()


def _edge_batch(rng, b: int, v: int, edge: np.ndarray = EDGE):
    """Every edge value in every row, and thresholds that are edge values
    too, one equal to a logit of its row."""
    x = (rng.normal(size=(b, v)) * 8).astype(np.float32)
    for r in range(b):
        cols = rng.choice(v, size=min(v, edge.size), replace=False)
        x[r, cols] = edge[:cols.size]
    tau = rng.choice(edge, size=b).astype(np.float32)
    tau[0] = x[0, v // 2]
    return x, tau


def test_monotonic_u32_matches_jax_on_edge_values():
    """The edge values of tests/test_kernels.py's order test and more."""
    x = np.concatenate([np.float32([-1e30, -5.5, -0.0, 0.0, 1e-9, 3.14,
                                    2e30]), EDGE])
    want = np.asarray(jcommon.float_to_monotonic_u32(jnp.asarray(x)))
    got = common.float_to_monotonic_u32(torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    ordered = np.concatenate([[-np.inf], np.sort(x[np.isfinite(x) & (x < 0)]),
                              [-0.0, 0.0], np.sort(x[x > 0]), [np.nan]])
    u = common.float_to_monotonic_u32(
        torch.from_numpy(ordered.astype(np.float32))).numpy()
    assert (np.diff(u.view(np.uint32).astype(np.int64)) >= 0).all()


@pytest.mark.parametrize("b,v", [(1, 100), (4, 1024), (8, 50000), (3, 7)])
def test_sample_threshold_mask_matches_jax_kernel(b, v):
    """The shapes of tests/test_kernels.py's minp_mask sweep."""
    rng = np.random.default_rng(b * 1000 + v)
    logits = (rng.normal(size=(b, v)) * 8).astype(np.float32)
    tau = rng.normal(size=(b,)).astype(np.float32)
    got = _port_mask(logits, tau)
    assert got.shape == (b, v) and got.dtype == np.float32
    np.testing.assert_array_equal(_bits(got), _bits(_jax_mask(logits, tau)))


@pytest.mark.parametrize("b,v", [(2, 7), (3, 100), (4, 300), (1, 17)])
def test_edge_batch_matches_jax_kernel_bit_for_bit(b, v):
    """+-0, +-NaN, +-inf, denormals, the largest floats, tau equal to a
    logit: the port's plain version equals the Pallas kernel."""
    x, tau = _edge_batch(np.random.default_rng(v), b, v)
    np.testing.assert_array_equal(_bits(_port_mask(x, tau)),
                                  _bits(_jax_mask(x, tau)))


@pytest.mark.parametrize("chunks", [(8, 8, 8, 8), (16, 16), (32,),
                                    (4,) * 8, (5, 7, 9, 11)])
def test_chunkings_match_jax_kernel(chunks):
    x, tau = _edge_batch(np.random.default_rng(len(chunks)), 3, 300)
    np.testing.assert_array_equal(
        _bits(_port_mask(x, tau, chunks=chunks)),
        _bits(_jax_mask(x, tau, chunks=chunks)))


@settings(deadline=None, max_examples=20)
@given(st.floats(-100, 100, width=32), st.integers(1, 4))
def test_tau_sweep_matches_jax_kernel(tau_val, b):
    rng = np.random.default_rng(b)
    logits = (rng.normal(size=(b, 300)) * 50).astype(np.float32)
    tau = np.full((b,), tau_val, np.float32)
    np.testing.assert_array_equal(_bits(_port_mask(logits, tau)),
                                  _bits(_jax_mask(logits, tau)))


@pytest.mark.parametrize("b,v", [(1, 100), (8, 50000), (3, 7), (5, 1001)])
def test_kernel_semantics_equal_float_oracle_without_zeros_or_nan(b, v):
    """Away from +-0 and NaN, the monotonic compare is the float compare:
    the port's plain version equals the reference's float oracle, and so
    does the port's own float oracle."""
    rng = np.random.default_rng(v)
    logits = (rng.normal(size=(b, v)) * 8).astype(np.float32)
    logits[0, :3] = [np.inf, -np.inf, 1e-45]
    tau = rng.normal(size=(b,)).astype(np.float32)
    tau[-1] = logits[-1, v // 3]
    want = _bits(jref.minp_mask_ref(jnp.asarray(logits), jnp.asarray(tau)))
    lt, tt = torch.from_numpy(logits), torch.from_numpy(tau)
    np.testing.assert_array_equal(_bits(ref.minp_mask_ref(lt, tt)), want)
    np.testing.assert_array_equal(_bits(ref.minp_mask_float_ref(lt, tt)),
                                  want)


def test_float_oracle_matches_reference_float_oracle_on_edges():
    """Denormals left out: XLA on the CPU compares floats with denormals
    flushed to zero (-1e-45 >= 0.0 holds there), PyTorch compares them
    as they are.  The kernels' monotonic compare is exact on both."""
    normal = EDGE[~((EDGE != 0) & (np.abs(EDGE) < 1.17549435e-38))]
    x, tau = _edge_batch(np.random.default_rng(1), 4, 64, normal)
    want = jref.minp_mask_ref(jnp.asarray(x), jnp.asarray(tau))
    got = ref.minp_mask_float_ref(torch.from_numpy(x), torch.from_numpy(tau))
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_the_two_documented_differences_from_the_float_oracle():
    """Kernel (both packages): -0.0 < +0.0 and +NaN above everything;
    float oracle: -0.0 == +0.0 and NaN compares false."""
    fill = np.float32(-1e30)
    x = np.array([[-0.0, 0.0, np.nan, -np.nan, 1.0]], np.float32)
    tau = np.array([0.0], np.float32)
    kernel = _jax_mask(x, tau)
    np.testing.assert_array_equal(_bits(_port_mask(x, tau)), _bits(kernel))
    oracle = np.asarray(jref.minp_mask_ref(jnp.asarray(x), jnp.asarray(tau)))
    # logit -0.0 against tau +0.0: the kernel drops it, the oracle keeps it
    assert kernel[0, 0] == fill and _bits(oracle)[0, 0] == _bits(x)[0, 0]
    # +NaN: the kernel keeps it, the oracle drops it; -NaN: both drop it
    assert np.isnan(kernel[0, 2]) and oracle[0, 2] == fill
    assert kernel[0, 3] == fill and oracle[0, 3] == fill
    # everything else agrees
    np.testing.assert_array_equal(_bits(kernel)[0, [1, 4]],
                                  _bits(oracle)[0, [1, 4]])
    got = ref.minp_mask_float_ref(torch.from_numpy(x),
                                  torch.from_numpy(tau)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(oracle))


# the chunkings of chip_smoke.py's phase 2, then more drawn from a seeded
# generator: 32 bits cut at 1-7 random points (the wrapper takes 1-8
# chunks)
PHASE2_CHUNKINGS = [(8, 8, 8, 8), (16, 16), (32,), (4,) * 8, (5, 7, 9, 11)]


def _drawn_chunkings(n: int, seed: int = 17) -> list[tuple[int, ...]]:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        cuts = np.sort(rng.choice(np.arange(1, 32), size=rng.integers(1, 8),
                                  replace=False))
        out.append(tuple(int(k) for k in np.diff(np.r_[0, cuts, 32])))
    return out


def _pattern_batch(rng, b: int, v: int):
    """[b, v] float32 logits that are uniform random uint32 bit patterns
    (NaNs with payloads, infinities, denormals and -0.0 all occur or are
    planted), every row holding the edge values; taus drawn from the same
    patterns, then the edge values themselves."""
    x = rng.integers(0, 2 ** 32, (b, v), dtype=np.uint64).astype(
        np.uint32).view(np.float32)
    x[:, :EDGE.size] = EDGE
    x[:, EDGE.size] = np.uint32(0x7FC00001).view(np.float32)    # +NaN, payload
    x[:, EDGE.size + 1] = np.uint32(0xFF800001).view(np.float32)  # -sNaN
    tau = x[np.arange(b), rng.integers(0, v, b)].copy()
    n = min(b, EDGE.size)
    tau[:n] = EDGE[:n]
    return x, tau


def _one_compare(logits: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    """The kernel's form of the mask: one unsigned compare of the images."""
    xu = common.float_to_monotonic_u32(logits).to(torch.int64) & 0xFFFFFFFF
    tu = common.float_to_monotonic_u32(tau).to(torch.int64) & 0xFFFFFFFF
    return torch.where(xu >= tu[:, None], logits, ref.MINP_FILL)


@pytest.mark.parametrize("chunks", PHASE2_CHUNKINGS + _drawn_chunkings(5))
def test_recurrence_equals_one_compare_bit_for_bit(chunks):
    """The claim the kernel rests on: for any chunking whose widths sum
    to 32, the Clutch recurrence of the plain version gives m(x) >= m(tau),
    one unsigned compare, bit for bit, over 2^20 random bit patterns and
    the edge values, against taus drawn from the same patterns."""
    assert sum(chunks) == 32
    x, tau = _pattern_batch(np.random.default_rng(len(chunks)), 64, 2 ** 14)
    xt, tt = torch.from_numpy(x), torch.from_numpy(tau)
    want = _one_compare(xt, tt)
    np.testing.assert_array_equal(_bits(ref.minp_mask_ref(xt, tt, chunks)),
                                  _bits(want))
    np.testing.assert_array_equal(_bits(K.minp_mask(xt, tt, chunks)),
                                  _bits(want))
    # both outcomes occur, and NaN payloads pass through unchanged
    kept = _bits(want) != _bits(np.float32(ref.MINP_FILL))
    assert 0 < kept.sum() < kept.size
    nan = np.isnan(x)
    assert (_bits(want)[nan & kept] == _bits(x)[nan & kept]).all()


@pytest.mark.parametrize("chunks", PHASE2_CHUNKINGS + _drawn_chunkings(2))
def test_one_compare_matches_jax_kernel_on_bit_patterns(chunks):
    """On a small batch of the same patterns, the Pallas kernel in
    interpret mode, the port's recurrence and the one compare agree."""
    x, tau = _pattern_batch(np.random.default_rng(99), 4, 300)
    want = _bits(_jax_mask(x, tau, chunks=chunks))
    xt, tt = torch.from_numpy(x), torch.from_numpy(tau)
    np.testing.assert_array_equal(_bits(ref.minp_mask_ref(xt, tt, chunks)),
                                  want)
    np.testing.assert_array_equal(_bits(_one_compare(xt, tt)), want)


def test_wrapper_on_cpu_counts_no_launch_and_checks_its_inputs():
    K.reset_launch_counts()
    x = torch.zeros((2, 5))
    t = torch.zeros(2)
    K.minp_mask(x, t)
    assert K.minp_mask.launches == 0
    with pytest.raises(ValueError, match="chunks"):
        K.minp_mask(x, t, chunks=(8, 8, 8))
    with pytest.raises(ValueError, match="chunks"):
        K.minp_mask(x, t, chunks=(4,) * 7 + (2, 2))
    # the kernel no longer reads the chunking; the wrapper still checks it
    for bad in ((0, 32), (33,), (40, -8), ()):
        with pytest.raises(ValueError, match="chunks"):
            K.minp_mask(x, t, chunks=bad)
    with pytest.raises(ValueError, match="logits"):
        K.minp_mask(x.double(), t)
    with pytest.raises(ValueError, match="tau"):
        K.minp_mask(x, torch.zeros(3))
