"""The port's comparison front-ends against the JAX package and NumPy.

The kernels behind these front-ends (``clutch_merge``,
``clutch_merge_banked``, ``fused_range_count``, ``bitserial_cmp``) run
through their plain versions here, on CPU tensors.  The JAX side runs
what runs on the CPU: ``encode_lut`` and ``encode_bitplanes``, the index
resolution, and the pure-jnp oracles of ``repro.kernels.ref``.  The
front-ends are held against the NumPy spec of ``tests/test_kernels.py``
(``values > a``, ``x0 < values < x1``).  Inputs are made with NumPy from
a seed; words cross as bit patterns.  Every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.kernels as K
from repro.apps import predicate as jpred
from repro.core import encoding as jenc
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import convert
from repro_torch.core import encoding as tenc
from repro_torch.kernels import common, ops, ref

PLANS = [(8, 1), (8, 2), (16, 2), (16, 4), (32, 5), (32, 8)]


def _np(t: torch.Tensor) -> np.ndarray:
    return convert.words_to_numpy(t)


def _values(rng, n_bits: int, n: int) -> np.ndarray:
    """uint32 values with both ends of the range (and 2^31 at 32 bits)."""
    v = rng.integers(0, 1 << n_bits, n, dtype=np.uint64).astype(np.uint32)
    v[:2] = [0, (1 << n_bits) - 1]
    if n_bits == 32:
        v[2] = 1 << 31
    return v


def _scalars(rng, n_bits: int) -> list[int]:
    mx = (1 << n_bits) - 1
    out = [0, 1, 1 << (n_bits - 1), mx - 1, mx, int(rng.integers(0, mx))]
    if n_bits == 32:
        out.append(3_000_000_000)               # >= 2^31
    return out


def _jax_lut(v: np.ndarray, n_bits: int, chunks: int, complement=False):
    return np.asarray(jops.encode_lut(jnp.asarray(v),
                                      jenc.make_plan(n_bits, chunks),
                                      complement=complement))


# ------------------------- plain versions vs JAX ------------------------- #

@pytest.mark.parametrize("n_bits,chunks,banks", [(8, 2, 3), (16, 4, 4),
                                                 (16, 2, 1), (32, 5, 2)])
def test_clutch_merge_banked_ref_matches_jax(n_bits, chunks, banks):
    rng = np.random.default_rng(n_bits + banks)
    vals = [_values(rng, n_bits, 700) for _ in range(banks)]
    lut = np.stack([_jax_lut(v, n_bits, chunks) for v in vals])
    a = np.array(([-1] + _scalars(rng, n_bits))[:banks], np.int64)
    lt, le = jops.resolve_indices_banked(jenc.make_plan(n_bits, chunks), a)
    want = np.stack([np.asarray(jref.clutch_merge_ref(
        jnp.asarray(lut[b]), jnp.asarray(lt[b]), jnp.asarray(le[b])))
        for b in range(banks)])
    got = ref.clutch_merge_banked_ref(convert.words_to_torch(lut), lt, le)
    np.testing.assert_array_equal(_np(got), want)


@pytest.mark.parametrize("n_bits,chunks", [(8, 2), (16, 4), (32, 8)])
def test_fused_range_count_ref_matches_jax(n_bits, chunks):
    rng = np.random.default_rng(n_bits)
    v = _values(rng, n_bits, 3333)
    lut, lut_c = (_jax_lut(v, n_bits, chunks, c) for c in (False, True))
    plan, mx = jenc.make_plan(n_bits, chunks), (1 << n_bits) - 1
    for x0, x1 in ((mx // 5, 4 * mx // 5), (0, mx), (mx - 1, mx), (0, 1)):
        gt = jops.resolve_indices(plan, x0)
        lt = jops.resolve_indices(plan, mx - x1)
        wbm, wcnt = jref.fused_range_count_ref(
            jnp.asarray(lut), jnp.asarray(lut_c), *map(jnp.asarray, gt + lt))
        bm, cnt = ref.fused_range_count_ref(
            convert.words_to_torch(lut), convert.words_to_torch(lut_c),
            np.concatenate(gt + lt), chunks)
        np.testing.assert_array_equal(_np(bm), np.asarray(wbm))
        assert cnt.dim() == 0 and cnt.dtype == torch.int64
        assert int(cnt) == int(wcnt)


@pytest.mark.parametrize("n_bits", [4, 8, 16, 32])
def test_bitserial_cmp_ref_matches_jax(n_bits):
    rng = np.random.default_rng(n_bits)
    v = _values(rng, n_bits, 4096)
    planes = np.asarray(jops.encode_bitplanes(jnp.asarray(v), n_bits))
    # scalars with bits above n_bits: both read only the low n_bits
    for a in _scalars(rng, n_bits) + [0xFFFFFFFF, (1 << 31) | 5]:
        want = jref.bitserial_cmp_ref(jnp.asarray(planes[:n_bits]),
                                      np.uint32(a), n_bits)
        got = ref.bitserial_cmp_ref(convert.words_to_torch(planes), a,
                                    n_bits)
        np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("n_bits,n", [(4, 77), (8, 4096), (13, 5000),
                                      (16, 12001), (32, 999)])
def test_encode_bitplanes_matches_jax(n_bits, n):
    v = _values(np.random.default_rng(n), n_bits, n)
    want = np.asarray(jops.encode_bitplanes(jnp.asarray(v), n_bits))
    got = ops.encode_bitplanes(v, n_bits, device="cpu")
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(_np(got), want)


@pytest.mark.parametrize("n_bits,chunks", [(8, 2), (16, 4), (32, 5)])
def test_compare_gt_scalar_matches_jax_oracle(n_bits, chunks):
    rng = np.random.default_rng(chunks)
    v = _values(rng, n_bits, 3000)
    lut = _jax_lut(v, n_bits, chunks)
    plan = tenc.make_plan(n_bits, chunks)
    for a in _scalars(rng, n_bits):
        lt, le = ops.resolve_indices(plan, a)
        want = jref.clutch_merge_ref(jnp.asarray(lut), jnp.asarray(lt),
                                     jnp.asarray(le))
        got = ops.compare_gt_scalar(lut, lt, le, device="cpu")
        np.testing.assert_array_equal(_np(got), np.asarray(want))


# ---------------------- front-ends vs the NumPy spec ---------------------- #

@pytest.mark.parametrize("n_bits,chunks", PLANS)
def test_clutch_compare_matches_numpy(n_bits, chunks):
    rng = np.random.default_rng(n_bits * chunks)
    v = _values(rng, n_bits, 12001)          # W = 384 words: not 2^k
    plan = tenc.make_plan(n_bits, chunks)
    for a in _scalars(rng, n_bits):
        got = ops.clutch_compare(v, a, plan, device="cpu")
        assert got.dtype == torch.bool and got.shape == (12001,)
        np.testing.assert_array_equal(got.numpy(), v.astype(np.int64) > a)
    with pytest.raises(ValueError, match="out of range"):
        ops.clutch_compare(v, 1 << n_bits, plan, device="cpu")


@pytest.mark.parametrize("n_bits,chunks,banks", [(8, 2, 3), (16, 4, 4),
                                                 (16, 2, 1), (32, 5, 6)])
def test_clutch_compare_banked_matches_numpy(n_bits, chunks, banks):
    rng = np.random.default_rng(banks)
    vals = np.stack([_values(rng, n_bits, 700) for _ in range(banks)])
    mx = (1 << n_bits) - 1
    pool = [0, mx, -1, 123 % mx, int(rng.integers(0, mx)), -1]
    a = np.array(pool[:banks], np.int64)
    plan = tenc.make_plan(n_bits, chunks)
    got = ops.clutch_compare_banked(vals, a, plan, device="cpu")
    want = vals.astype(np.int64) > a[:, None]     # -1 < everything
    np.testing.assert_array_equal(got.numpy(), want)
    # a tensor input keeps its (CPU) device
    got_t = ops.clutch_compare_banked(
        torch.from_numpy(vals.view(np.int32)), a, plan)
    np.testing.assert_array_equal(got_t.numpy(), want)
    with pytest.raises(ValueError, match="out of range"):
        ops.clutch_compare_banked(vals, np.full(banks, mx + 1), plan,
                                  device="cpu")


@pytest.mark.parametrize("n_bits,chunks", [(8, 2), (16, 4), (32, 8)])
def test_range_count_matches_numpy(n_bits, chunks):
    rng = np.random.default_rng(chunks + 1)
    n = 3333
    v = _values(rng, n_bits, n)
    plan, mx = tenc.make_plan(n_bits, chunks), (1 << n_bits) - 1
    vt = torch.from_numpy(v.view(np.int32))
    lut = ops.encode_lut(vt, plan)
    lut_c = ops.encode_lut(vt, plan, complement=True)
    for x0, x1 in ((mx // 5, 4 * mx // 5), (0, mx), (mx - 1, mx), (0, 1),
                   (1 << (n_bits - 1), mx)):
        gt, lt = ops.resolve_indices(plan, x0), ops.resolve_indices(plan,
                                                                    mx - x1)
        words, cnt = ops.range_count(lut, lut_c, np.concatenate(gt + lt),
                                     chunks)
        want = (v > x0) & (v < x1)
        np.testing.assert_array_equal(
            common.unpack_bits_torch(words, n).bool().numpy(), want)
        bits = common.unpack_bits_torch(words, 32 * words.shape[0])
        assert not bits[n:].any()
        assert int(cnt) == int(want.sum())


@pytest.mark.parametrize("n_bits", [4, 8, 16, 32])
def test_bitserial_compare_matches_numpy(n_bits):
    rng = np.random.default_rng(n_bits + 3)
    v = _values(rng, n_bits, 5000)
    planes = ops.encode_bitplanes(v, n_bits, device="cpu")
    mask = (1 << n_bits) - 1
    above = [0xFFFFFFFF] + ([(mask + 1) | 7] if n_bits < 32 else [])
    for a in _scalars(rng, n_bits) + above:
        words = ops.bitserial_compare(planes, a, n_bits)
        got = common.unpack_bits_torch(words, 5000).bool().numpy()
        np.testing.assert_array_equal(got, v.astype(np.int64) > (a & mask))


# --------------------------- the slice as a whole ------------------------- #

@pytest.mark.parametrize("n_bits,chunks", [(8, 1), (16, 2), (32, 5)])
def test_clutch_and_bitserial_give_equal_words(n_bits, chunks):
    """The paper's two comparators, on the same 2^12 values: equal
    words, padding included."""
    rng = np.random.default_rng(12)
    v = _values(rng, n_bits, 1 << 12)
    plan = tenc.make_plan(n_bits, chunks)
    vt = torch.from_numpy(v.view(np.int32))
    lut = ops.encode_lut(vt, plan)
    planes = ops.encode_bitplanes(vt, n_bits)
    for a in _scalars(rng, n_bits):
        clutch = ops.compare_gt_scalar(lut, *ops.resolve_indices(plan, a))
        np.testing.assert_array_equal(
            _np(clutch), _np(ops.bitserial_compare(planes, a, n_bits)))


@pytest.mark.parametrize("n_bits,chunks", [(16, 4), (32, 8)])
def test_range_count_equals_reference_q1(n_bits, chunks):
    table = jpred.Table.generate(5001, n_bits, num_features=2, seed=n_bits)
    mx = (1 << n_bits) - 1
    plan = tenc.make_plan(n_bits, chunks)
    vt = torch.from_numpy(table.features[1].astype(np.uint32).view(np.int32))
    lut = ops.encode_lut(vt, plan)
    lut_c = ops.encode_lut(vt, plan, complement=True)
    for x0, x1 in ((mx // 8, mx // 2), (0, mx), (mx // 3, mx // 3 + 1)):
        gt, lt = ops.resolve_indices(plan, x0), ops.resolve_indices(plan,
                                                                    mx - x1)
        _, cnt = ops.range_count(lut, lut_c, np.concatenate(gt + lt), chunks)
        assert int(cnt) == int(jpred.reference_q1(table, 1, x0, x1).sum())


# ------------------------- devices, counts, inputs ------------------------ #

def test_wrappers_on_cpu_take_the_plain_version_and_count_nothing():
    K.reset_launch_counts()
    rng = np.random.default_rng(5)
    plan = tenc.make_plan(16, 4)
    vt = torch.from_numpy(_values(rng, 16, 1000).view(np.int32))
    lut = ops.encode_lut(vt, plan)
    lt, le = ops.resolve_indices(plan, 777)
    assert torch.equal(K.clutch_merge(lut, lt, le),
                       ref.clutch_merge_ref(lut, lt, le))
    blt, ble = ops.resolve_indices_banked(plan, np.array([777, -1]))
    luts = torch.stack([lut, lut])
    assert torch.equal(K.clutch_merge_banked(luts, blt, ble),
                       ref.clutch_merge_banked_ref(luts, blt, ble))
    idx = np.concatenate([lt, le, lt, le])
    got = K.fused_range_count(lut, lut, idx, 4)
    want = ref.fused_range_count_ref(lut, lut, idx, 4)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    planes = ops.encode_bitplanes(vt, 16)
    assert torch.equal(K.bitserial_cmp(planes, 777, 16),
                       ref.bitserial_cmp_ref(planes, 777, 16))
    assert K.launch_counts() == dict.fromkeys(K.KERNELS, 0)


def test_wrappers_reject_out_of_range_indices_and_bad_inputs():
    lut = torch.zeros((16, 128), dtype=torch.int32)
    ok = np.array([0, 1], np.int32)
    for bad in (np.array([0, 16], np.int32), np.array([-1, 0], np.int32)):
        with pytest.raises(ValueError, match="outside"):
            K.clutch_merge(lut, bad, ok)
        with pytest.raises(ValueError, match="outside"):
            K.clutch_merge_banked(lut[None], bad[None], ok[None])
        with pytest.raises(ValueError, match="outside"):
            K.fused_range_count(lut, lut, np.concatenate([ok, ok, ok, bad]),
                                2)
    with pytest.raises(ValueError, match="lt/le indices"):
        K.clutch_merge(lut, ok, ok[:1])
    with pytest.raises(ValueError, match="lt/le indices"):
        K.clutch_merge_banked(lut[None].expand(2, -1, -1), ok[None],
                              ok[None])
    with pytest.raises(ValueError, match="idx must be"):
        K.fused_range_count(lut, lut, np.zeros(6, np.int32), 2)
    with pytest.raises(ValueError, match="shapes differ"):
        K.fused_range_count(lut, lut[:8], np.zeros(8, np.int32), 2)
    with pytest.raises(ValueError, match="int32"):
        K.clutch_merge(lut.to(torch.int64), ok, ok)
    with pytest.raises(ValueError, match="uint32"):
        K.bitserial_cmp(lut, 1 << 32, 8)
    with pytest.raises(ValueError, match="uint32"):
        K.bitserial_cmp(lut, -1, 8)
    with pytest.raises(ValueError, match="n_bits"):
        K.bitserial_cmp(lut[:8], 0, 9)


def test_front_ends_raise_without_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    v = np.arange(100, dtype=np.uint32)
    plan = tenc.make_plan(8, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ops.clutch_compare(v, 5, plan)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ops.clutch_compare_banked(v[None], np.array([5]), plan)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ops.encode_bitplanes(v, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ops.gbdt_leaf_sum(np.zeros((2, 3), np.int32),
                          np.zeros((3, 4), np.float32))
    assert ops.clutch_compare(v, 5, plan, device="cpu").sum() == 94


def test_front_ends_reject_tensors_on_several_devices():
    lut = torch.zeros((16, 128), dtype=torch.int32)
    idx = np.zeros(8, np.int32)
    with pytest.raises(ValueError, match="several devices"):
        ops.range_count(lut, lut.to("meta"), idx, 2)
