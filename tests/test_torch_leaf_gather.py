"""GBDT leaf aggregation: the port's ``gbdt_leaf_sum`` against JAX.

``repro.kernels.ops.gbdt_leaf_sum`` runs here through the ``leaf_gather``
Pallas kernel in interpret mode; the port's runs through the kernel's
plain version on CPU tensors.  The two sum the trees in different orders,
so they agree within ``rtol=1e-5, atol=1e-4``, the tolerance of
``tests/test_kernels.py``'s own leaf_gather sweep.  Inputs are made with
NumPy from a seed.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.kernels as K
from repro.apps import gbdt as JG
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import convert
from repro_torch.kernels import ops, ref
from repro_torch.kernels.fused_session import FusedGbdtExec
from repro_torch.kernels.leaf_gather import MAX_STAGED_LEAVES, route

CSRC = Path(ref.__file__).resolve().parent / "csrc" / "leaf_gather.cu"
#: chip_smoke.py's tolerance for the kernel against the plain version
LEAF_TOL = 1e-4


def _leaves(rng, t: int, depth: int) -> np.ndarray:
    return rng.normal(size=(t, 1 << depth)).astype(np.float32)


@pytest.mark.parametrize("b,t,depth", [(8, 16, 4), (100, 64, 6),
                                       (256, 128, 8), (33, 7, 5)])
def test_leaf_gather_ref_matches_jax_ref(b, t, depth):
    rng = np.random.default_rng(b + t)
    addrs = rng.integers(0, 1 << depth, (b, t), dtype=np.int32)
    leaves = _leaves(rng, t, depth)
    want = jref.leaf_gather_ref(jnp.asarray(addrs), jnp.asarray(leaves))
    got = ref.leaf_gather_ref(torch.from_numpy(addrs),
                              torch.from_numpy(leaves))
    assert got.dtype == torch.float32 and got.shape == (b,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("b,t,depth", [(33, 7, 5), (100, 61, 6),
                                       (13, 130, 3)])
def test_gbdt_leaf_sum_matches_jax_kernel(b, t, depth):
    """B and T not multiples of 8; addresses -1 and >= L add 0 in both."""
    rng = np.random.default_rng(depth)
    nl = 1 << depth
    addrs = rng.integers(-1, nl + 3, (b, t), dtype=np.int32)
    addrs[0, :] = -1
    addrs[1, :] = nl
    leaves = _leaves(rng, t, depth)
    want = np.asarray(jops.gbdt_leaf_sum(jnp.asarray(addrs),
                                         jnp.asarray(leaves)))
    got = ops.gbdt_leaf_sum(addrs, leaves, device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    assert got[0] == 0 and got[1] == 0


@pytest.mark.parametrize("n_bits,chunks", [(8, 1), (16, 2)])
def test_leaf_sum_over_port_leaf_addrs_matches_reference_predict(n_bits,
                                                                 chunks):
    """The slice as a whole: the port's leaf addresses, summed by the
    port's leaf_gather, against the reference's ground truth."""
    forest = JG.ObliviousForest.random(57, 5, 6, n_bits, seed=n_bits)
    X = np.random.default_rng(1).integers(0, 1 << n_bits, (203, 6),
                                          dtype=np.uint64)
    tf = convert.forest(forest.feature_idx, forest.thresholds, forest.leaves,
                        forest.n_bits, forest.num_features)
    addrs = FusedGbdtExec(tf, chunks, device="cpu").leaf_addrs(X)
    got = ops.gbdt_leaf_sum(addrs, tf.leaves, device="cpu")
    err = np.abs(got.numpy() - JG.reference_predict(forest, X)).max()
    assert err <= 1e-3


def test_leaf_gather_on_cpu_counts_nothing_and_checks_inputs():
    K.reset_launch_counts()
    rng = np.random.default_rng(0)
    addrs = torch.from_numpy(rng.integers(0, 16, (5, 9), dtype=np.int32))
    leaves = torch.from_numpy(_leaves(rng, 9, 4))
    assert torch.equal(K.leaf_gather(addrs, leaves),
                       ref.leaf_gather_ref(addrs, leaves))
    assert K.launch_counts() == dict.fromkeys(K.KERNELS, 0)
    with pytest.raises(ValueError, match="int32"):
        K.leaf_gather(addrs.to(torch.int64), leaves)
    with pytest.raises(ValueError, match="float32"):
        K.leaf_gather(addrs, leaves.double())
    with pytest.raises(ValueError, match="trees"):
        K.leaf_gather(addrs, leaves[:8])


@pytest.mark.parametrize("t,n_leaves,offset,want", [
    (1000, 64, 0, (True, True)),      # the GBDT path: 16-byte rows, staged
    (1000, 64, 4, (False, True)),     # an unaligned view of the same rows
    (1000, 64, 8, (False, True)),
    (1000, 64, 16, (True, True)),
    (7, 32, 0, (False, True)),        # ragged rows
    (130, 64, 0, (False, True)),
    (1001, 1, 0, (False, True)),
    (4, 1, 0, (True, True)),          # depth 0
    (1000, 65, 0, (True, False)),     # leaves too many to stage
    (3, 128, 12, (False, False)),
])
def test_route_choice(t, n_leaves, offset, want):
    """The wrapper picks the kernel's route before the launch: 16-byte
    copies only when every row starts on a 16-byte boundary, staged
    leaves only up to ``MAX_STAGED_LEAVES`` per tree."""
    assert route(t, n_leaves, 1 << 20 | offset) == want


def test_route_of_an_unaligned_view():
    """A view one element into an aligned buffer is not on the 16-byte
    grid, so it takes the 4-byte route (the kernel copies nothing)."""
    flat = torch.zeros(4 * 1000 + 1, dtype=torch.int32)
    assert flat.data_ptr() % 16 == 0
    view = flat[1:].view(4, 1000)
    assert view.data_ptr() % 16 == 4
    assert route(1000, 64, view.data_ptr()) == (False, True)
    assert route(1000, 64, flat[:-1].view(4, 1000).data_ptr()) == (True,
                                                                   True)


def test_route_staged_limit_is_the_kernels():
    """``MAX_STAGED_LEAVES`` is the kernel's ``MAX_STAGED_L``: a larger L
    on the staged route would overrun its shared-memory tile."""
    m = re.search(r"constexpr int MAX_STAGED_L = (\d+);", CSRC.read_text())
    assert m and int(m.group(1)) == MAX_STAGED_LEAVES == 64


def _kernel_order_sum(addrs: np.ndarray, leaves: np.ndarray) -> np.ndarray:
    """The kernel's float32 summation order, on the host: eight partial
    sums per instance, one per tree t mod 8, each in ascending t, then
    ((s0 + s1) + (s2 + s3)) + ((s4 + s5) + (s6 + s7))."""
    t, nl = leaves.shape
    ok = (addrs >= 0) & (addrs < nl)
    vals = np.where(ok, leaves[np.arange(t), np.clip(addrs, 0, nl - 1)],
                    np.float32(0)).astype(np.float32)
    s = [np.cumsum(vals[:, q::8], axis=1, dtype=np.float32)[:, -1]
         if vals[:, q::8].shape[1] else np.zeros(len(vals), np.float32)
         for q in range(8)]
    return ((s[0] + s[1]) + (s[2] + s[3])) + ((s[4] + s[5]) + (s[6] + s[7]))


@pytest.mark.parametrize("t,depth", [(1000, 6), (1001, 6), (130, 3),
                                     (7, 0), (3, 1)])
def test_kernel_summation_order_stays_within_leaf_tol(t, depth):
    """1000 N(0, 1) leaves summed in one float32 chain can drift past
    ``LEAF_TOL``; the kernel's eight partial sums stay within it of the
    exact sum and of the plain version, addresses -1 and >= L included."""
    rng = np.random.default_rng(t)
    nl = 1 << depth
    addrs = rng.integers(-1, nl + 2, (4096, t)).astype(np.int32)
    addrs[0] = -1
    leaves = _leaves(rng, t, depth)
    got = _kernel_order_sum(addrs, leaves)
    ok = (addrs >= 0) & (addrs < nl)
    exact = np.where(ok, leaves.astype(np.float64)[
        np.arange(t), np.clip(addrs, 0, nl - 1)], 0.0).sum(1)
    assert np.abs(got - exact).max() <= LEAF_TOL
    plain = ref.leaf_gather_ref(torch.from_numpy(addrs),
                                torch.from_numpy(leaves)).numpy()
    assert np.abs(got - plain).max() <= LEAF_TOL
    assert got[0] == 0
