"""GBDT leaf aggregation: the port's ``gbdt_leaf_sum`` against JAX.

``repro.kernels.ops.gbdt_leaf_sum`` runs here through the ``leaf_gather``
Pallas kernel in interpret mode; the port's runs through the kernel's
plain version on CPU tensors.  The two sum the trees in different orders,
so they agree within ``rtol=1e-5, atol=1e-4``, the tolerance of
``tests/test_kernels.py``'s own leaf_gather sweep.  Inputs are made with
NumPy from a seed.
"""

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
