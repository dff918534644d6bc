"""Plain versions of the port's kernels against the JAX package.

The JAX side runs as the reference's own CPU tests run it: ``encode_lut``
through the ``temporal_encode`` Pallas kernel in interpret mode, and
the predicate and GBDT kernels through their pure-jnp oracles in
``repro.kernels.ref``.  Inputs are made with NumPy from a seed; words
cross as bit patterns.  Every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import encoding as jenc
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import convert
from repro_torch.core import encoding as tenc
from repro_torch.kernels import common, ops, ref


def _words(rng, shape):
    return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)


def _np(t: torch.Tensor) -> np.ndarray:
    return convert.words_to_numpy(t)


# ------------------------------ encode_lut ------------------------------ #

@pytest.mark.parametrize("n_bits,chunks,n,complement", [
    (8, 2, 1000, False),
    (8, 2, 1000, True),
    (8, 1, 77, False),
    (12, 3, 12000, False),       # W = 384 words: not a power of two
    (16, 4, 4100, True),
    (32, 5, 300, False),
    (32, 8, 999, False),
    (32, 8, 999, True),
])
def test_encode_lut_matches_jax(n_bits, chunks, n, complement):
    rng = np.random.default_rng(n + n_bits)
    v = rng.integers(0, 1 << n_bits, n, dtype=np.uint64).astype(np.uint32)
    v[0] = (1 << n_bits) - 1
    if n_bits == 32:
        v[1] = 1 << 31                      # values >= 2^31 survive
    want = np.asarray(jops.encode_lut(
        jnp.asarray(v), jenc.make_plan(n_bits, chunks),
        complement=complement))
    got = ops.encode_lut(torch.from_numpy(v.view(np.int32)),
                         tenc.make_plan(n_bits, chunks),
                         complement=complement)
    assert got.dtype == torch.int32
    assert got.shape == want.shape
    np.testing.assert_array_equal(_np(got), want)
    assert ops.lut_rows(tenc.make_plan(n_bits, chunks)) == want.shape[0]


@pytest.mark.parametrize("k", [1, 4, 8])
def test_temporal_encode_ref_matches_jax(k):
    rng = np.random.default_rng(k)
    v = rng.integers(0, 1 << k, 200, dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jref.temporal_encode_ref(jnp.asarray(v), k))
    got = ref.temporal_encode_ref(torch.from_numpy(v.view(np.int32)), k)
    np.testing.assert_array_equal(_np(got), want)


def test_clutch_merge_ref_matches_jax():
    rng = np.random.default_rng(3)
    lut = _words(rng, (40, 256))
    lt, le = rng.integers(0, 40, 5), rng.integers(0, 40, 5)
    want = np.asarray(jref.clutch_merge_ref(jnp.asarray(lut),
                                            jnp.asarray(lt), jnp.asarray(le)))
    got = ref.clutch_merge_ref(convert.words_to_torch(lut), lt, le)
    np.testing.assert_array_equal(_np(got), want)


# ---------------------------- fused predicates --------------------------- #

@pytest.mark.parametrize("num_ranges,disjunction,shards,chunks", [
    (1, False, 1, 2),
    (2, False, 2, 3),
    (2, True, 3, 1),
    (2, True, 2, 4),
])
def test_fused_predicate_banked_ref_matches_jax(num_ranges, disjunction,
                                                shards, chunks):
    rng = np.random.default_rng(shards * 10 + chunks)
    lut = _words(rng, (shards, 48, 384))
    idx = rng.integers(0, 48, num_ranges * 4 * chunks).astype(np.int32)
    wbm, wcnt = jref.fused_predicate_banked_ref(
        jnp.asarray(lut), jnp.asarray(idx), chunks, num_ranges, disjunction)
    bm, cnt = ref.fused_predicate_banked_ref(
        convert.words_to_torch(lut), idx, chunks, num_ranges, disjunction)
    np.testing.assert_array_equal(_np(bm), np.asarray(wbm))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(wcnt))


@pytest.mark.parametrize("term_ranges,term_disj,conn_disj", [
    ((1,), (False,), ()),
    ((2, 1), (True, False), (False,)),
    ((1, 2, 2), (False, False, True), (True, False)),
])
def test_fused_compound_banked_ref_matches_jax_term_fold(
        term_ranges, term_disj, conn_disj):
    """The compound plain version equals the per-term fold of the JAX
    predicate oracle's bitmaps (the reference has no compound oracle)."""
    rng = np.random.default_rng(len(term_ranges))
    c, s = 3, 2
    lut = _words(rng, (s, 64, 256))
    idx = rng.integers(0, 64, sum(term_ranges) * 4 * c).astype(np.int32)
    acc, off = None, 0
    for t, (nr, disj) in enumerate(zip(term_ranges, term_disj)):
        part = idx[off:off + nr * 4 * c]
        off += nr * 4 * c
        tb, _ = jref.fused_predicate_banked_ref(
            jnp.asarray(lut), jnp.asarray(part), c, nr, disj)
        tb = np.asarray(tb)
        acc = tb if acc is None else (
            (acc | tb) if conn_disj[t - 1] else (acc & tb))
    bm, cnt = ref.fused_compound_banked_ref(
        convert.words_to_torch(lut), idx, c, term_ranges, term_disj,
        conn_disj)
    np.testing.assert_array_equal(_np(bm), acc)
    np.testing.assert_array_equal(
        cnt.numpy(), np.bitwise_count(acc).sum(-1).astype(np.int64))


# ------------------------------ GBDT leaf bits ---------------------------- #

@pytest.mark.parametrize("chunks,features,batch", [(1, 5, 7), (2, 3, 4),
                                                   (3, 8, 3)])
def test_gbdt_leafbits_banked_ref_matches_jax(chunks, features, batch):
    rng = np.random.default_rng(chunks * 7 + features)
    lut = _words(rng, (40, 256))
    masks = _words(rng, (common.round_up(features, 8), 256))
    idx = rng.integers(0, 40, (batch, features * 2 * chunks)).astype(np.int32)
    want = jref.gbdt_leafbits_banked_ref(jnp.asarray(lut), jnp.asarray(masks),
                                         jnp.asarray(idx), chunks, features)
    got = ref.gbdt_leafbits_banked_ref(
        convert.words_to_torch(lut), convert.words_to_torch(masks),
        torch.from_numpy(idx), chunks, features)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


# ------------------------------ bit helpers ------------------------------- #

def test_torch_bit_helpers_match_numpy():
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, (3, 100)).astype(np.uint8)
    packed = common.pack_bits(bits)
    got = common.pack_bits_torch(torch.from_numpy(bits))
    np.testing.assert_array_equal(_np(got), packed)
    np.testing.assert_array_equal(
        common.unpack_bits_torch(got, 100).numpy(),
        common.unpack_bits(packed, 100))
    words = _words(rng, (4, 64))
    words[0, 0] = 0xFFFFFFFF
    np.testing.assert_array_equal(
        common.popcount_torch(convert.words_to_torch(words)).numpy(),
        np.bitwise_count(words))
