"""Plain versions of the port's kernels against the JAX package.

The JAX side runs as the reference's own CPU tests run it: ``encode_lut``
through the ``temporal_encode`` Pallas kernel in interpret mode, and
the predicate and GBDT kernels through their pure-jnp oracles in
``repro.kernels.ref``.  Inputs are made with NumPy from a seed; words
cross as bit patterns.  Every comparison is exact.
"""

import jax
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
    acc = _fold_terms(lut, idx, c, term_ranges, term_disj, conn_disj)
    bm, cnt = ref.fused_compound_banked_ref(
        convert.words_to_torch(lut), idx, c, term_ranges, term_disj,
        conn_disj)
    np.testing.assert_array_equal(_np(bm), acc)
    np.testing.assert_array_equal(
        cnt.numpy(), np.bitwise_count(acc).sum(-1).astype(np.int64))


_predicate_ref = jax.jit(jref.fused_predicate_banked_ref,
                         static_argnums=(2, 3, 4))


def _fold_terms(lut, idx, c, term_ranges, term_disj, conn_disj):
    """The reference's per-term fold: each term's bitmap from the JAX
    predicate oracle, folded left to right through the connectives."""
    acc, off = None, 0
    for t, (nr, disj) in enumerate(zip(term_ranges, term_disj)):
        part = idx[off:off + nr * 4 * c]
        off += nr * 4 * c
        tb, _ = _predicate_ref(jnp.asarray(lut), jnp.asarray(part), c, nr,
                               disj)
        tb = np.asarray(tb)
        acc = tb if acc is None else (
            (acc | tb) if conn_disj[t - 1] else (acc & tb))
    return acc


def _random_terms(rng, n_terms):
    term_ranges = tuple(int(x) for x in rng.integers(1, 3, n_terms))
    term_disj = tuple(bool(x) for x in rng.integers(0, 2, n_terms))
    conn_disj = tuple(bool(x) for x in rng.integers(0, 2, n_terms - 1))
    return term_ranges, term_disj, conn_disj


def test_fused_compound_banked_beyond_the_staged_indices():
    """More row indices than the kernel once staged in shared memory
    (12,288, formerly a limit on the card): the wrapper on the CPU
    equals the reference's per-term fold."""
    from repro_torch.kernels import fused_compound_banked

    rng = np.random.default_rng(12)
    c, s = 8, 2
    shape = _random_terms(rng, 300)
    n_idx = sum(shape[0]) * 4 * c
    assert n_idx > 12_288
    lut = _words(rng, (s, 48, 128))
    idx = rng.integers(0, 48, n_idx).astype(np.int32)
    bm, cnt = fused_compound_banked(convert.words_to_torch(lut), idx, c,
                                    *shape)
    want = _fold_terms(lut, idx, c, *shape)
    np.testing.assert_array_equal(_np(bm), want)
    np.testing.assert_array_equal(
        cnt.numpy(), np.bitwise_count(want).sum(-1).astype(np.int64))


@pytest.mark.parametrize("n_terms", [1, 2, 3, 40, 900])
def test_compound_program_runs_as_the_plain_version(n_terms):
    """The kernel's term program (one code per term), run by a plain
    interpreter over the ranges' bitmaps, equals the plain version; 900
    terms is longer than the codes the launch carries."""
    from repro_torch.kernels import fused_query as fq

    rng = np.random.default_rng(n_terms)
    c = 2
    shape = _random_terms(rng, n_terms)
    codes = fq.compound_program(*shape)
    assert codes.dtype == np.int32 and codes.shape == (n_terms,)
    lut = convert.words_to_torch(_words(rng, (2, 24, 64)))
    idx = rng.integers(0, 24, sum(shape[0]) * 4 * c).tolist()
    acc = torch.full((2, 64), -1, dtype=torch.int32)      # all ones
    r0 = 0
    for code in codes.tolist():
        nr = code >> 2
        tb = ref._range_bm(lut, idx, c, r0)
        for r in range(r0 + 1, r0 + nr):
            nxt = ref._range_bm(lut, idx, c, r)
            tb = (tb | nxt) if code & fq.TERM_OR else (tb & nxt)
        acc = (acc | tb) if code & fq.CONN_OR else (acc & tb)
        r0 += nr
    want, _ = ref.fused_compound_banked_ref(lut, idx, c, *shape)
    assert torch.equal(acc, want)


def test_gather_routes_follow_the_index_count_and_alignment():
    """The gather kernels' one route: 16-byte row loads where W % 4 == 0
    and the LUT is 16-byte aligned.  The index count picks none (the
    compound kernel reads any number through the read-only cache), so
    the launch takes no index route."""
    from repro_torch.kernels import _build

    flat = torch.zeros(2 * 5 * 1024 + 1, dtype=torch.int32)
    lut = flat[:-1].view(2, 5, 1024)
    assert common.quad_rows(lut)
    assert not common.quad_rows(flat[1:].view(2, 5, 1024))    # 4 bytes off
    assert not common.quad_rows(flat[:2 * 5 * 1022].view(2, 5, 1022))
    # lut, idx, n_idx, c, S, R, W, n_terms, codes, codes_dev, vec4, bm,
    # cnt, stream
    assert len(_build.SIGNATURES["fused_query"]["compound_launch"]) == 14


def test_clutch_merge_banked_beyond_65535_banks():
    """More banks than a grid's y dimension (formerly a limit on the
    card): the plain version equals the JAX oracle on a sample of
    banks."""
    from repro_torch.kernels import clutch_merge_banked

    rng = np.random.default_rng(7)
    b, r, w, c = 70_000, 11, 2, 5
    lut = _words(rng, (b, r, w))
    lt = rng.integers(0, r, (b, c)).astype(np.int32)
    le = rng.integers(0, r, (b, c)).astype(np.int32)
    got = _np(clutch_merge_banked(convert.words_to_torch(lut), lt, le))
    assert got.shape == (b, w)
    for k in [0, 1, 65_534, 65_535, 65_536, b - 1,
              *rng.integers(0, b, 20).tolist()]:
        want = jref.clutch_merge_ref(jnp.asarray(lut[k]), jnp.asarray(lt[k]),
                                     jnp.asarray(le[k]))
        np.testing.assert_array_equal(got[k], np.asarray(want))


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


@pytest.mark.parametrize("rows,smem_rows", [
    (264, True),        # the GBDT path: 1000 trees, 8 bits, one chunk
    (777, True),        # the tallest LUT whose 64-word slice fits
    (778, False),       # rows read from global memory
    (131074, False),
])
def test_leafbits_layout_follows_the_shared_memory_fit(rows, smem_rows):
    from repro_torch.kernels import fused_query as fq

    staged, nbytes = fq.leafbits_layout(rows)
    assert staged == smem_rows
    fixed = (fq.LEAF_WARPS * fq.LEAF_GROUP * fq.LEAF_SLOTS
             + fq.LEAF_LIVE) * 4
    assert nbytes == (rows * fq.LEAF_SLICE * 4 if staged else 0) + fixed
    assert nbytes <= fq.SMEM_PER_BLOCK


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
