"""Fused Clutch predicates, range count and GBDT leaf bits: wrappers of
the CUDA kernels.

Replaces four TPU kernels of ``src/repro/kernels/fused_query.py``:

* ``fused_predicate_banked`` -- 1-2 range predicates (AND/OR) over a
  whole sharded LUT plus a per-shard popcount, in one launch;
* ``fused_compound_banked`` -- compound predicates: each term's ranges
  with the term's own AND/OR, folded left to right through the
  connectives, plus the popcount;
* ``fused_range_count`` -- one range ``x0 < B < x1`` over separate
  normal and complement LUTs, plus its popcount;
* ``gbdt_leafbits_banked`` -- per instance, per feature, the Algorithm 1
  merge on the shared threshold LUT OR-ed into the leaf-address bitmap
  through the feature's one-hot mask.

and adds one that replaces none, ``gbdt_leafbits_sum``: the predictions
from that bitmap, summed on the card in the float32 order of the host's
``apps.gbdt.assemble_leaves`` (see the note in the CUDA source).

The first two share one CUDA function (``csrc/fused_query.cu ::
compound_kernel``), the predicate being the one-term compound; each
wrapper keeps its own launch count.  A compound takes any number of
terms and ranges: the wrapper hands the kernel a term program
(:func:`compound_program`, one int32 code per term), and the kernel
reads any number of row indices.  All five are bound by memory traffic (see the notes in the CUDA
source).  A CPU tensor takes the
plain version from :mod:`repro_torch.kernels.ref`.

Row indices may be given on the host (NumPy or a CPU tensor): they are
checked against the LUT's row count and copied to the card.  Indices
already on the card are clamped into range by the kernel.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import _build
from .common import check_words, index_tensor, on_card, quad_rows
from .ref import (
    fused_compound_banked_ref,
    fused_range_count_ref,
    gbdt_leafbits_banked_ref,
    gbdt_leafbits_sum_ref,
    numpy_row_run,
)

# csrc/fused_query.cu :: compound_kernel's term program: the flags of a
# term's code, and the terms whose codes ride in the launch's parameters
TERM_OR, CONN_OR = 1, 2
PROG_PARAM = 768
# csrc/fused_query.cu :: leafbits_kernel: warps per block, instances per
# warp group, index slots per instance staged at once, words of
# live-feature bits, words of a block's slice
LEAF_WARPS, LEAF_GROUP, LEAF_SLOTS, LEAF_LIVE, LEAF_SLICE = 8, 16, 64, 192, 64
SMEM_PER_BLOCK = 232448     # shared memory one block may have on Hopper
# csrc/fused_query.cu :: leafsum_kernel: the most leaf blocks and pending
# sums of its program, the largest block (NumPy's PW_BLOCKSIZE), the
# deepest tree it decodes
SUM_PROG, SUM_STACK, SUM_BLOCK, SUM_MAX_DEPTH = 1024, 16, 128, 30


def leafbits_layout(rows: int) -> tuple[bool, int]:
    """Whether ``leafbits_kernel`` stages the rows of a LUT of ``rows``
    rows in shared memory (a block's 64-word slice of every row, beside
    the index buffers and the live-feature bits) or reads them from
    global memory, and the shared bytes a block takes."""
    fixed = (LEAF_WARPS * LEAF_GROUP * LEAF_SLOTS + LEAF_LIVE) * 4
    staged = rows * LEAF_SLICE * 4 + fixed
    if staged <= SMEM_PER_BLOCK:
        return True, staged
    return False, fixed


@functools.lru_cache(maxsize=64)
def sum_program(trees: int, run: int) -> tuple[tuple[int, ...], int]:
    """The order in which ``leafsum_kernel`` sums ``trees`` values, and
    the stack it needs: NumPy's ``.sum(-1)`` of a C-ordered float32 row
    taken ``run`` values at a time (``ref.numpy_row_run``).

    One code per leaf block, in evaluation order: ``length | joins <<
    8``.  The block's sum is pushed, then each join adds the top two
    sums, the deeper one first.  A run's pairwise tree splits ``n >
    SUM_BLOCK`` values at ``n // 2`` rounded down to a multiple of 8;
    each run after the first joins the running total."""
    codes: list[int] = []

    def plan(n: int) -> None:
        if n <= SUM_BLOCK:
            codes.append(n)
            return
        n2 = n // 2 - n // 2 % 8
        plan(n2)
        plan(n - n2)
        codes[-1] += 1 << 8

    for t0 in range(0, max(trees, 1), run):
        plan(min(run, trees - t0))
        if t0:
            codes[-1] += 1 << 8
    sp = stack = 0
    for c in codes:
        sp += 1
        stack = max(stack, sp)
        sp -= c >> 8
    return tuple(codes), stack


def compound_program(term_ranges, term_disj, conn_disj) -> np.ndarray:
    """The term program of ``compound_kernel``: one int32 code per term,
    ``ranges << 2 | TERM_OR | CONN_OR``.

    The term's ranges (``ranges``, consecutive in the index array) join
    with OR when ``TERM_OR``, else AND; the term joins the result with
    OR when ``CONN_OR``, else AND.  The result starts all ones, so the
    first term (joined with AND) is the term itself."""
    return np.asarray(
        [(nr << 2) | (TERM_OR if disj else 0)
         | (CONN_OR if t and conn_disj[t - 1] else 0)
         for t, (nr, disj) in enumerate(zip(term_ranges, term_disj))],
        np.int32)


def _compound(lut, idx, num_chunks, term_ranges, term_disj, conn_disj):
    """Shared body of the two predicate wrappers; returns the outputs
    and whether the kernel was launched."""
    check_words(lut, 3)
    term_ranges = tuple(int(n) for n in term_ranges)
    if not term_ranges:
        raise ValueError("need at least one term")
    if len(term_disj) != len(term_ranges) or \
            len(conn_disj) != len(term_ranges) - 1:
        raise ValueError("need one term_disj per term and one "
                         "conn_disj per connective")
    if min(term_ranges) < 1:
        raise ValueError(f"every term needs a range: {term_ranges}")
    n_idx = sum(term_ranges) * 4 * num_chunks
    s, r, w = lut.shape
    idx = index_tensor(idx, r, lut.device)
    if tuple(idx.shape) != (n_idx,):
        raise ValueError(f"idx must be [{n_idx}], got {tuple(idx.shape)}")
    if not on_card(lut, idx):
        return fused_compound_banked_ref(lut, idx, num_chunks, term_ranges,
                                         term_disj, conn_disj), False
    lut = lut.contiguous()
    bm = torch.empty((s, w), dtype=torch.int32, device=lut.device)
    cnt = torch.zeros((s,), dtype=torch.int64, device=lut.device)
    codes = compound_program(term_ranges, term_disj, conn_disj)
    # a program longer than the launch's parameters is read from the card
    codes_dev = torch.from_numpy(codes).to(lut.device) \
        if codes.size > PROG_PARAM else None
    lib = _build.load("fused_query")
    stream = torch.cuda.current_stream(lut.device).cuda_stream
    err = lib.compound_launch(
        lut.data_ptr(), idx.data_ptr(), n_idx, num_chunks, s, r, w,
        codes.size, codes.ctypes.data,
        None if codes_dev is None else codes_dev.data_ptr(),
        int(quad_rows(lut)), bm.data_ptr(), cnt.data_ptr(), stream)
    _build.check(lib, err, "fused_query.compound_kernel")
    return (bm, cnt), True


def fused_predicate_banked(lut: torch.Tensor, idx, num_chunks: int,
                           num_ranges: int, disjunction: bool = False
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """One-launch Q1-Q3-shaped predicate over a whole sharded LUT.

    lut: [S, R, W] int32 -- per record shard, every feature's normal
    planes then every feature's complement planes.  idx: [num_ranges *
    4 * C] -- per range the (gt_lt, gt_le, lt_lt, lt_le) row indices,
    already offset to the feature's block.  ``num_ranges`` ranges are
    combined with AND, or OR when ``disjunction``.  Returns (bitmap
    [S, W] int32, per-shard popcount [S] int64)."""
    out, launched = _compound(lut, idx, num_chunks, (num_ranges,),
                              (disjunction,), ())
    if launched:
        fused_predicate_banked.launches += 1
    return out


def fused_compound_banked(lut: torch.Tensor, idx, num_chunks: int,
                          term_ranges: tuple, term_disj: tuple,
                          conn_disj: tuple
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """One-launch compound predicate ``term0 <op0> term1 ...``.

    ``lut``/``idx`` as in :func:`fused_predicate_banked`, ``idx``
    holding every range of every term in term order.  ``term_ranges[t]``
    ranges per term, combined with ``term_disj[t]`` (True = OR); the
    term bitmaps fold left to right through ``conn_disj`` (True = OR).
    Returns (bitmap [S, W] int32, per-shard popcount [S] int64)."""
    out, launched = _compound(lut, idx, num_chunks, term_ranges,
                              term_disj, conn_disj)
    if launched:
        fused_compound_banked.launches += 1
    return out


def fused_range_count(lut: torch.Tensor, lut_c: torch.Tensor, idx,
                      num_chunks: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused ``x0 < B < x1`` bitmap and COUNT in one launch.

    lut / lut_c: [R, W] int32 normal and complement planes of one
    column.  idx: [4C] -- (gt_lt, gt_le, lt_lt, lt_le) row indices, the
    gt-side into ``lut`` and the lt-side into ``lut_c``.  Returns
    (bitmap [W] int32, count: 0-d int64)."""
    check_words(lut, 2)
    check_words(lut_c, 2, "complement LUT")
    if lut_c.shape != lut.shape:
        raise ValueError(f"LUT shapes differ: {tuple(lut.shape)} vs "
                         f"{tuple(lut_c.shape)}")
    r, w = lut.shape
    idx = index_tensor(idx, r, lut.device)
    if num_chunks < 1 or tuple(idx.shape) != (4 * num_chunks,):
        raise ValueError(f"idx must be [4 * {num_chunks}], got "
                         f"{tuple(idx.shape)}")
    if not on_card(lut, lut_c, idx):
        return fused_range_count_ref(lut, lut_c, idx, num_chunks)
    lut, lut_c = lut.contiguous(), lut_c.contiguous()
    bm = torch.empty((w,), dtype=torch.int32, device=lut.device)
    cnt = torch.zeros((), dtype=torch.int64, device=lut.device)
    lib = _build.load("fused_query")
    stream = torch.cuda.current_stream(lut.device).cuda_stream
    err = lib.range_count_launch(lut.data_ptr(), lut_c.data_ptr(),
                                 idx.data_ptr(), num_chunks, r, w,
                                 bm.data_ptr(), cnt.data_ptr(), stream)
    _build.check(lib, err, "fused_query.range_count_kernel")
    fused_range_count.launches += 1
    return bm, cnt


def gbdt_leafbits_banked(lut: torch.Tensor, masks: torch.Tensor, idx,
                         num_chunks: int, num_features: int
                         ) -> torch.Tensor:
    """One-launch GBDT leaf-address bitmap for a whole instance batch.

    lut: [R, W] int32 threshold planes, shared by every instance.
    masks: [F_pad, W] int32 one-hot feature masks (rows past
    ``num_features`` are padding).  idx: [B, F * 2C] -- per instance,
    per feature, the (lt, le) row indices of its value.  Returns the
    leaf-address bitmap [B, W] int32."""
    check_words(lut, 2)
    check_words(masks, 2, "masks")
    r, w = lut.shape
    if masks.shape[1] != w or masks.shape[0] < num_features:
        raise ValueError(f"masks {tuple(masks.shape)} do not fit "
                         f"{num_features} features x {w} words")
    idx = index_tensor(idx, r, lut.device)
    n = num_features * 2 * num_chunks
    if idx.dim() != 2 or idx.shape[1] != n:
        raise ValueError(f"idx must be [B, {n}], got {tuple(idx.shape)}")
    if not on_card(lut, masks, idx):
        return gbdt_leafbits_banked_ref(lut, masks, idx, num_chunks,
                                        num_features)
    if num_features > 32 * LEAF_LIVE or 2 * num_chunks > LEAF_SLOTS:
        raise ValueError(f"leafbits_kernel takes at most {32 * LEAF_LIVE} "
                         f"features of at most {LEAF_SLOTS // 2} chunks, "
                         f"got {num_features} of {num_chunks}")
    lut, masks = lut.contiguous(), masks.contiguous()
    b = idx.shape[0]
    out = torch.empty((b, w), dtype=torch.int32, device=lut.device)
    lib = _build.load("fused_query")
    stream = torch.cuda.current_stream(lut.device).cuda_stream
    smem_rows, _ = leafbits_layout(r)
    err = lib.leafbits_launch(
        lut.data_ptr(), masks.data_ptr(), idx.data_ptr(), num_chunks,
        num_features, b, r, w, int(smem_rows), out.data_ptr(), stream)
    _build.check(lib, err, "fused_query.leafbits_kernel")
    gbdt_leafbits_banked.launches += 1
    return out


def gbdt_leafbits_sum(bm: torch.Tensor, leaves: torch.Tensor, trees: int,
                      depth: int) -> torch.Tensor:
    """GBDT predictions from the leaf-address bitmap, in one launch.

    bm: [B, W] int32 from :func:`gbdt_leafbits_banked`, node ``n = t *
    depth + d`` at word ``n // 32``, bit ``n % 32``; leaves: [trees, L]
    float32, ``L >= 2 ** depth``.  Tree ``t``'s address is ``sum_d
    bit(t, d) << (depth - 1 - d)``.  Returns [B] float32: per instance
    the sum of ``leaves[t, addr_t]`` over the trees in the order of
    NumPy's ``.sum(-1)`` (:func:`sum_program` over
    ``ref.numpy_row_run``), the bits of ``apps.gbdt.assemble_leaves``
    over the same addresses (C-ordered)."""
    check_words(bm, 2, "bitmap")
    if leaves.dim() != 2 or leaves.dtype != torch.float32:
        raise ValueError(f"leaves must be a 2-D float32 tensor, got "
                         f"{leaves.dim()}-D {leaves.dtype}")
    trees, depth = int(trees), int(depth)
    b, w = bm.shape
    if leaves.shape[0] != trees:
        raise ValueError(f"{trees} trees but {leaves.shape[0]} rows of "
                         "leaves")
    if not 1 <= depth <= SUM_MAX_DEPTH or leaves.shape[1] < 1 << depth:
        raise ValueError(f"depth {depth} needs 1 <= depth <= "
                         f"{SUM_MAX_DEPTH} and 2 ** depth leaves a tree, "
                         f"got {leaves.shape[1]}")
    if trees * depth > 32 * w:
        raise ValueError(f"{trees} trees of depth {depth} need "
                         f"{trees * depth} bits, the bitmap holds {32 * w}")
    if not on_card(bm, leaves):
        return gbdt_leafbits_sum_ref(bm, leaves, trees, depth)
    codes, stack = sum_program(trees, numpy_row_run(trees))
    if len(codes) > SUM_PROG or stack > SUM_STACK:
        raise ValueError(f"{trees} trees sum in {len(codes)} blocks with "
                         f"{stack} pending; leafsum_kernel takes "
                         f"{SUM_PROG} and {SUM_STACK}")
    bm, leaves = bm.contiguous(), leaves.contiguous()
    out = torch.empty((b,), dtype=torch.float32, device=bm.device)
    prog = np.asarray(codes, np.int16)
    lib = _build.load("fused_query")
    stream = torch.cuda.current_stream(bm.device).cuda_stream
    err = lib.leafsum_launch(bm.data_ptr(), leaves.data_ptr(), b, w, trees,
                             depth, leaves.shape[1], prog.size,
                             prog.ctypes.data, out.data_ptr(), stream)
    _build.check(lib, err, "fused_query.leafsum_kernel")
    gbdt_leafbits_sum.launches += 1
    return out


fused_predicate_banked.launches = 0
fused_compound_banked.launches = 0
fused_range_count.launches = 0
gbdt_leafbits_banked.launches = 0
gbdt_leafbits_sum.launches = 0
