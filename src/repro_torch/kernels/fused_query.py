"""Fused Clutch predicates and GBDT leaf bits: wrappers of the CUDA kernels.

Replaces three TPU kernels of ``src/repro/kernels/fused_query.py``:

* ``fused_predicate_banked`` -- 1-2 range predicates (AND/OR) over a
  whole sharded LUT plus a per-shard popcount, in one launch;
* ``fused_compound_banked`` -- compound predicates: each term's ranges
  with the term's own AND/OR, folded left to right through the
  connectives, plus the popcount;
* ``gbdt_leafbits_banked`` -- per instance, per feature, the Algorithm 1
  merge on the shared threshold LUT OR-ed into the leaf-address bitmap
  through the feature's one-hot mask.

The first two share one CUDA function (``csrc/fused_query.cu ::
compound_kernel``), the predicate being the one-term compound; each
wrapper keeps its own launch count.  All three are bound by memory
traffic (see the notes in the CUDA source).  A CPU tensor takes the
plain version from :mod:`repro_torch.kernels.ref`.

Row indices may be given on the host (NumPy or a CPU tensor): they are
checked against the LUT's row count and copied to the card.  Indices
already on the card are clamped into range by the kernel while staged.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .common import on_card
from .ref import fused_compound_banked_ref, gbdt_leafbits_banked_ref

MAX_TERMS = 32          # csrc/fused_query.cu :: MAX_TERMS
MAX_SMEM_IDX = 12288    # 48 KB of int32 indices staged per block


def _index_tensor(idx, n_rows: int, device: torch.device) -> torch.Tensor:
    """``idx`` as a contiguous int32 tensor on ``device``; host indices
    outside ``[0, n_rows)`` raise (a negative one would otherwise wrap
    in the plain version's indexing)."""
    t = torch.as_tensor(idx)
    if t.device.type == "cpu" and t.numel():
        lo, hi = int(t.min()), int(t.max())
        if lo < 0 or hi >= n_rows:
            raise ValueError(
                f"row indices span [{lo}, {hi}], outside the LUT's "
                f"{n_rows} rows")
    return t.to(device=device, dtype=torch.int32).contiguous()


def _check_lut(lut: torch.Tensor, ndim: int) -> None:
    if lut.dim() != ndim or lut.dtype != torch.int32:
        raise ValueError(f"LUT must be a {ndim}-D int32 tensor, got "
                         f"{lut.dim()}-D {lut.dtype}")


def _compound(lut, idx, num_chunks, term_ranges, term_disj, conn_disj):
    """Shared body of the two predicate wrappers; returns the outputs
    and whether the kernel was launched."""
    _check_lut(lut, 3)
    term_ranges = tuple(int(n) for n in term_ranges)
    if not 1 <= len(term_ranges) <= MAX_TERMS:
        raise ValueError(f"need 1..{MAX_TERMS} terms, got {len(term_ranges)}")
    if len(term_disj) != len(term_ranges) or \
            len(conn_disj) != len(term_ranges) - 1:
        raise ValueError("need one term_disj per term and one "
                         "conn_disj per connective")
    if min(term_ranges) < 1:
        raise ValueError(f"every term needs a range: {term_ranges}")
    n_idx = sum(term_ranges) * 4 * num_chunks
    s, r, w = lut.shape
    idx = _index_tensor(idx, r, lut.device)
    if tuple(idx.shape) != (n_idx,):
        raise ValueError(f"idx must be [{n_idx}], got {tuple(idx.shape)}")
    if not on_card(lut, idx):
        return fused_compound_banked_ref(lut, idx, num_chunks, term_ranges,
                                         term_disj, conn_disj), False
    if n_idx > MAX_SMEM_IDX:
        raise ValueError(f"{n_idx} row indices exceed the kernel's "
                         f"{MAX_SMEM_IDX}")
    lut = lut.contiguous()
    bm = torch.empty((s, w), dtype=torch.int32, device=lut.device)
    cnt = torch.zeros((s,), dtype=torch.int64, device=lut.device)
    ranges = (ctypes.c_int * len(term_ranges))(*term_ranges)
    tdisj = sum(1 << t for t, d in enumerate(term_disj) if d)
    cdisj = sum(1 << t for t, d in enumerate(conn_disj) if d)
    lib = _build.load("fused_query")
    stream = torch.cuda.current_stream(lut.device).cuda_stream
    err = lib.compound_launch(
        lut.data_ptr(), idx.data_ptr(), n_idx, num_chunks, s, r, w,
        len(term_ranges), ctypes.addressof(ranges), tdisj, cdisj,
        bm.data_ptr(), cnt.data_ptr(), stream)
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


def gbdt_leafbits_banked(lut: torch.Tensor, masks: torch.Tensor, idx,
                         num_chunks: int, num_features: int
                         ) -> torch.Tensor:
    """One-launch GBDT leaf-address bitmap for a whole instance batch.

    lut: [R, W] int32 threshold planes, shared by every instance.
    masks: [F_pad, W] int32 one-hot feature masks (rows past
    ``num_features`` are padding).  idx: [B, F * 2C] -- per instance,
    per feature, the (lt, le) row indices of its value.  Returns the
    leaf-address bitmap [B, W] int32."""
    _check_lut(lut, 2)
    _check_lut(masks, 2)
    r, w = lut.shape
    if masks.shape[1] != w or masks.shape[0] < num_features:
        raise ValueError(f"masks {tuple(masks.shape)} do not fit "
                         f"{num_features} features x {w} words")
    idx = _index_tensor(idx, r, lut.device)
    n = num_features * 2 * num_chunks
    if idx.dim() != 2 or idx.shape[1] != n:
        raise ValueError(f"idx must be [B, {n}], got {tuple(idx.shape)}")
    if not on_card(lut, masks, idx):
        return gbdt_leafbits_banked_ref(lut, masks, idx, num_chunks,
                                        num_features)
    if n > MAX_SMEM_IDX:
        raise ValueError(f"{n} row indices exceed the kernel's "
                         f"{MAX_SMEM_IDX}")
    lut, masks = lut.contiguous(), masks.contiguous()
    b = idx.shape[0]
    out = torch.empty((b, w), dtype=torch.int32, device=lut.device)
    lib = _build.load("fused_query")
    stream = torch.cuda.current_stream(lut.device).cuda_stream
    err = lib.leafbits_launch(
        lut.data_ptr(), masks.data_ptr(), idx.data_ptr(), num_chunks,
        num_features, b, r, w, out.data_ptr(), stream)
    _build.check(lib, err, "fused_query.leafbits_kernel")
    gbdt_leafbits_banked.launches += 1
    return out


fused_predicate_banked.launches = 0
fused_compound_banked.launches = 0
gbdt_leafbits_banked.launches = 0
