"""LUT construction, Algorithm 1 index resolution and the kernel
front-ends.

Mirrors the layout plumbing of the reference package's ``kernels/ops.py``
so LUTs and row offsets agree byte for byte: W padded to a multiple of
128 words, rows padded to a multiple of 8, each chunk's planes followed
by a constant-zero and a constant-one row, and the one-row masked to the
valid elements.  Index resolution is host-side NumPy, memoized per
``(plan, scalar)`` like the reference.

The front-ends (:func:`compare_gt_scalar`, :func:`clutch_compare`,
:func:`clutch_compare_banked`, :func:`range_count`,
:func:`encode_bitplanes`, :func:`bitserial_compare`,
:func:`gbdt_leaf_sum`, :func:`sample_threshold_mask`) take the
reference's logical inputs and return int32 bit patterns where it returns
``uint32`` words.  A tensor input keeps its device; a NumPy input goes to
``device``, which defaults to the card (and raises without CUDA unless
``device="cpu"`` is given).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core.encoding import ChunkPlan

from .bitserial_cmp import bitserial_cmp
from .clutch_merge import clutch_merge, clutch_merge_banked
from .common import (
    LANES,
    MASK32,
    SUBLANES,
    WORD_BITS,
    pack_bits_torch,
    resolve_device,
    round_up,
    unpack_bits_torch,
)
from .fused_query import fused_range_count
from .leaf_gather import leaf_gather
from .minp_mask import minp_mask
from .temporal_encode import temporal_encode


def _tensor(x, device) -> torch.Tensor:
    """A tensor as it is, on its own device; a NumPy array (or list) as
    a tensor on ``resolve_device(device)``.  ``uint32`` words cross as
    int32 bit patterns, ``uint64`` values as int64."""
    if isinstance(x, torch.Tensor):
        return x
    arr = np.asarray(x)
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    elif arr.dtype == np.uint64:
        arr = arr.astype(np.int64)
    return torch.from_numpy(np.require(arr, requirements=["C", "W"])).to(
        resolve_device(device))


def encode_lut(values: torch.Tensor, plan: ChunkPlan,
               complement: bool = False) -> torch.Tensor:
    """values: [N] integer tensor holding uint32 values (int32 bit
    patterns or int64) -> stacked LUT [R_pad, W_pad] int32: the chunk
    tables (row offsets ``lut_offsets(plan)``), a constant-zero and a
    constant-one row, zero rows up to a multiple of 8.
    ``complement=True`` encodes ``MAX - values`` (uint32 arithmetic).
    Chunks are cut in int64, so values up to 2^32 - 1 survive."""
    n = values.shape[0]
    dev = values.device
    v = values.to(torch.int64) & MASK32
    if complement:
        v = (((1 << plan.n_bits) - 1) - v) & MASK32
    w = round_up((n + WORD_BITS - 1) // WORD_BITS, LANES)
    vals = torch.zeros(w * WORD_BITS, dtype=torch.int64, device=dev)
    vals[:n] = v
    vals2d = vals.view(w, WORD_BITS)
    pieces = []
    for k, shift in zip(plan.widths, plan.shifts):
        chunk = ((vals2d >> shift) & ((1 << k) - 1)).to(torch.int32)
        pieces.append(temporal_encode(chunk, k))
    # valid-element mask keeps padding columns all-zero in the one-row
    ones_row = torch.zeros((1, w), dtype=torch.int32, device=dev)
    full, rem = divmod(n, WORD_BITS)
    ones_row[0, :full] = -1
    if rem:
        ones_row[0, full] = (1 << rem) - 1
    zero_row = torch.zeros((1, w), dtype=torch.int32, device=dev)
    lut = torch.cat(pieces + [zero_row, ones_row], dim=0)
    r_pad = round_up(lut.shape[0], SUBLANES)
    return torch.nn.functional.pad(lut, (0, 0, 0, r_pad - lut.shape[0]))


def lut_rows(plan: ChunkPlan) -> int:
    """Rows of one :func:`encode_lut` output."""
    return round_up(plan.rows_required + 2, SUBLANES)


def lut_offsets(plan: ChunkPlan) -> tuple[tuple[int, ...], int, int]:
    """Returns (cp, zero_row, one_row) row indices inside an
    :func:`encode_lut` output."""
    cp, off = [], 0
    for k in plan.widths:
        cp.append(off)
        off += (1 << k) - 1
    return tuple(cp), off, off + 1


@functools.lru_cache(maxsize=65536)
def _resolve_scalar_cached(plan: ChunkPlan, a: int
                           ) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """Memoized core of :func:`resolve_indices`, keyed on ``(plan,
    scalar)``; tuples keep the cache entries immutable."""
    cp, zero_row, one_row = lut_offsets(plan)
    chunks = plan.split_scalar(a)
    lt, le = [], []
    for j, (c, k) in enumerate(zip(chunks, plan.widths)):
        lt.append(zero_row if c == (1 << k) - 1 else cp[j] + c)
        le.append(one_row if c == 0 else cp[j] + c - 1)
    return tuple(lt), tuple(le)


def resolve_indices(plan: ChunkPlan, a: int) -> tuple[np.ndarray, np.ndarray]:
    """Host-side Algorithm 1 index resolution: per-chunk ``lt``/``le``
    row indices with the boundary substitutions (const-0 / const-1
    rows).  Memoized per ``(plan, scalar)``."""
    lt, le = _resolve_scalar_cached(plan, int(a))
    return (np.asarray(lt, np.int32), np.asarray(le, np.int32))


def resolve_indices_banked(plan: ChunkPlan, a: np.ndarray
                           ) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized per-instance resolution: ``a`` is [B] int64, ``-1``
    meaning the always-true comparison (both lookups on the constant-one
    row).  Returns ([B, C], [B, C]) int32 lt/le row indices."""
    a = np.asarray(a, np.int64)
    if (a >= (1 << plan.n_bits)).any():
        raise ValueError(
            f"scalar out of range for {plan.n_bits} bits: {a.max()}")
    cp, zero_row, one_row = lut_offsets(plan)
    lt = np.empty((a.shape[0], plan.num_chunks), np.int32)
    le = np.empty_like(lt)
    for j, (s, k) in enumerate(zip(plan.shifts, plan.widths)):
        c = (a >> np.int64(s)) & np.int64((1 << k) - 1)
        lt[:, j] = np.where(c == (1 << k) - 1, zero_row, cp[j] + c)
        le[:, j] = np.where(c == 0, one_row, cp[j] + c - 1)
    always = a < 0
    lt[always] = one_row
    le[always] = one_row
    return lt, le


# --------------------------------------------------------------------- #
# Comparison front-ends
# --------------------------------------------------------------------- #

def compare_gt_scalar(lut, lt_idx, le_idx, device=None) -> torch.Tensor:
    """[W] int32 words of ``a < B`` (== ``B > a``) from a prebuilt
    :func:`encode_lut` LUT and the scalar's :func:`resolve_indices`."""
    return clutch_merge(_tensor(lut, device), lt_idx, le_idx)


def clutch_compare(values, a: int, plan: ChunkPlan,
                   device=None) -> torch.Tensor:
    """End to end: encode, resolve, merge, unpack -> bool [N] of
    ``a < B``.  ``a`` outside ``[0, 2^n_bits)`` raises."""
    values = _tensor(values, device)
    lut = encode_lut(values, plan)
    lt_idx, le_idx = resolve_indices(plan, a)
    words = compare_gt_scalar(lut, lt_idx, le_idx)
    return unpack_bits_torch(words, values.shape[0]).bool()


def clutch_compare_banked(values, a, plan: ChunkPlan,
                          device=None) -> torch.Tensor:
    """Bank-batched compare: ``values`` [B, N], one vector shard per
    bank; ``a`` [B] per-bank scalars, ``-1`` meaning always true.
    Returns bool [B, N] of ``a_b < B_b``; a scalar at or above
    ``2^n_bits`` raises."""
    values = _tensor(values, device)
    lt_idx, le_idx = resolve_indices_banked(plan, a)
    lut = torch.stack([encode_lut(v, plan) for v in values])
    words = clutch_merge_banked(lut, lt_idx, le_idx)
    return unpack_bits_torch(words, values.shape[1]).bool()


def range_count(lut, lut_c, idx, num_chunks: int, device=None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused ``x0 < B < x1`` bitmap and COUNT: ``lut`` / ``lut_c`` the
    normal and complement LUTs of one column, ``idx`` [4C] the gt-side
    indices of ``x0`` then the lt-side indices of ``MAX - x1``.  Returns
    (words [W] int32, count: 0-d int64)."""
    return fused_range_count(_tensor(lut, device), _tensor(lut_c, device),
                             idx, num_chunks)


def encode_bitplanes(values, n_bits: int, device=None) -> torch.Tensor:
    """Binary (bit-sliced) layout for the bit-serial baseline:
    [round_up(n_bits, 8), W_pad] int32 planes, LSB plane first, padding
    planes and columns zero -- byte-equal to the reference's."""
    values = _tensor(values, device)
    n = values.shape[0]
    w = round_up((n + WORD_BITS - 1) // WORD_BITS, LANES)
    v = torch.zeros(w * WORD_BITS, dtype=torch.int64, device=values.device)
    v[:n] = values.to(torch.int64) & MASK32
    planes = torch.zeros((round_up(n_bits, SUBLANES), w), dtype=torch.int32,
                         device=values.device)
    for i in range(n_bits):
        planes[i] = pack_bits_torch((v >> i) & 1)
    return planes


def bitserial_compare(planes, a: int, n_bits: int,
                      device=None) -> torch.Tensor:
    """[W] int32 words of ``a < B`` over :func:`encode_bitplanes` planes;
    only the low ``n_bits`` bits of the uint32 ``a`` are read."""
    return bitserial_cmp(_tensor(planes, device), a, n_bits)


# --------------------------------------------------------------------- #
# GBDT
# --------------------------------------------------------------------- #

def gbdt_leaf_sum(addrs, leaves, device=None) -> torch.Tensor:
    """addrs [B, T] int32, leaves [T, L] float32 -> [B] float32
    predictions; an address outside ``[0, L)`` (such as ``-1``) adds 0."""
    return leaf_gather(_tensor(addrs, device), _tensor(leaves, device))


# --------------------------------------------------------------------- #
# Serving sampler
# --------------------------------------------------------------------- #

def sample_threshold_mask(logits, tau, chunks: tuple[int, ...] = (8, 8, 8, 8),
                          device=None) -> torch.Tensor:
    """Serving sampler hot path: mask logits below a per-row threshold via
    the chunked Clutch comparator.  logits [B, V] float32, tau [B]
    float32; returns [B, V] float32 with -1e30 where a logit's monotonic
    image is below its threshold's.  Any B and V: the kernel masks its
    own ragged edge, so nothing is padded."""
    return minp_mask(_tensor(logits, device), _tensor(tau, device), chunks)
