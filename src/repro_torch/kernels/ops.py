"""LUT construction and Algorithm 1 index resolution.

Mirrors the layout plumbing of the reference package's ``kernels/ops.py``
so LUTs and row offsets agree byte for byte: W padded to a multiple of
128 words, rows padded to a multiple of 8, each chunk's planes followed
by a constant-zero and a constant-one row, and the one-row masked to the
valid elements.  Index resolution is host-side NumPy, memoized per
``(plan, scalar)`` like the reference.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core.encoding import ChunkPlan

from .common import LANES, MASK32, SUBLANES, WORD_BITS, round_up
from .temporal_encode import temporal_encode


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
