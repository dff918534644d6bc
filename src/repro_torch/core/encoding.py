"""Chunked temporal coding: chunk plans and per-column representations.

A value ``v`` (0 <= v < 2^k) is stored as ``v`` leading ones down a
column: bit ``r`` equals ``r < v``, so ``2^k - 1`` rows form a lookup
table whose row ``a`` is the bitmap of ``a < B_i``.  n-bit operands are
split into ``C`` chunks (LSB first), each with its own table of
``2^k_j - 1`` rows, merged with one MAJ3 per chunk.

The same vocabulary as the reference package's encoding module:
:class:`ChunkPlan`, :func:`make_plan` and :class:`ColumnPlan` lay the
card's LUTs out; :func:`column_footprint_rows` and :func:`infer_n_bits`
are what the representation planner searches with, beside
:func:`min_chunks_for_budget` (the fewest chunks that fit a row
budget); :class:`LutLayout` and :func:`load_vector` store a LUT in the
planner's probe subarray (:mod:`repro_torch.core.machine`).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

from .machine import BankedSubarray, pack_bits


@dataclass(frozen=True)
class ChunkPlan:
    """Chunk widths in bits, LSB chunk first."""

    widths: tuple[int, ...]

    @property
    def n_bits(self) -> int:
        return sum(self.widths)

    @property
    def num_chunks(self) -> int:
        return len(self.widths)

    @property
    def rows_required(self) -> int:
        return sum((1 << k) - 1 for k in self.widths)

    @property
    def shifts(self) -> tuple[int, ...]:
        """Bit offset of each chunk within the operand (LSB chunk first)."""
        out, s = [], 0
        for k in self.widths:
            out.append(s)
            s += k
        return tuple(out)

    def split_scalar(self, a: int) -> list[int]:
        """Split a scalar into per-chunk values (LSB chunk first)."""
        if not 0 <= a < (1 << self.n_bits):
            raise ValueError(f"scalar {a} out of range for {self.n_bits} bits")
        return [(a >> s) & ((1 << k) - 1)
                for s, k in zip(self.shifts, self.widths)]

    def split_vector(self, values: np.ndarray) -> list[np.ndarray]:
        values = np.asarray(values, dtype=np.uint64)
        return [((values >> np.uint64(s)) & np.uint64((1 << k) - 1))
                for s, k in zip(self.shifts, self.widths)]


def make_plan(n_bits: int, num_chunks: int) -> ChunkPlan:
    """Split ``n_bits`` into ``num_chunks`` as evenly as possible; the
    remainder bits go to the MSB-side chunks (32/5 -> (6,6,6,7,7))."""
    if not 1 <= num_chunks <= n_bits:
        raise ValueError("need 1 <= num_chunks <= n_bits")
    base, rem = divmod(n_bits, num_chunks)
    widths = [base] * (num_chunks - rem) + [base + 1] * rem
    return ChunkPlan(tuple(widths))


@functools.lru_cache(maxsize=4096)
def min_chunks_for_budget(n_bits: int, row_budget: int) -> ChunkPlan:
    """Smallest chunk count whose LUTs fit within ``row_budget`` rows
    (memoized: plans are immutable)."""
    for c in range(1, n_bits + 1):
        plan = make_plan(n_bits, c)
        if plan.rows_required <= row_budget:
            return plan
    raise ValueError(f"no plan for {n_bits} bits fits {row_budget} rows")


def column_footprint_rows(n_bits: int, num_chunks: int) -> int:
    """``(C - r)(2^b - 1) + r(2^(b+1) - 1)`` with ``b, r = divmod(n_bits,
    C)``: ``make_plan(n_bits, num_chunks).rows_required`` without
    building the plan."""
    if not 1 <= num_chunks <= n_bits:
        raise ValueError("need 1 <= num_chunks <= n_bits")
    base, rem = divmod(n_bits, num_chunks)
    return ((num_chunks - rem) * ((1 << base) - 1)
            + rem * ((1 << (base + 1)) - 1))


def infer_n_bits(values: np.ndarray, *, headroom: int = 0,
                 min_bits: int = 1) -> int:
    """Minimal storage width covering a column's observed values, plus
    ``headroom`` guard bits above the maximum's bit length (0: an exact
    fit; a later value that overflows needs a recode)."""
    if headroom < 0:
        raise ValueError("headroom must be >= 0")
    v = np.asarray(values, dtype=np.uint64)
    mx = int(v.max()) if v.size else 0
    return max(mx.bit_length() + headroom, min_bits)


@dataclass(frozen=True)
class ColumnPlan:
    """One column's representation choice: storage width + chunk count.
    Hashable on purpose: the tuple of per-column plans keys caches."""

    n_bits: int
    num_chunks: int

    def __post_init__(self) -> None:
        if not 1 <= self.num_chunks <= self.n_bits:
            raise ValueError(
                f"need 1 <= num_chunks <= n_bits, got "
                f"({self.n_bits}, {self.num_chunks})")

    @property
    def max_value(self) -> int:
        return (1 << self.n_bits) - 1

    @property
    def chunk_plan(self) -> ChunkPlan:
        return make_plan(self.n_bits, self.num_chunks)

    @property
    def rows_required(self) -> int:
        return column_footprint_rows(self.n_bits, self.num_chunks)

    def lut_rows(self, *, negated: bool = False) -> int:
        """Rows the column occupies; ``negated=True`` doubles it for the
        complement planes (MAX - B)."""
        return self.rows_required * (2 if negated else 1)


@dataclass
class LutLayout:
    """Where each chunk's LUT lives inside a subarray (``cp`` in Alg. 1)."""

    plan: ChunkPlan
    cp: tuple[int, ...]          # starting row index per chunk
    complement: bool = False     # planes encode (MAX - B) instead of B


def _conform_values(sub: BankedSubarray, values: np.ndarray) -> np.ndarray:
    """``values`` as [1, num_cols] or [banks, num_cols] uint64, unused
    columns zero."""
    values = np.asarray(values, dtype=np.uint64)
    if values.ndim == 1:
        values = values[None, :]
    if values.ndim != 2 or values.shape[0] not in (1, sub.num_banks):
        raise ValueError(
            f"values must be [n] or [{sub.num_banks}, n], got {values.shape}")
    if values.shape[1] > sub.num_cols:
        raise ValueError("values must fit the subarray columns")
    n = values.shape[1]
    if n < sub.num_cols:
        values = np.concatenate(
            [values,
             np.zeros((values.shape[0], sub.num_cols - n), np.uint64)],
            axis=1,
        )
    return values


def load_vector(
    sub: BankedSubarray,
    values: np.ndarray,
    plan: ChunkPlan,
    *,
    complement: bool = False,
) -> LutLayout:
    """Encode ``values`` ([n], broadcast to every bank, or [banks, n])
    with chunked temporal coding into freshly allocated rows of ``sub``,
    one WRITE trace entry per row.  ``complement=True`` encodes ``MAX -
    B``, from which Unmodified PuD derives the negated operators."""
    values = _conform_values(sub, values)
    if complement:
        values = np.uint64((1 << plan.n_bits) - 1) - values
    cp = []
    max_rows = max((1 << k) - 1 for k in plan.widths)
    buf = np.empty((values.shape[0], max_rows, sub.num_cols), np.bool_)
    wdt = np.uint32 if plan.n_bits <= 32 else np.uint64
    vals_w = values.astype(wdt, copy=False)
    for k, shift in zip(plan.widths, plan.shifts):
        n_planes = (1 << k) - 1
        start = sub.alloc(n_planes)
        cp.append(start)
        dt = np.uint8 if k <= 8 else (np.uint16 if k <= 16 else np.uint32)
        chunk_vals = ((vals_w >> wdt(shift)) & wdt(n_planes)).astype(dt)
        planes = buf[:, :n_planes]
        np.less(np.arange(n_planes, dtype=dt)[None, :, None],
                chunk_vals[:, None, :], out=planes)
        sub.host_write_rows(start, pack_bits(planes))
    return LutLayout(plan=plan, cp=tuple(cp), complement=complement)
