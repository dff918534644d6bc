"""Chunked temporal coding: chunk plans and per-column representations.

A value ``v`` (0 <= v < 2^k) is stored as ``v`` leading ones down a
column: bit ``r`` equals ``r < v``, so ``2^k - 1`` rows form a lookup
table whose row ``a`` is the bitmap of ``a < B_i``.  n-bit operands are
split into ``C`` chunks (LSB first), each with its own table of
``2^k_j - 1`` rows, merged with one MAJ3 per chunk.

:class:`ChunkPlan`, :func:`make_plan` and :class:`ColumnPlan` are the
same closed-form vocabulary as the reference package's encoding module;
the budget search and the simulator loaders are not needed here.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


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
        """``(C - r)(2^b - 1) + r(2^(b+1) - 1)`` with ``b, r =
        divmod(n_bits, C)``: the even split's LUT footprint."""
        base, rem = divmod(self.n_bits, self.num_chunks)
        return ((self.num_chunks - rem) * ((1 << base) - 1)
                + rem * ((1 << (base + 1)) - 1))

    def lut_rows(self, *, negated: bool = False) -> int:
        """Rows the column occupies; ``negated=True`` doubles it for the
        complement planes (MAX - B)."""
        return self.rows_required * (2 if negated else 1)
