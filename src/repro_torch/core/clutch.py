"""Clutch's Algorithm 1 on the probe subarray: the command stream that
the representation planner prices.

The host holds the scalar ``a`` and, from its per-chunk values, issues
a data-dependent sequence of row lookups and MAJ3 merges:

    L <- row[a_0 + cp[0]]                       # LSB chunk:  a_0 < b_0
    for j = 1 .. C-1:
        L <- MAJ3(L, row[a_j + cp[j]], row[a_j - 1 + cp[j]])

with ``a_j == 2^k - 1`` reading the constant-zero row and ``a_j == 0``
the constant-one row.  PuD ops per comparison: ``4C - 3`` on Unmodified,
``3C - 2`` on Modified, one RowCopy when ``C == 1``.

The reference package's ``core/clutch.py`` under the same names, for
one broadcast scalar (the planner's probes issue no other); left out
are per-bank scalar vectors, LUT replication by in-DRAM clone, and
``TypedClutchEngine`` (signed and float operands).  The card's kernels
evaluate the same algorithm (:mod:`repro_torch.kernels.fused_query`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .encoding import ChunkPlan, ColumnPlan, LutLayout, load_vector, \
    make_plan
from .machine import BankedSubarray, PuDArch, unpack_bits


def _acc_home(sub: BankedSubarray) -> int:
    return sub.T0 if sub.arch is PuDArch.MODIFIED else sub.G[0]


def compare_lt(sub: BankedSubarray, layout: LutLayout, a: int) -> int:
    """Run Algorithm 1: returns the row index holding the bitmap of
    ``a < B_i`` over the vector encoded in ``layout``."""
    plan = layout.plan
    chunks = plan.split_scalar(a)
    maxval = [(1 << k) - 1 for k in plan.widths]

    def lt_row(j: int) -> int:
        return sub.ROW_ZERO if chunks[j] == maxval[j] \
            else layout.cp[j] + chunks[j]

    def le_row(j: int) -> int:
        return sub.ROW_ONE if chunks[j] == 0 \
            else layout.cp[j] + chunks[j] - 1

    acc = lt_row(0)
    if plan.num_chunks == 1:
        dst = _acc_home(sub)
        sub.rowcopy(acc, dst)
        return dst
    for j in range(1, plan.num_chunks):
        acc = sub.maj3_into_acc(acc, lt_row(j), le_row(j))
    return acc


@dataclass
class PredicateResult:
    row: int            # subarray row holding the bitmap
    pud_ops: int        # PuD ops issued for this predicate


class ClutchEngine:
    """A vector resident in one bank group, ready for predicates.

    ``values`` is [n] (the same vector in every bank) or [banks, n].
    Modified PuD derives ``<`` and ``<=`` with the native NOT; Unmodified
    PuD stores the complement encoding ``MAX - B`` as well (unless
    ``support_negated=False``) and rewrites ``B < a <=> MAX-a < MAX-B``.

    ``plan`` may be a :class:`ColumnPlan`, whose width then overrides
    ``n_bits``.  ``clamp=True`` saturates scalars above the column's
    ``MAX`` instead of raising, as narrow per-column plans need."""

    def __init__(
        self,
        sub: BankedSubarray,
        values: np.ndarray,
        n_bits: int,
        num_chunks: int | None = None,
        plan: ChunkPlan | ColumnPlan | None = None,
        support_negated: bool = True,
        scratch: tuple[int, int] | None = None,
        clamp: bool = False,
    ) -> None:
        if isinstance(plan, ColumnPlan):
            n_bits = plan.n_bits
            plan = plan.chunk_plan
        self.sub = sub
        self.n_bits = n_bits
        self.n = int(np.asarray(values).shape[-1])
        self.clamp = clamp
        if plan is None:
            plan = make_plan(n_bits, num_chunks or 1)
        self.plan = plan
        self.layout = load_vector(sub, values, plan)
        self.layout_c = (
            load_vector(sub, values, plan, complement=True)
            if sub.arch is PuDArch.UNMODIFIED and support_negated
            else None
        )
        # rows for intermediate bitmaps (``==``); engines sharing a
        # subarray may share them, predicates being sequential
        self._scratch = list(scratch) if scratch is not None \
            else [sub.alloc(1), sub.alloc(1)]
        self.max = (1 << n_bits) - 1

    def _run_lt(self, a: int, complement: bool) -> int:
        layout = self.layout_c if complement else self.layout
        if layout is None:
            raise RuntimeError(
                "negated predicate needs the complement layout: construct "
                "the engine with support_negated=True (Unmodified PuD)")
        return compare_lt(self.sub, layout, a)

    def predicate(self, op: str, x: int, save_to: int | None = None,
                  segment: str | None = None,
                  after: tuple[int, ...] | None = None) -> PredicateResult:
        """Evaluate ``B_i <op> x`` for every element (``op`` one of
        ``<``, ``<=``, ``>``, ``>=``, ``==``); returns the bitmap row.
        ``save_to`` RowCopies the result to a stable row; ``segment``
        opens a labeled trace segment (depending on ``after``) first."""
        if segment is not None:
            self.sub.trace.begin_segment(segment, after=after)
        elif after is not None:
            raise ValueError("`after` requires a `segment` label: without "
                             "a new segment the dependency would be "
                             "silently dropped")
        if x < 0 or (not self.clamp and x > self.max):
            raise ValueError(f"scalar {x} out of range")
        if self.clamp and op != "==":
            # MAX+1 keeps the exclusive bounds exact; ``==`` clamps in
            # its recursive ``<=`` / ``>=`` calls
            x = min(int(x), self.max + (1 if op in ("<", ">=") else 0))
        before = self.sub.trace.pud_ops
        sub = self.sub
        if op == ">":        # B > x  <=>  x < B
            row = self._run_lt(x, complement=False)
        elif op == ">=":     # B >= x <=>  (x-1) < B
            row = sub.ROW_ONE if x == 0 \
                else self._run_lt(x - 1, complement=False)
        elif op == "<":      # B < x  <=>  NOT(B >= x)
            if x == 0:
                row = sub.ROW_ZERO
            elif x > self.max:
                row = sub.ROW_ONE
            elif sub.arch is PuDArch.MODIFIED:
                row = self._run_lt(x - 1, complement=False)
                sub.bulk_not(row, sub.DCC0)
                row = sub.DCC0
            else:            # MAX-x < MAX-B  <=>  B < x
                row = self._run_lt(self.max - x, complement=True)
        elif op == "<=":     # B <= x <=>  NOT(B > x)
            if x == self.max:
                row = sub.ROW_ONE
            elif sub.arch is PuDArch.MODIFIED:
                row = self._run_lt(x, complement=False)
                sub.bulk_not(row, sub.DCC0)
                row = sub.DCC0
            else:            # (MAX-x-1) < MAX-B  <=>  B <= x
                row = self._run_lt(self.max - x - 1, complement=True)
        elif op == "==":     # (B <= x) AND (B >= x)
            le = self.predicate("<=", x, save_to=self._scratch[0]).row
            ge = self.predicate(">=", x, save_to=self._scratch[1]).row
            row = self.bitmap_and(le, ge)
        else:
            raise ValueError(f"unknown operator {op!r}")
        if save_to is not None and row != save_to:
            sub.rowcopy(row, save_to)
            row = save_to
        return PredicateResult(row, self.sub.trace.pud_ops - before)

    def bitmap_and(self, r1: int, r2: int) -> int:
        return self.sub.maj3_into_acc(r1, r2, self.sub.ROW_ZERO)

    def read_bitmap(self, row: int) -> np.ndarray:
        """Host readout of one row -> bool bitmap [banks, n]."""
        words = self.sub.host_read_row(row)
        return unpack_bits(words, self.n).astype(bool)
