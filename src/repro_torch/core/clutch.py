"""Clutch: LUT-based vector-scalar comparison with chunked temporal
coding (Algorithm 1 of the paper) on the PuD machine model.

The host holds the scalar ``a`` and, from its per-chunk values, issues
a data-dependent sequence of row lookups and MAJ3 merges:

    L <- row[a_0 + cp[0]]                       # LSB chunk:  a_0 < b_0
    for j = 1 .. C-1:
        L <- MAJ3(L, row[a_j + cp[j]], row[a_j - 1 + cp[j]])

with ``a_j == 2^k - 1`` reading the constant-zero row and ``a_j == 0``
the constant-one row (exact, since ``lt`` implies ``le``).

``a`` may be a vector of scalars, one per bank: the lookups become
per-bank gather rows inside one broadcast stream, so the per-bank op
count equals the scalar case; a per-bank ``-1`` is the always-true
compare.  PuD ops per comparison (:func:`clutch_op_count`): ``4C - 3``
on Unmodified, ``3C - 2`` on Modified, one RowCopy when ``C == 1``.

The reference package's ``core/clutch.py`` under the same names, with
:class:`ClutchEngine` (clone replication included) and
:class:`TypedClutchEngine` (signed and float32 operands).  The card's
fused kernels evaluate the same algorithm
(:mod:`repro_torch.kernels.fused_query`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .encoding import ChunkPlan, ColumnPlan, LutLayout, clone_vector, \
    load_vector, make_plan
from .machine import BankedSubarray, PuDArch, RowIdx, unpack_bits

OPS = ("<", "<=", ">", ">=", "==")


def _acc_home(sub: BankedSubarray) -> int:
    return sub.T0 if sub.arch is PuDArch.MODIFIED else sub.G[0]


def compare_lt(sub: BankedSubarray, layout: LutLayout,
               a: int | np.ndarray) -> int:
    """Run Algorithm 1: returns the row index holding the bitmap of
    ``a < B_i`` (over the vector encoded in ``layout``).

    ``a`` is one scalar (broadcast to all banks) or an int array [banks]
    of per-bank scalars; entries may be ``-1`` for the always-true
    comparison (see module docstring)."""
    if isinstance(a, np.ndarray):
        return _compare_lt_vec(sub, layout, a)
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
        # Single-chunk Clutch: the comparison is one RowCopy (paper §4.1).
        dst = _acc_home(sub)
        sub.rowcopy(acc, dst)
        return dst
    for j in range(1, plan.num_chunks):
        acc = sub.maj3_into_acc(acc, lt_row(j), le_row(j))
    return acc


def _compare_lt_vec(sub: BankedSubarray, layout: LutLayout,
                    a: np.ndarray) -> int:
    """Vector-of-scalars Algorithm 1: per-bank gather lookups, one
    broadcast MAJ3 merge sequence."""
    plan = layout.plan
    a = np.asarray(a, np.int64)
    if a.shape != (sub.num_banks,):
        raise ValueError(
            f"need one scalar per bank: shape ({sub.num_banks},)")
    if (a >= (1 << plan.n_bits)).any() or (a < -1).any():
        raise ValueError("per-bank scalars out of range")
    always = a < 0
    chunks = plan.split_vector(np.where(always, 0, a).astype(np.uint64))
    maxval = [(1 << k) - 1 for k in plan.widths]

    def lt_row(j: int) -> np.ndarray:
        r = layout.cp[j] + chunks[j].astype(np.int64)
        r = np.where(chunks[j] == maxval[j], sub.ROW_ZERO, r)
        return np.where(always, sub.ROW_ONE, r)

    def le_row(j: int) -> np.ndarray:
        r = layout.cp[j] + chunks[j].astype(np.int64) - 1
        r = np.where(chunks[j] == 0, sub.ROW_ONE, r)
        return np.where(always, sub.ROW_ONE, r)

    acc: RowIdx = lt_row(0)
    if plan.num_chunks == 1:
        dst = _acc_home(sub)
        sub.rowcopy(acc, dst)
        return dst
    for j in range(1, plan.num_chunks):
        acc = sub.maj3_into_acc(acc, lt_row(j), le_row(j))
    return acc


def clutch_op_count(num_chunks: int, arch: PuDArch) -> int:
    """Closed-form PuD op count of one Clutch comparison (per bank;
    identical for scalar and vector-of-scalars execution)."""
    if num_chunks == 1:
        return 1
    if arch is PuDArch.MODIFIED:
        return 3 * num_chunks - 2
    return 4 * num_chunks - 3


@dataclass
class PredicateResult:
    row: int            # subarray row holding the bitmap
    pud_ops: int        # PuD ops issued for this predicate


class ClutchEngine:
    """A vector resident in one bank group, ready for arbitrary predicates.

    ``values`` is [n] (same vector in every bank) or [banks, n] (one shard
    per bank).  ``predicate`` accepts one scalar (broadcast) or a per-bank
    scalar vector; with per-bank scalars the boundary special cases are
    folded into the uniform broadcast command stream (see module
    docstring), so every bank executes the same op sequence.

    On Modified PuD, negated operators (``<``, ``<=``) use the native bulk
    NOT.  On Unmodified PuD there is no NOT, so the engine additionally
    stores the complement encoding ``MAX - B`` and rewrites
    ``B < a  <=>  MAX-a < MAX-B`` (paper §6.2).
    """

    def __init__(
        self,
        sub: BankedSubarray,
        values: np.ndarray,
        n_bits: int,
        num_chunks: int | None = None,
        plan: ChunkPlan | ColumnPlan | None = None,
        support_negated: bool = True,
        scratch: tuple[int, int] | None = None,
        clone_from: "ClutchEngine | None" = None,
        clamp: bool = False,
    ) -> None:
        """``support_negated=False`` skips the complement planes on
        Unmodified PuD (halving the row footprint) when only the native
        ``>`` / ``>=`` / ``==``-free operators are needed -- the kernel-level
        evaluation of paper §5.1 runs in this mode.

        ``clone_from`` replicates an already-loaded engine's LUT planes
        via in-DRAM RowClone waves instead of a fresh host load --
        ``values`` must be the same vector, and the source engine's
        group must span the same number of banks (the caller keeps both
        on one channel).  Zero host WRITE traffic after the first
        load.

        ``plan`` may be a :class:`~repro_torch.core.encoding.ColumnPlan`, in
        which case the column's storage width overrides ``n_bits`` -- a
        narrow column stores fewer LUT planes than the table's declared
        width.  ``clamp=True`` saturates out-of-range comparison scalars
        to the column's range instead of raising: ``B <op> x`` for
        ``x > MAX`` has a well-defined truth value (all-false for
        ``>``/``>=``/``==``, all-true for ``<``/``<=``) since every
        stored ``B <= MAX``, which is exactly what heterogeneous
        per-column plans need when queries quote full-width scalars."""
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
        if clone_from is not None:
            if clone_from.plan != plan:
                raise ValueError("clone source uses a different chunk plan")
            self.layout = clone_vector(sub, clone_from.sub,
                                       clone_from.layout)
            self.layout_c = (
                clone_vector(sub, clone_from.sub, clone_from.layout_c)
                if sub.arch is PuDArch.UNMODIFIED and support_negated
                and clone_from.layout_c is not None
                else None
            )
        else:
            self.layout = load_vector(sub, values, plan)
            self.layout_c = (
                load_vector(sub, values, plan, complement=True)
                if sub.arch is PuDArch.UNMODIFIED and support_negated
                else None
            )
        # Scratch rows for saving intermediate bitmaps (e.g. for ``==``);
        # engines sharing a subarray can share these (predicates are
        # sequential), which is what lets 8x 32-bit features + complements
        # fit the 1024-row budget (paper §6.2, footnote 4).
        self._scratch = list(scratch) if scratch is not None \
            else [sub.alloc(1), sub.alloc(1)]
        self.max = (1 << n_bits) - 1

    # -------------------------------------------------------------- #
    def _run_lt(self, a: int | np.ndarray, complement: bool) -> int:
        layout = self.layout_c if complement else self.layout
        if layout is None:
            raise RuntimeError(
                "negated predicate needs the complement layout: construct "
                "the engine with support_negated=True (Unmodified PuD)")
        return compare_lt(self.sub, layout, a)

    def predicate(self, op: str, x: int | np.ndarray,
                  save_to: int | None = None,
                  segment: str | None = None,
                  after: tuple[int, ...] | None = None) -> PredicateResult:
        """Evaluate ``B_i  <op>  x`` for every element; returns the bitmap
        row.  ``x``: one scalar for all banks, or an int array [banks] of
        per-bank scalars.  ``save_to`` optionally RowCopies the result to
        a stable row (the accumulator rows are clobbered by the next
        predicate).  ``segment`` opens a labeled trace segment (with
        dependency set ``after``; default chains to the current segment)
        before the first wave issues, so pipelined callers can tag this
        predicate's waves for the scheduler."""
        if segment is not None:
            self.sub.trace.begin_segment(segment, after=after)
        elif after is not None:
            raise ValueError("`after` requires a `segment` label: without "
                             "a new segment the dependency would be "
                             "silently dropped")
        vec = isinstance(x, np.ndarray)
        if vec:
            x = np.asarray(x, np.int64)
            if (x < 0).any() or (not self.clamp and (x > self.max).any()):
                raise ValueError("per-bank scalar out of range")
        elif x < 0 or (not self.clamp and x > self.max):
            raise ValueError(f"scalar {x} out of range")
        if self.clamp and op != "==":
            # Saturate to the column range: MAX+1 keeps the exclusive
            # bounds exact (B >= MAX+1 is all-false via run_lt(MAX);
            # B < MAX+1 is all-true).  ``==`` clamps inside its recursive
            # ``<=`` / ``>=`` calls.
            hi = self.max + (1 if op in ("<", ">=") else 0)
            x = np.minimum(x, hi) if vec else min(int(x), hi)
        before = self.sub.trace.pud_ops
        sub = self.sub
        if op == ">":        # B > x  <=>  x < B
            row = self._run_lt(x, complement=False)
        elif op == ">=":     # B >= x <=>  x <= B  <=> (x-1) < B
            if vec:          # x-1 == -1 encodes the always-true compare
                row = self._run_lt(x - 1, complement=False)
            elif x == 0:
                row = sub.ROW_ONE
            else:
                row = self._run_lt(x - 1, complement=False)
        elif op == "<":      # B < x  <=>  NOT(B >= x)
            if not vec and x == 0:
                row = sub.ROW_ZERO
            elif not vec and x > self.max:
                # clamped scalar saturated to MAX+1: every B <= MAX < x
                # (the Unmodified rewrite MAX-x would go negative here)
                row = sub.ROW_ONE
            elif sub.arch is PuDArch.MODIFIED:
                # per-bank x-1 == -1 encodes always-true; NOT gives zeros
                row = self._run_lt(x - 1, complement=False)
                sub.bulk_not(row, sub.DCC0)
                row = sub.DCC0
            else:            # MAX-x < MAX-B  <=>  B < x
                row = self._run_lt(self.max - x, complement=True)
        elif op == "<=":     # B <= x <=>  NOT(B > x)
            if not vec and x == self.max:
                row = sub.ROW_ONE
            elif sub.arch is PuDArch.MODIFIED:
                row = self._run_lt(x, complement=False)
                sub.bulk_not(row, sub.DCC0)
                row = sub.DCC0
            else:            # (MAX-x-1) < MAX-B  <=>  B <= x
                row = self._run_lt(self.max - x - 1, complement=True)
        elif op == "==":     # (B <= x) AND (B >= x)
            # call the base implementation explicitly: x is already in the
            # engine's internal (unsigned) encoding here, so subclass
            # re-encoding must not run again (TypedClutchEngine)
            le = ClutchEngine.predicate(self, "<=", x,
                                        save_to=self._scratch[0]).row
            ge = ClutchEngine.predicate(self, ">=", x,
                                        save_to=self._scratch[1]).row
            row = self.bitmap_and(le, ge)
        else:
            raise ValueError(f"unknown operator {op!r}")
        if save_to is not None and row != save_to:
            sub.rowcopy(row, save_to)
            row = save_to
        return PredicateResult(row, self.sub.trace.pud_ops - before)

    # ---------------- bitmap algebra (in-DRAM reductions) ----------- #
    def bitmap_and(self, r1: RowIdx, r2: RowIdx) -> int:
        return self.sub.maj3_into_acc(r1, r2, self.sub.ROW_ZERO)

    def bitmap_or(self, r1: RowIdx, r2: RowIdx) -> int:
        return self.sub.maj3_into_acc(r1, r2, self.sub.ROW_ONE)

    def read_bitmap(self, row: int) -> np.ndarray:
        """Host readout: one DRAM row -> bool bitmap (trace-counted).
        Shape [n] on a single-bank :class:`Subarray`, [banks, n] on a
        banked group."""
        words = self.sub.host_read_row(row)
        return unpack_bits(words, self.n).astype(bool)


class TypedClutchEngine(ClutchEngine):
    """ClutchEngine over signed ints or float32 via order-preserving
    re-encoding (beyond-paper extension; see encoding.py)."""

    def __init__(self, sub, values, n_bits: int, dtype: str = "unsigned",
                 **kw) -> None:
        from .encoding import encode_float32, encode_signed
        self.value_dtype = dtype
        if dtype == "signed":
            values = encode_signed(values, n_bits)
        elif dtype == "float32":
            if n_bits != 32:
                raise ValueError(
                    f"float32 encoding is 32-bit only, got n_bits={n_bits}")
            values = encode_float32(values)
        elif dtype != "unsigned":
            raise ValueError(dtype)
        super().__init__(sub, values, n_bits, **kw)

    def predicate(self, op: str, x, save_to=None) -> PredicateResult:
        from .encoding import encode_float32_scalar, encode_signed_scalar
        if self.value_dtype == "signed":
            x = encode_signed_scalar(int(x), self.n_bits)
        elif self.value_dtype == "float32":
            x = encode_float32_scalar(float(x))
        return super().predicate(op, x, save_to=save_to)
