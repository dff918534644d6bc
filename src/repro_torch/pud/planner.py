"""Representation planner: one ``(n_bits, num_chunks)`` per column.

The chunk count trades LUT rows against merge steps (paper section 4).
:func:`choose_representation` turns that knob per column: it infers each
column's storage width from its values (``infer_n_bits`` plus
``headroom``, capped at the declared width), prices every chunking of
it whose footprint is no larger than the fixed table-wide default's by
*running a probe*, and keeps the fastest.  The default is always a
candidate, so the choice is never slower and never larger than it; ties
go to the smaller footprint, then to more chunks.
:func:`choose_forest_plan` does the same for a GBDT threshold table.

A probe (:func:`_probe_makespan`) records one representative predicate
on a single-bank :class:`~repro_torch.core.machine.BankedSubarray` and
schedules its command stream with
:class:`~repro_torch.core.scheduler.ChannelScheduler`: the simulator is
the cost oracle, never a hand-derived formula that could drift from the
scheduler.  This is the reference package's ``pud/planner.py`` under
the same names; its placement half (``Planner``, bank admission and
eviction) is not ported, since the port's session keeps every resource
on one card.
"""

from __future__ import annotations

import functools

import numpy as np

from repro_torch.apps.gbdt import PAPER_GBDT_CHUNKS
from repro_torch.apps.predicate import PAPER_PREDICATE_CHUNKS, fit_chunks
from repro_torch.core import cost
from repro_torch.core.clutch import ClutchEngine
from repro_torch.core.encoding import (
    ColumnPlan,
    column_footprint_rows,
    infer_n_bits,
    make_plan,
)
from repro_torch.core.machine import BankedSubarray, PuDArch
from repro_torch.core.scheduler import ChannelScheduler, GroupStream

_PROBE_COLS = 64          # any multiple of 32; probes price commands,
                          # not data, so the narrowest group suffices


@functools.lru_cache(maxsize=4096)
def _probe_makespan(n_bits: int, num_chunks: int, arch, sys_cfg,
                    kind: str = "range") -> float:
    """Scheduled makespan (ns) of one representative predicate under the
    ``(n_bits, num_chunks)`` representation, LUT loading included.

    ``kind="range"`` prices the table query shape: ``x0 < f < x1`` as a
    native and a negated comparison (complement planes on Unmodified
    PuD), their AND, the park copy and the readout.  ``kind="gt"``
    prices the GBDT shape: one native ``>``, no complement planes.
    Memoized on all five arguments."""
    plan = make_plan(n_bits, num_chunks)
    negated = kind == "range" and arch is PuDArch.UNMODIFIED
    rows = (plan.rows_required * (2 if negated else 1)
            + BankedSubarray.NUM_RESERVED + 2 + 3 + 4)
    sub = BankedSubarray(num_banks=1, num_rows=rows, num_cols=_PROBE_COLS,
                         arch=arch)
    vals = np.arange(min(16, 1 << n_bits), dtype=np.uint64)
    eng = ClutchEngine(sub, vals, n_bits, plan=plan,
                       support_negated=kind == "range")
    save = sub.alloc(1)
    park = sub.alloc(1)
    mx = (1 << n_bits) - 1
    # mid-range scalars so no boundary shortcut skews the op count
    if kind == "range":
        lo = eng.predicate(">", mx // 3, save_to=save).row
        hi = eng.predicate("<", max(1, (2 * mx) // 3)).row
        row = sub.maj3_into_acc(lo, hi, sub.ROW_ZERO)
    else:
        row = eng.predicate(">", mx // 3).row
    sub.rowcopy(row, park)
    sub.host_read_row(park)
    stream = GroupStream.from_trace(
        f"probe:{n_bits}b/{num_chunks}c/{kind}", sub.trace, {0: {0: 1}},
        sub.num_cols)
    tl = ChannelScheduler(sys_cfg).schedule([stream])
    return float(tl.makespan_ns)


def _shrink_to_budget(plans: list, candidates: dict, overhead: int,
                      mult: int, budget: int) -> list:
    """Bump chunk counts (largest-footprint column first) until the plan
    set fits ``budget`` rows.  Only reachable when the caller's budget is
    tighter than the subarray that sized the defaults."""
    def total() -> int:
        return overhead + mult * sum(p.rows_required for p in plans)

    while total() > budget:
        order = sorted(range(len(plans)),
                       key=lambda i: -plans[i].rows_required)
        for i in order:
            cur = plans[i].rows_required
            smaller = [c for c in candidates[i]
                       if c[1] < cur]              # (makespan, rows, plan)
            if smaller:
                plans[i] = min(smaller)[2]
                break
        else:
            raise MemoryError(
                f"no per-column representation fits {budget} rows")
    return plans


def choose_representation(table, arch, *, num_rows: int = 1024,
                          sys_cfg=None, headroom: int = 0,
                          num_chunks: int | None = None,
                          row_budget: int | None = None) -> list:
    """One :class:`ColumnPlan` per column of ``table`` (``n_bits``,
    ``features``), minimizing the probed makespan within the row budget
    of a ``num_rows``-row subarray (tightened to ``row_budget`` when
    given).  ``num_chunks`` seeds the fixed default's chunk count."""
    sys_cfg = sys_cfg or cost.DESKTOP
    n_decl = table.n_bits
    n_feat = len(table.features)
    mult = 2 if arch is PuDArch.UNMODIFIED else 1
    overhead = 2 + 4 + 2                    # scratch + save + park rows
    budget = num_rows - BankedSubarray.NUM_RESERVED
    c_def = _default_uniform_chunks(n_decl, arch, n_feat, num_rows,
                                    start=num_chunks)
    def_rows = column_footprint_rows(n_decl, c_def)
    def_make = _probe_makespan(n_decl, c_def, arch, sys_cfg)

    plans: list = []
    candidates: dict[int, list] = {}
    for i, f in enumerate(table.features):
        n_f = min(max(infer_n_bits(f, headroom=headroom), 1), n_decl)
        cands = [(def_make, def_rows, ColumnPlan(n_decl, c_def))]
        for c in range(1, n_f + 1):
            rows = column_footprint_rows(n_f, c)
            if rows > def_rows:
                continue
            make = _probe_makespan(n_f, c, arch, sys_cfg)
            if make > def_make:
                continue
            cands.append((make, rows, ColumnPlan(n_f, c)))
        # argmin makespan; ties -> smaller footprint -> more chunks
        best = min(cands,
                   key=lambda c: (c[0], c[1], -c[2].num_chunks))
        candidates[i] = cands
        plans.append(best[2])
    budget = min(budget, row_budget) if row_budget is not None else budget
    return _shrink_to_budget(plans, candidates, overhead, mult, budget)


def choose_forest_plan(forest, arch, *, num_rows: int = 1024,
                       sys_cfg=None, headroom: int = 0,
                       num_chunks: int | None = None) -> ColumnPlan:
    """Single-column variant of :func:`choose_representation` for a
    GBDT threshold table: no complement planes, priced with the
    ``>``-only probe that inference issues."""
    sys_cfg = sys_cfg or cost.DESKTOP
    n_decl = forest.n_bits
    # thresholds LUT + shared scratch + masks + double-buffered acc
    overhead = 2 + forest.num_features + 2
    budget = num_rows - BankedSubarray.NUM_RESERVED
    c_def = num_chunks or PAPER_GBDT_CHUNKS.get(n_decl, 1)
    while overhead + column_footprint_rows(n_decl, c_def) > budget:
        c_def += 1
        if c_def > n_decl:
            raise MemoryError(
                f"no chunking of {n_decl}-bit thresholds fits "
                f"{num_rows} rows")
    def_rows = column_footprint_rows(n_decl, c_def)
    def_make = _probe_makespan(n_decl, c_def, arch, sys_cfg, kind="gt")
    n_f = min(max(infer_n_bits(forest.thresholds.reshape(-1),
                               headroom=headroom), 1), n_decl)
    cands = [(def_make, def_rows, ColumnPlan(n_decl, c_def))]
    for c in range(1, n_f + 1):
        rows = column_footprint_rows(n_f, c)
        if rows > def_rows or overhead + rows > budget:
            continue
        make = _probe_makespan(n_f, c, arch, sys_cfg, kind="gt")
        if make > def_make:
            continue
        cands.append((make, rows, ColumnPlan(n_f, c)))
    return min(cands, key=lambda c: (c[0], c[1], -c[2].num_chunks))[2]


def _default_uniform_chunks(n_bits: int, arch, n_feat: int, num_rows: int,
                            start: int | None = None) -> int:
    """The fixed table-wide default chunk count: the paper's section 6.2
    value (or ``start``), raised until every column fits -- the rule a
    fixed table is laid out by (:func:`~repro_torch.apps.predicate.
    fit_chunks`), so the optimizer's baseline is that layout."""
    return fit_chunks(n_bits, n_feat, arch,
                      start or PAPER_PREDICATE_CHUNKS.get((n_bits, arch), 1),
                      num_rows)
