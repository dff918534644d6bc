"""Placement planner (bank lifetimes, eviction, defragmentation,
admission) and the representation planner (one ``(n_bits, num_chunks)``
per column).

:class:`Planner` owns ``alloc_banks`` / ``free_banks`` across resource
lifetimes on a device fleet.  :meth:`Planner.admit` registers a build
function and places it; when it does not fit, the planner defragments
every device (RowClone relocation waves, zero pin bytes) and retries,
then evicts cold resources (least recently used first, pinned never)
and retries, and only then *queues* the request: admission is strictly
FIFO, so the head of the queue never loses its turn.  An evicted
resource keeps its build function and is rebuilt from host data on its
next use (:meth:`Planner.ensure_ready`).

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
scheduler.  Its subarray stays on the host (``device="cpu"``): a probe
reads no result, and the card would only add launches.  This is the
reference package's ``pud/planner.py`` under the same names.
"""

from __future__ import annotations

import functools
from collections import deque
from dataclasses import dataclass, field
from typing import Callable

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

@dataclass
class Resource:
    """One planner-managed resource: its (re)build recipe and lifetime
    state (``ready`` -- executor placed; ``queued`` -- waiting for
    capacity; ``evicted`` -- banks reclaimed, rebuild on next use)."""

    name: str
    kind: str                      # "table" | "forest"
    build: Callable[[], object]    # places groups, returns the executor
    pinned: bool = False
    state: str = "queued"
    executor: object | None = None
    last_used: int = 0
    builds: int = 0                # admissions + reloads (tests/metrics)
    meta: dict = field(default_factory=dict)


class Planner:
    """Owns bank placement across resource lifetimes on a device fleet."""

    def __init__(self, devices) -> None:
        self.devices = list(devices)
        self.resources: dict[str, Resource] = {}
        self.queue: deque[Resource] = deque()
        self._tick = 0
        self.evictions = 0
        self.defrag_banks_moved = 0

    # ------------------------------------------------------------------ #
    def admit(self, name: str, kind: str, build: Callable[[], object],
              pinned: bool = False) -> Resource:
        """Register a resource and try to place it (defrag, then evict
        cold resources, then queue -- never raise for capacity).  While
        earlier requests are waiting, a new request queues behind them
        even if it would fit right now: admission is strictly FIFO, so
        a stream of small requests can never starve a large one."""
        if name in self.resources:
            raise ValueError(f"resource {name!r} already registered")
        r = Resource(name=name, kind=kind, build=build, pinned=pinned)
        self.resources[name] = r
        self.touch(name)
        try:
            if self.queue or not self._try_place(r):
                r.state = "queued"
                self.queue.append(r)
        except Exception:
            # a broken build recipe (bad method name, unsupported
            # n_bits, ...) is the caller's error, not a capacity state:
            # unregister so the name stays usable after they fix it
            del self.resources[name]
            raise
        return r

    def release(self, name: str) -> None:
        """Free a resource's banks (coalesced back into the free map),
        forget it, and drain the admission queue FIFO."""
        r = self.resources.pop(name, None)
        if r is None:
            raise KeyError(f"unknown resource {name!r} "
                           "(already dropped, or never registered?)")
        if r in self.queue:
            self.queue.remove(r)
        self._free_executor(r)
        self._drain()

    def evict(self, name: str) -> None:
        """Reclaim a ready resource's banks; it reloads on next use."""
        r = self.resources[name]
        if r.state != "ready":
            raise ValueError(f"cannot evict {name!r} in state {r.state}")
        self._free_executor(r)
        r.state = "evicted"
        self.evictions += 1
        self._drain()

    def ensure_ready(self, name: str):
        """Return the resource's executor, transparently reloading an
        evicted resource (same defrag/evict escalation as admission).
        Raises if the resource is still queued or a reload cannot fit."""
        r = self.resources[name]
        if r.state == "failed":
            raise RuntimeError(
                f"resource {name!r} failed to build: "
                f"{r.meta.get('error')}; drop it and re-create with a "
                "fixed recipe")
        if r.state == "queued":
            raise RuntimeError(
                f"resource {name!r} is queued for capacity "
                f"({self.queued_names()}); free or drop another resource "
                "to admit it")
        if r.state == "evicted" and not self._try_place(r):
            raise MemoryError(
                f"evicted resource {name!r} cannot be reloaded: placement "
                "does not fit even after defragmentation and eviction")
        self.touch(name)
        return r.executor

    def touch(self, name: str) -> None:
        self._tick += 1
        self.resources[name].last_used = self._tick

    def queued_names(self) -> list[str]:
        return [r.name for r in self.queue]

    def cold_resources(self, min_idle: int = 1) -> list[str]:
        """Names of ready, unpinned resources whose ``last_used`` tick
        is at least ``min_idle`` touches behind the planner clock --
        the serving autoscaler's eviction candidates, coldest first.
        (``last_used`` advances on every :meth:`touch`, so idleness is
        measured in fleet activity, not wall time.)"""
        cold = [r for r in self.resources.values()
                if r.state == "ready" and not r.pinned
                and self._tick - r.last_used >= min_idle]
        return [r.name for r in sorted(cold, key=lambda r: r.last_used)]

    def stats(self) -> dict:
        """Fleet-level placement counters for dashboards/tests."""
        return {
            "resources": {r.name: r.state for r in self.resources.values()},
            "queued": self.queued_names(),
            "evictions": self.evictions,
            "defrag_banks_moved": self.defrag_banks_moved,
            "banks_free": [d.banks_free for d in self.devices],
            "largest_free_run": [d.largest_free_run for d in self.devices],
        }

    # ------------------------------------------------------------------ #
    def _free_executor(self, r: Resource) -> None:
        if r.executor is None:
            return
        for dev, sub in r.executor.placements:
            dev.free_banks(sub)
        r.executor = None

    def _build_atomic(self, r: Resource) -> bool:
        """Run the build; on failure roll back every group the partial
        build placed, so a failed attempt leaks nothing.  MemoryError
        means "does not fit" (returns False, the capacity machinery
        takes over); anything else is a broken build recipe and
        propagates after the rollback."""
        marks = [len(d.groups) for d in self.devices]

        def rollback() -> None:
            for d, k in zip(self.devices, marks):
                for g in list(d.groups[k:]):
                    d.free_banks(g)

        try:
            r.executor = r.build()
            return True
        except MemoryError:
            rollback()
            return False
        except Exception:
            rollback()
            raise

    def _evictable(self, r: Resource) -> list[Resource]:
        """Cold-first victim list: ready, unpinned, not the requester."""
        victims = [v for v in self.resources.values()
                   if v is not r and v.state == "ready" and not v.pinned]
        return sorted(victims, key=lambda v: v.last_used)

    def _banks_of(self, r: Resource) -> int:
        if r.executor is None:
            return 0
        return sum(sub.num_banks for _, sub in r.executor.placements)

    def _defrag(self) -> int:
        moved = sum(d.defragment() for d in self.devices)
        self.defrag_banks_moved += moved
        return moved

    def _try_place(self, r: Resource) -> bool:
        """Build -> defrag + retry -> evict cold LRU (re-running defrag
        after each eviction, since freed runs may need compacting) +
        retry.  A failed attempt leaves the fleet as it found it: every
        victim evicted along the way is rebuilt, so a request that can
        never fit cannot permanently strip other resources' placements.
        The attempt's reachable capacity (free + evictable banks) is
        remembered on failure and the whole escalation is skipped until
        more capacity than that exists -- a hopeless request parks in
        the queue without re-churning the fleet on every release."""
        victims = self._evictable(r)
        potential = sum(d.banks_free for d in self.devices) + sum(
            self._banks_of(v) for v in victims)
        failed_at = r.meta.get("failed_at_potential")
        if failed_at is not None and potential <= failed_at:
            return False

        def placed() -> bool:
            r.state = "ready"
            r.builds += 1
            r.meta.pop("failed_at_potential", None)
            return True

        if self._build_atomic(r):
            return placed()
        if self._defrag() and self._build_atomic(r):
            return placed()
        tried: list[Resource] = []
        for victim in victims:
            self._free_executor(victim)
            victim.state = "evicted"
            self.evictions += 1
            tried.append(victim)
            if self._build_atomic(r):
                return placed()
            if self._defrag() and self._build_atomic(r):
                return placed()
        # rollback: the request cannot fit -- restore every victim
        # (one that still cannot rebuild stays evicted and reloads on
        # its next use, the normal eviction contract)
        for victim in tried:
            if self._build_atomic(victim) or (
                    self._defrag() and self._build_atomic(victim)):
                victim.state = "ready"
        r.meta["failed_at_potential"] = potential
        return False

    def _drain(self) -> None:
        """Admit queued requests in strict FIFO order; stop at the first
        head that still does not fit (no queue-jumping -- FIFO fairness
        over packing efficiency).  A queued build that turns out to be
        *broken* (non-capacity error on its first real attempt --
        deferred builds are not validated at admit time) cannot raise
        into whatever release()/evict() triggered the drain: the
        resource is parked in state ``"failed"`` with the error
        recorded, and draining continues past it."""
        while self.queue:
            head = self.queue[0]
            try:
                if not self._try_place(head):
                    return
            except Exception as e:  # broken recipe, not capacity
                self.queue.popleft()
                head.state = "failed"
                head.meta["error"] = repr(e)
                continue
            self.queue.popleft()


# ------------- representation optimizer ------------------------------ #

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
                         arch=arch, device="cpu")
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
