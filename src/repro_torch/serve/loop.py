"""Simulated-clock open-loop serving for the PuD substrate.

Counterpart of the reference package's ``serve/loop.py``.  Its cost
oracle is the session's: a machine job's modeled, scheduled makespan
(its bank state on the card), or a fused job's measured wall-clock on
the card.

Serving model (the loop)
------------------------
:class:`ServingLoop` turns attributed job latencies into *serving*
metrics -- p50/p99 latency and goodput under offered load.  One
simulated clock drives everything:

1. **Ingest** -- open-loop arrivals (see
   :mod:`repro_torch.serve.arrivals`) are offered to the
   :class:`~repro_torch.serve.admission.AdmissionController` the moment
   the clock passes their timestamps; overload sheds come back as
   explicit 429 responses and are recorded as served (failed)
   requests, never silently dropped.
2. **Form** -- when the server is free, up to ``max_batch`` requests
   leave admission (weighted priority, starvation-bounded).  Each
   taken request's *remaining* deadline budget is its absolute
   deadline minus the clock: queueing delay eats SLO, exactly like a
   real server.  A request whose budget is already negative is shed
   here with a 429 (it could never succeed; scheduling it would be the
   PL401 pudlint violation) -- dispatched requests are reported to the
   pudlint collector so the serving-admission pass audits every
   schedule this loop commits.
3. **Execute** -- the batch dispatches through the
   :class:`~repro_torch.serve.batcher.DeadlineBatcher` (probe, predict,
   split); the clock advances by the dispatch's makespan, so service
   time feeds back into queueing delay for everything still waiting --
   saturation emerges instead of being modeled.  The makespan is
   built from attributed latencies (see the batcher), so the clock
   is not the host's elapsed time.
4. **Scale** -- each committed machine job's timeline feeds the optional
   :class:`~repro_torch.serve.autoscaler.UtilizationAutoscaler`, whose
   config changes take effect on the next dispatch (fused jobs have no
   timeline and are skipped).  The dispatched resource's recorded
   command traces are then retired
   (:meth:`~repro_torch.pud.session.PudSession.clear_traces`): job-scoped
   stats, lint and attribution all happen before retirement, and a
   long-running server must not accumulate trace history without
   bound.

The returned :class:`ServingReport` carries every per-request record
plus the derived curve points (p50/p99 over *successful* requests,
goodput = deadline-met completions per simulated second).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np

from repro_torch.core import machine

from .admission import AdmissionController
from .arrivals import Arrival
from .batcher import DeadlineBatcher
from .pud_service import PudService


@dataclass(frozen=True)
class ServedRecord:
    """One request's life on the simulated clock.  ``start_ns`` /
    ``finish_ns`` are ``None`` for requests shed before execution;
    ``latency_ns`` (arrival -> finish, queueing included) is ``None``
    unless the request actually executed."""

    rid: int
    cls: str
    arrive_ns: float
    ok: bool
    error: str | None = None
    start_ns: float | None = None
    finish_ns: float | None = None

    @property
    def latency_ns(self) -> float | None:
        if self.finish_ns is None:
            return None
        return self.finish_ns - self.arrive_ns


@dataclass
class ServingReport:
    """All records of one :meth:`ServingLoop.run`, plus derived serving
    metrics.  ``goodput_rps`` counts only ``ok`` completions (SLO met,
    not shed) per simulated second -- the quantity that saturates and
    then *degrades* as offered load outruns capacity.  ``decisions``
    lists the autoscaler's decisions, if one ran."""

    records: list[ServedRecord] = field(default_factory=list)
    duration_ns: float = 0.0
    splits: int = 0
    probes: int = 0
    decisions: list = field(default_factory=list)

    @property
    def offered(self) -> int:
        return len(self.records)

    @property
    def completed(self) -> int:
        return sum(1 for r in self.records if r.ok)

    @property
    def shed(self) -> int:
        return sum(1 for r in self.records if r.start_ns is None)

    def latencies_ns(self) -> list[float]:
        return sorted(r.latency_ns for r in self.records
                      if r.ok and r.latency_ns is not None)

    def percentile_ns(self, p: float) -> float:
        lats = self.latencies_ns()
        if not lats:
            return float("nan")
        return float(np.percentile(lats, p))

    @property
    def p50_ns(self) -> float:
        return self.percentile_ns(50.0)

    @property
    def p99_ns(self) -> float:
        return self.percentile_ns(99.0)

    @property
    def goodput_rps(self) -> float:
        if self.duration_ns <= 0:
            return 0.0
        return self.completed / (self.duration_ns / 1e9)

    def to_json(self) -> dict:
        return {
            "offered": self.offered, "completed": self.completed,
            "shed": self.shed, "splits": self.splits,
            "probes": self.probes,
            "duration_ns": self.duration_ns,
            "p50_ns": self.p50_ns, "p99_ns": self.p99_ns,
            "goodput_rps": self.goodput_rps,
        }


class ServingLoop:
    """Event loop binding arrivals -> admission -> batcher -> scaler
    over one :class:`~repro_torch.serve.pud_service.PudService`."""

    def __init__(self, service: PudService,
                 admission: AdmissionController,
                 batcher: DeadlineBatcher | None = None,
                 autoscaler=None, max_batch: int = 8) -> None:
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.service = service
        self.admission = admission
        self.batcher = batcher or DeadlineBatcher(service)
        self.autoscaler = autoscaler
        self.max_batch = max_batch

    def run(self, arrivals: list[Arrival]) -> ServingReport:
        """Serve every arrival to completion on the simulated clock and
        return the full report (records in completion order)."""
        arrivals = sorted(arrivals, key=lambda a: a.arrive_ns)
        report = ServingReport()
        clock = 0.0
        i = 0
        while i < len(arrivals) or self.admission.depth:
            if self.admission.depth == 0:
                clock = max(clock, arrivals[i].arrive_ns)
            while i < len(arrivals) and arrivals[i].arrive_ns <= clock:
                shed = self.admission.offer(arrivals[i])
                if shed is not None:
                    report.records.append(ServedRecord(
                        rid=arrivals[i].rid, cls=arrivals[i].cls,
                        arrive_ns=arrivals[i].arrive_ns,
                        ok=False, error=shed.error))
                i += 1
            if self.admission.depth == 0:
                continue
            clock = self._dispatch(
                self.admission.take(self.max_batch), clock, report)
        report.duration_ns = clock
        report.splits = self.batcher.splits
        report.probes = self.batcher.probes
        if self.autoscaler is not None:
            report.decisions = list(self.autoscaler.decisions)
        return report

    # ------------------------------------------------------------------ #
    def _dispatch(self, taken: list[Arrival], now: float,
                  report: ServingReport) -> float:
        """Execute one admission draw: shed already-expired requests,
        group the rest per (resource, kind) like ``PudService.flush``,
        and run each group serially through the batcher.  Returns the
        new clock."""
        groups: dict[tuple[str, str], list] = {}
        for a in taken:
            deadline_abs = a.deadline_abs_ns
            if deadline_abs is not None and deadline_abs < now:
                # dispatching this would BE the PL401 violation: shed
                # it with an explicit overload-class error instead
                report.records.append(ServedRecord(
                    rid=a.rid, cls=a.cls, arrive_ns=a.arrive_ns,
                    ok=False, error=(
                        f"429 overloaded: deadline "
                        f"{deadline_abs:.0f} ns expired before batch "
                        f"start {now:.0f} ns; request shed unexecuted")))
                continue
            req = a.request
            kind = "query" if req.query is not None else "predict"
            groups.setdefault((req.resource_name, kind), []).append(a)
        offset = 0.0
        for (name, kind), group in groups.items():
            handle = self.service._handle(name, kind)
            start = now + offset
            reqs = []
            for a in group:
                deadline_abs = a.deadline_abs_ns
                self._audit(a, start, deadline_abs)
                budget = None if deadline_abs is None \
                    else deadline_abs - start
                reqs.append(replace(a.request, deadline_ns=budget))
            outcome = self.batcher.dispatch(handle, kind, reqs)
            for a, resp in zip(group, outcome.responses):
                report.records.append(ServedRecord(
                    rid=a.rid, cls=a.cls, arrive_ns=a.arrive_ns,
                    ok=resp.ok, error=resp.error, start_ns=start,
                    finish_ns=start + resp.latency_ns))
            if self.autoscaler is not None:
                ex = self.service.session.executor(handle)
                for job in outcome.jobs:
                    self.autoscaler.observe(ex, job.timeline)
            # retire the resource's recorded command traces now that the
            # dispatch is committed, linted (per-job verify + PL4xx
            # audit) and observed: a long-running server would
            # otherwise grow every subarray's recorded history without
            # bound, and whole-trace lints would see successive jobs'
            # row reuse as cross-job hazards no scheduler ever races
            self.service.session.clear_traces(handle)
            offset += outcome.makespan_ns
        return now + offset

    @staticmethod
    def _audit(a: Arrival, start_ns: float,
               deadline_abs: float | None) -> None:
        """Report one dispatched request to the active pudlint
        collector (``machine._LINT_REGISTRY``) for the PL4xx
        serving-admission pass."""
        reg = machine._LINT_REGISTRY
        if reg is not None and hasattr(reg, "add_serving"):
            reg.add_serving({"rid": a.rid, "cls": a.cls,
                             "start_ns": start_ns,
                             "deadline_ns": deadline_abs})
