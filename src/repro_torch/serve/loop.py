"""Simulated-clock open-loop serving for the PuD substrate.

Counterpart of the reference package's ``serve/loop.py``, with the
card's measured job wall-clock as the cost oracle.

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
   here with a 429 (it could never succeed).
3. **Execute** -- the batch dispatches through the
   :class:`~repro_torch.serve.batcher.DeadlineBatcher` (probe, predict,
   split); the clock advances by the dispatch's makespan, so service
   time feeds back into queueing delay for everything still waiting --
   saturation emerges instead of being modeled.  The makespan is
   built from attributed latencies (see the batcher), so the clock
   is not the host's elapsed time.

The reference's loop has a fourth step that this one leaves out, with
the pieces it needs: the autoscaler re-schedules a job's recorded
command streams under other host-lane configs (the card's jobs record
no streams and have no timeline), each dispatched request is reported
to pudlint's serving pass (the port has no pudlint), and each dispatch
ends by retiring its resource's simulator traces (the card keeps none).

The returned :class:`ServingReport` carries every per-request record
plus the derived curve points (p50/p99 over *successful* requests,
goodput = deadline-met completions per simulated second).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np

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
    stays empty (no autoscaler runs on the card), so :meth:`to_json`
    keeps the reference's keys."""

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
    """Event loop binding arrivals -> admission -> batcher over one
    :class:`~repro_torch.serve.pud_service.PudService`.  The reference's
    ``autoscaler`` argument is left out: it needs a job's recorded
    streams and timeline, which the card's jobs do not have."""

    def __init__(self, service: PudService,
                 admission: AdmissionController,
                 batcher: DeadlineBatcher | None = None,
                 max_batch: int = 8) -> None:
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.service = service
        self.admission = admission
        self.batcher = batcher or DeadlineBatcher(service)
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
                # a request whose deadline precedes its start can never
                # succeed: shed it with an explicit overload-class error
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
                budget = None if deadline_abs is None \
                    else deadline_abs - start
                reqs.append(replace(a.request, deadline_ns=budget))
            outcome = self.batcher.dispatch(handle, kind, reqs)
            for a, resp in zip(group, outcome.responses):
                report.records.append(ServedRecord(
                    rid=a.rid, cls=a.cls, arrive_ns=a.arrive_ns,
                    ok=resp.ok, error=resp.error, start_ns=start,
                    finish_ns=start + resp.latency_ns))
            offset += outcome.makespan_ns
        return now + offset
