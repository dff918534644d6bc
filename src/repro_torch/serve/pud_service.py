"""Request/response front end over a :class:`repro_torch.pud.PudSession`.

Counterpart of the reference package's ``serve/pud_service.py``:

    from repro_torch.pud import PudSession, Q1
    from repro_torch.serve.pud_service import PudRequest, PudService

    service = PudService(PudSession())       # device="cpu" off the card
    table = service.session.create_table(t, name="events")
    service.submit(PudRequest(rid=1, resource="events",
                              query=Q1(fi=0, x0=10, x1=90)))
    service.submit(PudRequest(rid=2, resource="events", query=Q3(...)))
    responses = service.flush()          # [PudResponse, ...] in rid order

Batching: ``flush`` groups pending requests by resource (arrival order
preserved within a group) and runs each group as ONE session job --
query requests become one query batch, predict requests concatenate
their instances into one inference batch.

Latency attribution: the port's session has one backend, the card, and
its jobs carry no scheduled timeline, only the batch's measured
``wallclock_ns`` (the reference's fused contract).  Queries amortize it
evenly across the batch, predicts proportionally to instance count, so
attributed latencies always SUM to the measured batch wall-clock.
``PudResponse.stats`` is always ``None``.

Deadlines: a request may carry ``deadline_ns``; at flush its attributed
latency is checked against it and an expired request fails alone
(``ok=False``) -- the batch is never poisoned by one late member.
:class:`repro_torch.serve.batcher.DeadlineBatcher` builds on this to
split batches *before* a member expires.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np

from repro_torch.pud.queries import Q1, Q2, Q3, Q4, Q5, Compound
from repro_torch.pud.session import (
    ForestHandle,
    PudSession,
    ResourceHandle,
    TableHandle,
)


@dataclass
class PudRequest:
    """One client request: a query against a table resource, or an
    instance batch against a forest resource (exactly one of ``query``
    / ``X`` must be set).

    ``deadline_ns`` is an optional per-request latency budget, checked
    at flush against the request's attributed completion time in the
    batch it rode in: a request whose latency exceeds its deadline comes
    back with ``ok=False`` (result withheld) while the rest of the batch
    is unaffected."""

    rid: int
    resource: str | ResourceHandle
    query: Any | None = None          # a repro_torch.pud.queries description
    X: np.ndarray | None = None       # [B, F] instances for a forest
    deadline_ns: float | None = None  # attributed-latency budget

    def __post_init__(self) -> None:
        if (self.query is None) == (self.X is None):
            raise ValueError(
                "a PudRequest carries either `query` or `X`, not both")
        if self.query is not None and not isinstance(
                self.query, (Q1, Q2, Q3, Q4, Q5, Compound)):
            raise TypeError(f"unknown query type {type(self.query)}")

    @property
    def resource_name(self) -> str:
        if isinstance(self.resource, ResourceHandle):
            return self.resource.name
        return self.resource


@dataclass
class PudResponse:
    """One request's outcome: its result, the batch's ``stats`` (always
    ``None`` here: the card's jobs have no scheduler stats), its
    ``batch_size`` peers and its latency attribution.  ``ok`` is
    ``False`` for a request that missed its ``deadline_ns`` (the batch
    still executed; the result is withheld and ``error`` says by how
    much the deadline was missed) or that admission shed before
    execution (``error`` then carries a 429-style reason)."""

    rid: int
    result: Any
    stats: Any
    latency_ns: float
    batch_size: int = 1
    ok: bool = True
    error: str | None = None


@dataclass
class PudService:
    """Batched serving loop over one session (single-threaded: requests
    accumulate via :meth:`submit` and execute on :meth:`flush`).

    Pending requests are keyed by rid in arrival order: ``submit`` is
    O(1), and a rid becomes reusable the moment it leaves the queue --
    ``submit`` after ``cancel`` of the same rid is always accepted, and
    a flush retires exactly the rids it executed, so a request
    submitted while a flush retry is being arranged is never lost."""

    session: PudSession
    _pending: dict[int, PudRequest] = field(default_factory=dict)
    #: JobResult of the most recent :meth:`_run_batch` execution (its
    #: measured ``wallclock_ns``), for the batcher and the serving loop.
    last_job: Any = field(default=None, repr=False)

    def submit(self, request: PudRequest) -> None:
        if request.rid in self._pending:
            raise ValueError(
                f"duplicate request id {request.rid} already pending")
        self._pending[request.rid] = request

    def cancel(self, rid: int) -> bool:
        """Remove a pending request (e.g. one that made :meth:`flush`
        fail); returns whether it was found.  The rid is immediately
        reusable by a fresh :meth:`submit`."""
        return self._pending.pop(rid, None) is not None

    @property
    def queue_depth(self) -> int:
        return len(self._pending)

    def flush(self) -> list[PudResponse]:
        """Execute every pending request (batched per resource, arrival
        order preserved) and return responses in submission order.  On
        failure (unknown resource, wrong resource kind, ...) the pending
        queue is left intact so the caller can :meth:`cancel` the
        offending request and flush again; jobs of groups that had
        already executed are re-run on the retry.

        Requests carrying a ``deadline_ns`` are checked against their
        attributed latency: an expired request fails individually
        (``ok=False``, result withheld) WITHOUT poisoning the batch --
        its peers' responses are exactly what they would have been."""
        pending = list(self._pending.values())
        groups: dict[tuple[str, str], list[PudRequest]] = {}
        for req in pending:
            kind = "query" if req.query is not None else "predict"
            groups.setdefault((req.resource_name, kind), []).append(req)
        # resolve every handle before executing anything: a bad request
        # fails the flush before any batch has run
        handles = {key: self._handle(*key) for key in groups}
        by_rid: dict[int, PudResponse] = {}
        for (name, kind), reqs in groups.items():
            for req, resp in zip(
                    reqs, self._run_batch(handles[(name, kind)],
                                          kind, reqs)):
                by_rid[req.rid] = self._deadline_checked(resp, req)
        # retire exactly the rids this flush executed: a submit that
        # raced in after the snapshot stays pending for the next flush
        for req in pending:
            self._pending.pop(req.rid, None)
        return [by_rid[r.rid] for r in pending]

    # ------------------------------------------------------------------ #
    # Batch execution + attribution (shared with serve.batcher)
    # ------------------------------------------------------------------ #
    def _run_batch(self, handle: ResourceHandle, kind: str,
                   reqs: list[PudRequest]) -> list[PudResponse]:
        """Run one per-resource group as a single session job and
        return per-request responses with attributed latencies, in
        ``reqs`` order.  Deadline enforcement is the caller's."""
        if kind == "query":
            job = self.session.query(handle, [r.query for r in reqs])
            self.last_job = job
            lats = self._query_latencies(handle, job, len(reqs))
            return [PudResponse(rid=r.rid, result=job.result[i],
                                stats=None, latency_ns=lats[i],
                                batch_size=len(reqs))
                    for i, r in enumerate(reqs)]
        sizes = [int(np.asarray(r.X).shape[0]) for r in reqs]
        X = np.concatenate([np.asarray(r.X) for r in reqs])
        job = self.session.predict(handle, X)
        self.last_job = job
        lats = self._predict_latencies(handle, job, sizes)
        out: list[PudResponse] = []
        off = 0
        for r, sz, lat in zip(reqs, sizes, lats):
            out.append(PudResponse(
                rid=r.rid, result=job.result[off:off + sz],
                stats=None, latency_ns=lat,
                batch_size=len(reqs)))
            off += sz
        return out

    def _query_latencies(self, handle: ResourceHandle, job,
                         n: int) -> list[float]:
        """Per-request completion times for a query batch: an even share
        of the measured batch wall-clock (shares sum to the batch
        total)."""
        return [job.wallclock_ns / n] * n

    def _predict_latencies(self, handle: ResourceHandle, job,
                           sizes: list[int]) -> list[float]:
        """Per-request completion times for a concatenated inference
        batch: the batch wall-clock split proportionally to instance
        counts (shares sum to the batch total)."""
        total = sum(sizes) or 1
        return [job.wallclock_ns * sz / total for sz in sizes]

    @staticmethod
    def _deadline_checked(resp: PudResponse,
                          req: PudRequest) -> PudResponse:
        """Fail ONE response whose attributed latency blew its deadline;
        the batch (and every peer response) is untouched."""
        if req.deadline_ns is not None \
                and resp.latency_ns > req.deadline_ns:
            resp.result = None
            resp.ok = False
            resp.error = (
                f"deadline exceeded: scheduled latency "
                f"{resp.latency_ns:.0f} ns > deadline {req.deadline_ns:.0f}"
                " ns")
        return resp

    # ------------------------------------------------------------------ #
    def _handle(self, name: str, kind: str) -> ResourceHandle:
        res_kind = self.session.resource_kind(name)
        if res_kind is None:
            raise KeyError(f"unknown resource {name!r}")
        if kind == "predict":
            if res_kind != "forest":
                raise TypeError(f"{name!r} is a {res_kind}; predict "
                                "requests need a forest")
            return ForestHandle(name=name, session=self.session)
        if res_kind != "table":
            raise TypeError(f"{name!r} is a {res_kind}; query requests "
                            "need a table")
        return TableHandle(name=name, session=self.session)
