"""Deadline-aware batch formation for the PuD serving layer.

Counterpart of the reference package's ``serve/batcher.py``: the same
probe, split, halving, ``max_depth`` and commit offsets.

Serving model (batching side)
-----------------------------
Batching amortizes per-job overhead across requests, but a big batch's
attributed latency can blow an individual member's ``deadline_ns``
budget -- and checking only after the fact means the expired request
fails with the batch already committed.

:class:`DeadlineBatcher` moves the check before the commit.  A probe
is a real execution of the candidate batch (on the card's kernels, or
on the machine model whose bank state is on the card):

1. probe-run the candidate batch via ``PudService._run_batch`` and
   read each member's *attributed* latency (on a fused job an even
   share of the measured wall-clock for queries, a share proportional
   to instance count for predicts; on a machine job the modeled
   completion of its last wave);
2. if a member's predicted completion exceeds its remaining deadline
   budget, the batch SPLITS: the deadline-pressed members commit
   FIRST in their own lean batch (a late member's only hope), while
   members with slack re-probe behind it and may split again
   (recursively, to ``max_depth``).  The split probe's results are
   discarded, and its wall-clock is on no clock the loop keeps;
3. each committed sub-batch's responses are offset by the spans of the
   sub-batches committed before it, so attribution stays serial across
   the split.  A span is the sub-batch's largest attributed latency:
   for a query batch of ``n`` that is ``wallclock_ns / n``, not its
   whole wall-clock, exactly as in the reference's fused path.

With ``enabled=False`` the batcher degrades to split-free flushing:
one probe, commit regardless, late members fail individually --
the baseline that deadline-aware splitting must beat on goodput.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any

from .pud_service import PudRequest, PudResponse, PudService


@dataclass
class DispatchOutcome:
    """One dispatch's committed results: responses in request order
    (deadline-checked), the serial makespan of every committed
    sub-batch, the number of splits taken, and the committed
    sub-batches' :class:`~repro_torch.pud.session.JobResult`\\ s."""

    responses: list[PudResponse]
    makespan_ns: float
    splits: int = 0
    probes: int = 0
    jobs: list[Any] = field(default_factory=list)


class DeadlineBatcher:
    """Probe-predict-split batch formation over one
    :class:`~repro_torch.serve.pud_service.PudService`."""

    def __init__(self, service: PudService, enabled: bool = True,
                 max_depth: int = 3) -> None:
        self.service = service
        self.enabled = enabled
        self.max_depth = max_depth
        self.splits = 0
        self.probes = 0

    def dispatch(self, handle, kind: str,
                 reqs: list[PudRequest]) -> DispatchOutcome:
        """Execute one per-resource request group with deadline-aware
        splitting.  ``deadline_ns`` on each request is its REMAINING
        budget at dispatch time (the serving loop subtracts queueing
        delay before calling); responses come back in ``reqs`` order
        with latencies measured from this dispatch's start."""
        out = DispatchOutcome(responses=[], makespan_ns=0.0)
        by_rid: dict[int, PudResponse] = {}
        self._run(handle, kind, list(reqs), 0, out, by_rid)
        out.responses = [by_rid[r.rid] for r in reqs]
        self.splits += out.splits
        self.probes += out.probes
        return out

    # ------------------------------------------------------------------ #
    def _run(self, handle, kind: str, batch: list[PudRequest],
             depth: int, out: DispatchOutcome,
             by_rid: dict[int, PudResponse]) -> None:
        resps = self.service._run_batch(handle, kind, batch)
        out.probes += 1
        job = self.service.last_job
        span = max((r.latency_ns for r in resps), default=0.0)
        offset = out.makespan_ns
        late = {
            i for i, (rq, rs) in enumerate(zip(batch, resps))
            if rq.deadline_ns is not None
            and offset + rs.latency_ns > rq.deadline_ns}
        if (self.enabled and late and len(batch) > 1
                and depth < self.max_depth):
            meets = [r for i, r in enumerate(batch) if i not in late]
            urgent = [r for i, r in enumerate(batch) if i in late]
            if not meets:
                # every member is late together: halving is the only
                # split that can still save the earlier half
                mid = len(batch) // 2
                urgent, meets = batch[:mid], batch[mid:]
            out.splits += 1
            # the deadline-pressed members' only hope is a lean batch
            # that runs FIRST; the members with slack absorb the wait
            # (the recursive re-probe re-checks them at their new
            # offset and can split again)
            self._run(handle, kind, urgent, depth + 1, out, by_rid)
            self._run(handle, kind, meets, depth + 1, out, by_rid)
            return
        # commit: offset this sub-batch behind the ones already
        # committed, then apply the (post-offset) deadline verdicts
        out.jobs.append(job)
        for rq, rs in zip(batch, resps):
            committed = replace(rs, latency_ns=rs.latency_ns + offset)
            by_rid[rq.rid] = self.service._deadline_checked(committed, rq)
        out.makespan_ns = offset + span
