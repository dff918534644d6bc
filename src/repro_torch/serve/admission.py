"""Priority admission for the PuD serving layer.

Counterpart of the reference package's ``serve/admission.py``: the same
deficit-round weights, starvation bound and 429 shed text.

Serving model (admission side)
------------------------------
Request traffic needs a policy of its own: interactive requests should
cut ahead of bulk scans under load, but never so aggressively that
bulk traffic starves, and when
the backlog outruns capacity the server must refuse work *explicitly*
rather than let queueing delay eat every SLO.

:class:`AdmissionController` layers exactly that on top of the
service's FIFO batching:

* **Per-class weighted selection** -- each :class:`~repro_torch.serve.\
arrivals.ClassSpec` carries a ``weight``; dequeueing runs a
  deficit-round: every nonempty class earns its weight in credit,
  the richest class surrenders one request and pays the round's total
  weight back.  Long-run service shares converge to the weight ratio
  while any single dequeue stays O(#classes).
* **Starvation bound** -- a class whose queue head has been passed
  over ``starvation_bound`` times is served FIRST on the next
  dequeue, whatever the credits say.  Weighted priority can delay
  bulk work, never deny it.
* **Shed on overload** -- :meth:`offer` refuses arrivals beyond
  ``capacity`` with an explicit 429-style
  :class:`~repro_torch.serve.pud_service.PudResponse` (``ok=False``,
  ``error`` beginning ``"429 "``); nothing is silently dropped, and
  the shed response carries zero latency because no work was done.
"""

from __future__ import annotations

from collections import deque
from typing import Sequence

from .arrivals import Arrival, ClassSpec
from .pud_service import PudResponse


class AdmissionController:
    """Weighted, starvation-bounded, load-shedding admission queue."""

    def __init__(self, classes: Sequence[ClassSpec],
                 capacity: int = 64, starvation_bound: int = 8) -> None:
        if not classes:
            raise ValueError("need at least one priority class")
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.starvation_bound = starvation_bound
        self.classes: dict[str, ClassSpec] = {c.name: c for c in classes}
        if len(self.classes) != len(classes):
            raise ValueError("duplicate class names")
        self._queues: dict[str, deque[Arrival]] = {
            c.name: deque() for c in classes}
        self._credit: dict[str, float] = {c.name: 0.0 for c in classes}
        self._skips: dict[str, int] = {c.name: 0 for c in classes}
        self.admitted = 0
        self.shed = 0

    @property
    def depth(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def offer(self, arrival: Arrival) -> PudResponse | None:
        """Admit one arrival.  Returns ``None`` when queued; returns an
        explicit 429-style shed response when the backlog is at
        capacity (the request is NOT queued)."""
        cls = arrival.cls
        if cls not in self._queues:
            raise KeyError(f"unknown priority class {cls!r} "
                           f"(have {sorted(self._queues)})")
        if self.depth >= self.capacity:
            self.shed += 1
            return PudResponse(
                rid=arrival.rid, result=None, stats=None,
                latency_ns=0.0, ok=False,
                error=(f"429 overloaded: admission queue full "
                       f"(depth {self.depth} >= capacity "
                       f"{self.capacity}); request shed, retry later"))
        self._queues[cls].append(arrival)
        self.admitted += 1
        return None

    def take(self, max_n: int) -> list[Arrival]:
        """Dequeue up to ``max_n`` arrivals by weighted deficit round,
        honoring the starvation bound (FIFO within each class)."""
        out: list[Arrival] = []
        while len(out) < max_n:
            nonempty = [n for n, q in self._queues.items() if q]
            if not nonempty:
                break
            starving = [n for n in nonempty
                        if self._skips[n] >= self.starvation_bound]
            if starving:
                pick = max(starving, key=lambda n: self._skips[n])
            else:
                for n in nonempty:
                    self._credit[n] += self.classes[n].weight
                # richest class first; earlier head breaks ties so
                # equal-weight classes serve in arrival order
                pick = max(nonempty, key=lambda n: (
                    self._credit[n], -self._queues[n][0].arrive_ns))
                self._credit[pick] -= sum(
                    self.classes[n].weight for n in nonempty)
            for n in nonempty:
                self._skips[n] += 1
            self._skips[pick] = 0
            out.append(self._queues[pick].popleft())
        return out
