"""Utilization-driven autoscaling for the PuD serving layer.

The reference package's ``serve/autoscaler.py`` under the same names.
It reads machine-backend jobs only: their recorded command streams and
scheduled timelines are host data (the bank state may be on the card),
so re-evaluating a config is host scheduling, not a card run.

Serving model (scaling side)
----------------------------
Every machine-backend job carries a scheduled
:class:`~repro_torch.core.scheduler.Timeline` whose ``host_utilization``
(busiest merge lane / makespan) and per-channel busy fractions say
WHERE the pipeline ceiling is: a host-bound job wants more merge
lanes (or per-device hosts), a DRAM-bound job wastes any lanes beyond
one.  :class:`UtilizationAutoscaler` turns that signal into config
actions on the live session:

* a rolling window of recent jobs' ``host_utilization`` is kept;
  when its median leaves the ``[lo_util, hi_util]`` comfort band, the
  scaler *re-evaluates*: the LAST job's recorded streams are
  re-scheduled under every candidate ``(host_lanes, hosts)`` config
  (recorded streams are config-agnostic -- scheduling is free on the
  simulated clock), and the argmin-makespan config wins, ties to the
  smaller/cheaper config;
* the winning config is applied through the session hooks
  (:meth:`~repro_torch.pud.PudSession.set_host_lanes` /
  :meth:`~repro_torch.pud.PudSession.set_hosts`) and takes effect on the
  next dispatched batch;
* optionally (``evict_idle``), re-evaluation also evicts cold planner
  resources (ready, unpinned, untouched for ``evict_idle`` planner
  ticks) so an idle table's banks return to the free map for hotter
  tenants -- the planner reloads them transparently on next use.

Because the chosen config is the argmin over the SAME candidate set a
static sweep would try, an autoscaled dispatch is never scheduled
slower than the best static config on the job it re-evaluated -- the
property the chip smoke's phase 14 checks
(``decision.predicted_ns <= decision.static_best_ns``).
"""

from __future__ import annotations

import statistics
from collections import deque
from dataclasses import dataclass, replace
from typing import Sequence

from repro_torch.pud.session import PudSession


@dataclass(frozen=True)
class ScaleDecision:
    """One re-evaluation's outcome: the chosen config, its predicted
    makespan on the probe job, the best static candidate's makespan
    (== ``predicted_ns`` by argmin construction), the makespan under
    the config that was active before, and any resources evicted."""

    host_lanes: int
    hosts: str
    predicted_ns: float
    static_best_ns: float
    baseline_ns: float
    trigger_util: float
    evicted: tuple[str, ...] = ()


class UtilizationAutoscaler:
    """Rolling-median utilization bands -> re-evaluate -> apply."""

    def __init__(self, session: PudSession,
                 lane_options: Sequence[int] = (1, 2, 4),
                 host_options: Sequence[str] = ("shared", "per-device"),
                 window: int = 4, lo_util: float = 0.25,
                 hi_util: float = 0.75,
                 evict_idle: int | None = None) -> None:
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.session = session
        self.lane_options = tuple(lane_options)
        self.host_options = tuple(host_options)
        self.lo_util = lo_util
        self.hi_util = hi_util
        self.evict_idle = evict_idle
        self._window: deque[float] = deque(maxlen=window)
        #: Every decision taken, in order.
        self.decisions: list[ScaleDecision] = []

    def observe(self, ex, timeline) -> ScaleDecision | None:
        """Feed one completed machine job (its executor + scheduled
        timeline).  Returns the decision taken, or ``None`` while the
        utilization median stays inside the comfort band (or the
        window is still filling)."""
        if timeline is None:           # fused job: no scheduled signal
            return None
        self._window.append(timeline.host_utilization)
        if len(self._window) < self._window.maxlen:
            return None
        med = statistics.median(self._window)
        if self.lo_util <= med <= self.hi_util:
            return None
        decision = self._rescale(ex, med)
        self._window.clear()
        self.decisions.append(decision)
        return decision

    # ------------------------------------------------------------------ #
    def _rescale(self, ex, trigger_util: float) -> ScaleDecision:
        """Argmin predicted makespan over the candidate grid by
        re-scheduling the probe executor's last job under each config
        (its recorded streams are identical across candidates)."""
        cfg = self.session.sys_cfg
        orig_hosts = ex.hosts
        baseline = float(ex.schedule(cfg).makespan_ns)
        best = None            # (makespan, lanes, hosts_rank, hosts)
        try:
            for hosts in self.host_options:
                ex.hosts = hosts
                rank = self.host_options.index(hosts)
                for lanes in self.lane_options:
                    tl = ex.schedule(replace(cfg, host_lanes=lanes))
                    cand = (float(tl.makespan_ns), lanes, rank, hosts)
                    if best is None or cand[:3] < best[:3]:
                        best = cand
        finally:
            ex.hosts = orig_hosts
        makespan, lanes, _, hosts = best
        self.session.set_host_lanes(lanes)
        self.session.set_hosts(hosts)
        evicted: tuple[str, ...] = ()
        if self.evict_idle is not None:
            evicted = tuple(
                self.session.planner.cold_resources(self.evict_idle))
            for name in evicted:
                self.session.planner.evict(name)
        return ScaleDecision(
            host_lanes=lanes, hosts=hosts, predicted_ns=makespan,
            static_best_ns=makespan, baseline_ns=baseline,
            trigger_util=trigger_util, evicted=evicted)
