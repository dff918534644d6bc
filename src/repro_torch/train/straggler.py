"""Straggler mitigation: step-time watchdog.

Counterpart of the reference package's ``train/straggler.py``.  The
watchdog keeps a rolling median of step wall times and flags a step
that exceeds ``threshold x median``; ``on_straggler`` is where a
launcher would act (restart from the latest checkpoint, swap in a
spare).  Here the hook records events, and a test injects a delay.
"""

from __future__ import annotations

import statistics
import time
from dataclasses import dataclass, field
from typing import Callable


@dataclass
class StragglerWatchdog:
    threshold: float = 2.5
    window: int = 32
    min_samples: int = 8
    on_straggler: Callable[[int, float, float], None] | None = None
    _times: list[float] = field(default_factory=list)
    events: list[dict] = field(default_factory=list)
    _t0: float | None = None

    def step_begin(self) -> None:
        self._t0 = time.monotonic()

    def step_end(self, step: int) -> bool:
        """Returns True if this step was flagged as a straggler."""
        if self._t0 is None:
            raise RuntimeError("step_end without step_begin")
        dt = time.monotonic() - self._t0
        flagged = False
        if len(self._times) >= self.min_samples:
            med = statistics.median(self._times)
            if dt > self.threshold * med:
                flagged = True
                ev = {"step": step, "seconds": dt, "median": med}
                self.events.append(ev)
                if self.on_straggler is not None:
                    self.on_straggler(step, dt, med)
        self._times.append(dt)
        if len(self._times) > self.window:
            self._times.pop(0)
        return flagged
