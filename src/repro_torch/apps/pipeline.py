"""Async host/PuD pipeline accounting shared by the app engines.

An app splits its work into waves: wave ``w``'s compute goes into one
of two double-buffered result rows, wave ``w+1`` is issued, and only
then is wave ``w``'s buffer read back and merged on the host, so the
merge of wave N overlaps the device work of wave N+1.  The recorded
streams carry that structure as segments and host events (a per-shard
merge leaf gated on its readout and a root join shared by every
shard); the scheduler places both on absolute time.

:func:`stats_from_timeline` reads a scheduled timeline into
:class:`PipelineStats`: ``serialized_ns`` (no pipelining) and
``overlapped_ns`` (the schedule's span).  Device time is modeled; host
time is the measured wall-clock of the NumPy merge work
(:class:`HostTimer`), the paper's method.  On the card a readout
(``host_read_row``) waits for the queued waves before any timer starts,
so a measured merge holds only host work.

The reference package's ``apps/pipeline.py`` under the same names.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from repro_torch.core.scheduler import Timeline, lane_busy_from_spans


@dataclass
class PipelineStats:
    """Per-wave scheduled device spans + measured host merge times.

    ``makespan_ns`` is the pipeline's span in the barrier-aware
    schedule (device waves AND host-lane spans, relative to the
    pipeline's first wave) -- the overlapped total.  ``device_ns`` is
    the device-wave span alone.  ``host_ns[w]`` is wave ``w``'s total
    measured host work (every shard merge plus the reduction-tree
    join); ``host_lane_busy_ns`` breaks the pipeline's host work down
    per ``(host domain, lane)`` and ``host_utilization`` is the busiest
    lane's busy fraction of the pipeline span -- ~1.0 means a host
    lane is the pipeline ceiling.
    """

    wave_done_ns: list[float] = field(default_factory=list)
    wave_busy_ns: list[float] = field(default_factory=list)
    host_ns: list[float] = field(default_factory=list)
    makespan_ns: float = 0.0     # device + host span of the pipeline
    device_ns: float = 0.0       # device-wave span alone
    host_lane_busy_ns: dict = field(default_factory=dict)
    host_utilization: float = 0.0

    @property
    def num_waves(self) -> int:
        return len(self.wave_done_ns)

    @property
    def serialized_ns(self) -> float:
        """No-pipeline baseline: device waves back-to-back, each host
        merge completing before the next wave issues."""
        return sum(self.wave_busy_ns) + sum(self.host_ns)

    @property
    def overlapped_ns(self) -> float:
        """Double-buffered pipeline total, straight from the
        barrier-aware schedule (merge of wave N overlaps device
        execution of wave N+1; host barriers stall dependent waves)."""
        return self.makespan_ns

    @property
    def overlap_efficiency(self) -> float:
        """serialized / overlapped: >1 means the pipeline hides work."""
        ov = self.overlapped_ns
        return self.serialized_ns / ov if ov > 0 else 1.0


def stats_from_timeline(timeline: Timeline, group_labels: list[str],
                        wave_tags: list[list[str]],
                        host_ns: list[float]) -> PipelineStats:
    """Build :class:`PipelineStats` from a scheduled device timeline.

    ``wave_tags[w]`` lists the trace-segment AND host-event labels
    belonging to wave ``w`` (its compute, readout, and merge steps) on
    every group in ``group_labels``.  Times are reported relative to
    the pipeline's first scheduled wave so one-time setup streams (LUT
    loading) in the same traces don't count against the pipeline; the
    pipeline's host spans (matched by label) extend the total the same
    way they extend the device makespan.
    """
    groups = set(group_labels)
    tag_to_wave = {t: w for w, tags in enumerate(wave_tags)
                   for t in tags}
    done = [0.0] * len(wave_tags)
    busy = [0.0] * len(wave_tags)
    t0 = None
    dev_end = 0.0
    for w in timeline.waves:
        if w.group not in groups or w.seg_label not in tag_to_wave:
            continue
        i = tag_to_wave[w.seg_label]
        busy[i] += w.duration_ns
        done[i] = max(done[i], w.end_ns)
        t0 = w.start_ns if t0 is None else min(t0, w.start_ns)
        dev_end = max(dev_end, w.end_ns)
    t0 = t0 or 0.0
    t_end = dev_end
    own_spans = [h for h in timeline.host_spans
                 if h.label in tag_to_wave]
    for h in own_spans:
        t_end = max(t_end, h.end_ns)
    lane_busy = lane_busy_from_spans(own_spans)
    span = t_end - t0
    return PipelineStats(
        wave_done_ns=[max(0.0, d - t0) for d in done],
        wave_busy_ns=busy,
        host_ns=list(host_ns),
        makespan_ns=span,
        device_ns=dev_end - t0,
        host_lane_busy_ns=lane_busy,
        host_utilization=(max(lane_busy.values()) / span
                          if lane_busy and span > 0 else 0.0),
    )


class HostTimer:
    """Measures the host-side merge work of each pipeline wave."""

    def __init__(self) -> None:
        self.samples_ns: list[float] = []

    def measure(self, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        self.samples_ns.append((time.perf_counter() - t0) * 1e9)
        return out
