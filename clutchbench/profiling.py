"""The traced window: ``torch.profiler`` with CPU and CUDA activities
over the whole measured window, reduced to a summary the per-layer
readers take.

Device events are the kernels, copies and sets CUPTI records, read
from the profiler's chrome trace (written to the temporary directory
and deleted once read), the one place that gives a copy's bytes.  The
harness's own spans (``window``, ``window.request``) come through as
user annotations; ``setup.generate``, ``setup.build`` and ``check`` lie
outside the window, so no idle gap falls in them.  Spans of ``REFILL``,
where the harness draws more requests inside the window, are cut out of
it, as the window's clock is stopped in them.  An idle gap is
labelled by the innermost host event open at its middle: an operator of
the program, a harness span, or ``window.client`` between requests.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile

import torch

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_KINDS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
TOP = 10
#: the harness's span for drawing more requests inside the window
REFILL = "window.refill"


class Window:
    """``with Window(on):`` profiles its body when ``on``; ``span(name)``
    marks a harness span while the profiler records, at no cost
    otherwise.  With ``calls = (first, count)`` the profiler records
    only those calls of the window (:meth:`at` is told each call's
    index before it starts): a mix whose every call makes thousands of
    operations traces a stretch of it, not all."""

    def __init__(self, on: bool, calls: tuple | None = None) -> None:
        self.on, self.calls = on, calls
        self.prof = None
        self.summary = None
        #: the calls the profiler recorded, ``[first, end)``
        self.traced = None

    def _begin(self, first: int) -> None:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts, record_shapes=False,
                            profile_memory=False, with_stack=False)
        self.prof.__enter__()
        self._outer = torch.profiler.record_function("window")
        self._outer.__enter__()
        self.traced = [first, first]

    def _end(self, end: int, *exc) -> None:
        exc = exc or (None, None, None)
        self._outer.__exit__(*exc)
        self.prof.__exit__(*exc)
        self.traced[1] = end
        self._recording = False

    def __enter__(self):
        self._recording = False
        if self.on and self.calls is None:
            self._begin(0)
            self._recording = True
        return self

    def at(self, i: int) -> None:
        """Call ``i`` of the window is about to start."""
        if not self.on:
            return
        first, count = self.calls
        if i == first:
            self._begin(i)
            self._recording = True
        elif i == first + count and self._recording:
            self._end(i)

    def close(self, calls: int) -> None:
        """The window ended after ``calls`` calls: stop recording and
        reduce the trace."""
        if self._recording:
            self._end(calls)
        if not self.on:
            return
        if self.prof is None:
            raise RuntimeError(f"the window made {calls} calls, so none of "
                               f"the calls {self.calls} to trace")
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            self.summary = reduce(path)
        finally:
            os.unlink(path)

    def __exit__(self, *exc):
        if self._recording:             # the window raised: stop tracing
            self._end(self.traced[0], *exc)
        return False

    def span(self, name: str):
        if self._recording:
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()


def reduce(path: str) -> dict:
    """A chrome trace of the profiler -> the summary of the ``window``
    annotation's span.

    Keys: ``window_s`` (the span), ``busy_s`` (the union of device
    events inside it), ``kernel_s`` (kernel durations summed),
    ``kernels`` (kernel count), ``d2h_bytes`` and ``h2d_bytes``,
    ``device_ops`` (device seconds by name, the largest first) and
    ``idle_gaps`` (idle device seconds by the host event open at each
    gap's middle, the largest first)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev, host, win, cut = [], [], None, []
    for ev in events:
        cat = ev.get("cat")
        if ev.get("ph") != "X" or cat is None:
            continue
        start = round(float(ev["ts"]) * 1000)
        end = start + round(float(ev.get("dur", 0)) * 1000)
        if cat in DEVICE_KINDS:
            nbytes = int(ev.get("args", {}).get("bytes", 0))
            dev.append((start, end, ev["name"], cat, nbytes))
        elif cat in HOST_KINDS:
            if ev["name"] == "window" and cat == "user_annotation":
                win = (start, end)
            elif ev["name"] == REFILL and cat == "user_annotation":
                cut.append((start, end))
            else:
                host.append((start, end, ev["name"]))
    return summarize(dev, host, win, cut)


def _segments(win: tuple, cut) -> list[tuple[int, int]]:
    """The window ``win`` with the intervals ``cut`` taken out."""
    w0, w1 = win
    segs, cursor = [], w0
    for c0, c1 in sorted(cut):
        c0, c1 = max(c0, w0), min(c1, w1)
        if c1 <= c0:
            continue
        if c0 > cursor:
            segs.append((cursor, c0))
        cursor = max(cursor, c1)
    if w1 > cursor:
        segs.append((cursor, w1))
    return segs


def summarize(dev: list, host: list, win: tuple | None, cut=()) -> dict:
    """The summary from plain tuples: ``dev`` of ``(start_ns, end_ns,
    name, kind, bytes)``, ``host`` of ``(start_ns, end_ns, name)``,
    ``win`` the window's ``(start_ns, end_ns)``, ``cut`` the intervals
    taken out of it (device events in them count for nothing)."""
    if win is None:
        raise RuntimeError("the trace holds no 'window' span")
    w0, w1 = win
    segs = _segments(win, cut)
    pieces = []
    kernel_ns, kernels, d2h, h2d = 0, 0, 0, 0
    for s, e, name, kind, nbytes in dev:
        parts = [(max(s, a), min(e, z)) for a, z in segs
                 if e > a and s < z]
        if not parts:
            continue
        pieces += [(p0, p1, name) for p0, p1 in parts]
        if kind == "kernel":
            kernel_ns += sum(p1 - p0 for p0, p1 in parts)
            kernels += 1
        elif kind == "gpu_memcpy":
            if "DtoH" in name or "Device -> Pinned" in name \
                    or "Device -> Pageable" in name:
                d2h += nbytes
            elif "HtoD" in name:
                h2d += nbytes
    pieces.sort()
    busy, gaps, j = 0, [], 0
    ops: dict[str, float] = {}
    for a, z in segs:
        cursor = a
        while j < len(pieces) and pieces[j][0] < z:
            s, e, name = pieces[j]
            if s > cursor:
                gaps.append((cursor, s))
            if e > cursor:
                busy += e - max(s, cursor)
                cursor = e
            ops[name] = ops.get(name, 0.0) + (e - s) / 1e9
            j += 1
        if z > cursor:
            gaps.append((cursor, z))
    host = sorted(h for h in host if h[1] > w0 and h[0] < w1)
    starts = [h[0] for h in host]
    reach, top = [], 0
    for h in host:
        top = max(top, h[1])
        reach.append(top)
    idle: dict[str, float] = {}
    for g0, g1 in gaps:
        label = _open_at(host, starts, reach, (g0 + g1) // 2)
        idle[label] = idle.get(label, 0.0) + (g1 - g0) / 1e9
    return {
        "window_s": sum(z - a for a, z in segs) / 1e9,
        "busy_s": busy / 1e9,
        "kernel_s": kernel_ns / 1e9,
        "kernels": kernels,
        "d2h_bytes": d2h,
        "h2d_bytes": h2d,
        "device_ops": _top(ops),
        "idle_gaps": _top(idle),
    }


def _open_at(host: list, starts: list, reach: list, t: int) -> str:
    """The innermost host event open at ``t`` (the latest started one
    that has not ended), or ``window.client``; ``reach[i]`` is the
    latest end among ``host[:i + 1]``, so the search stops once no
    earlier event reaches ``t``."""
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0 and reach[i] >= t:
        if host[i][1] >= t:
            return host[i][2]
        i -= 1
    return "window.client"


def _top(d: dict) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
            ][:TOP]
