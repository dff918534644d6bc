"""The port's tracing: spans on the profiler's clock and in-process
counters.

* :func:`span` marks a layer boundary.  While a ``torch.profiler``
  records (:func:`recording`), it is a ``record_function`` user
  annotation, so it lands in the profiler's own trace beside the CUDA
  kernels, copies and sets, on their clock; otherwise it is one shared
  null context, behind a single check of the profiler's state.  While a
  profiler records, each span also adds to a tally of how often it
  closed and its total time on the host's monotonic clock, which
  :func:`profiled` reads.
* :func:`count` adds to a plain counter.  :func:`counters` returns the
  counters with every kernel wrapper's launches under
  ``launch.<kernel>``; :func:`reset_counters` clears them, the launches
  and the spans' tally.

The profiler is the exporter: there is no flag, no environment
variable and no file of this module's own.  Counters and the tally are
process-wide and unlocked, as one thread drives a session at a time.

The fused path's spans (``repro_torch.pud.session`` and
``repro_torch.kernels.fused_session``) nest at most one deep inside a
request's ``pud.query`` or ``pud.predict``, so the session's own time is
that span's less its children's:

==================  ====================================================
``pud.query``,      ``PudSession.query`` / ``.predict``: the whole job
``pud.predict``
``pud.resolve``     index resolution (Algorithm 1, its caches, the
                    indices' concatenation)
``pud.launch``      a fused kernel wrapper: index upload, bounds check,
                    launch
``pud.count``       a count's device sum, the wait and the 8-byte copy
``pud.bitmap``      a bitmap's copy and unpack to booleans
``pud.finish``      Q4/Q5's NumPy mean and Q5's phase-2 scalars
``pud.addrs``       ``FusedGbdtExec.leaf_addrs``: leaf addresses from
                    the leaf bits, copied back (not on the predict path)
``pud.assemble``    the leaf sum on the card (``gbdt_leafbits_sum``) and
                    the predictions' copy back
==================  ====================================================

Counters at index resolution (``FusedTableExec``), counted while a
profiler records: ``resolve.lookups`` (the scalar lookups the ranges
need, cached or not) and ``resolve.computed`` (those that ran
Algorithm 1: the per-scalar memo's misses).
"""

from __future__ import annotations

import contextlib
import time

import torch

#: true exactly while a ``torch.profiler`` records
recording = torch._C._autograd._profiler_enabled
_NULL = contextlib.nullcontext()
_counts: dict[str, int] = {}
#: span name -> [closed, total ns], while a profiler recorded
_tally: dict[str, list[int]] = {}


def span(name: str):
    """A context marking one layer's work: a profiler annotation while
    a profiler records, else a shared null context."""
    if not recording():
        return _NULL
    return _Span(name)


class _Span:
    __slots__ = ("name", "annotation", "start")

    def __init__(self, name: str) -> None:
        self.name = name
        self.annotation = torch.profiler.record_function(name)

    def __enter__(self):
        self.annotation.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        took = time.perf_counter_ns() - self.start
        self.annotation.__exit__(*exc)
        t = _tally.get(self.name)
        if t is None:
            t = _tally[self.name] = [0, 0]
        t[0] += 1
        t[1] += took
        return False


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    _counts[name] = _counts.get(name, 0) + n


def counters() -> dict[str, int]:
    """A snapshot of every counter, and each kernel wrapper's launches
    as ``launch.<kernel>``."""
    from repro_torch.kernels import launch_counts

    out = dict(_counts)
    out.update((f"launch.{k}", v) for k, v in launch_counts().items())
    return out


def profiled() -> dict[str, dict]:
    """Each span's tally since the last :func:`reset_counters`, while a
    profiler recorded: ``{name: {"count", "total_s"}}``."""
    return {k: {"count": c, "total_s": ns / 1e9}
            for k, (c, ns) in _tally.items()}


def reset_counters() -> None:
    """Zero every counter, kernel launch count and span tally."""
    from repro_torch.kernels import reset_launch_counts

    _counts.clear()
    _tally.clear()
    reset_launch_counts()
