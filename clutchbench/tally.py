"""The program's own tally of its spans and counters over the traced
window, for the per-layer readers under ``layer_metrics/``.

While a profiler records, ``repro_torch.tracing`` adds up every span it
hands the profiler (its total seconds) and counts index resolution's
lookups.  A run profiles its window and nothing else, so what the
program added since the tally was last read is the window's.  The
first reader of a run to ask reads the program's totals, keeps their
rise since the last reading in the summary, and every reader of the run
reads that; nothing of the program is cleared.  A program without
``repro_torch.tracing`` has no tally, and its readers read nothing.
"""

from __future__ import annotations

KEY = "program_tally"
#: the program's totals at the last reading
_seen: dict = {}


def of(summary: dict) -> dict | None:
    """The program's tally for the run of ``summary`` (``{"spans":
    {name: seconds}, "counters": {name: n}}``), or ``None``."""
    if KEY not in summary:
        summary[KEY] = _taken()
    return summary[KEY]


def _taken() -> dict | None:
    global _seen
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    now = {("spans", k): v["total_s"] for k, v in tracing.profiled().items()}
    now.update((("counters", k), v) for k, v in tracing.counters().items())
    seen, _seen = _seen, now
    out: dict = {"spans": {}, "counters": {}}
    for (part, name), v in now.items():
        last = seen.get((part, name), 0)
        # a total below its last reading was reset since: count from zero
        rise = v - last if v >= last else v
        if rise > 0:
            out[part][name] = rise
    return out


def per_request_us(summary: dict, names) -> float | None:
    """Microseconds a request of the spans ``names``, or ``None`` where
    none was tallied."""
    tally = of(summary)
    if not tally or summary["requests"] <= 0:
        return None
    found = [tally["spans"][n] for n in names if n in tally["spans"]]
    if not found:
        return None
    return 1e6 * sum(found) / summary["requests"]
