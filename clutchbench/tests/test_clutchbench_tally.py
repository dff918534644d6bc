"""The readers of the program's own spans and counters: a run's tally
is what the program added since the last reading, kept for the run;
each reader gives its number on a synthetic summary, and nothing where
its entry does not apply or the program keeps no tally (a program
without ``repro_torch.tracing``)."""

import sys
from pathlib import Path

import pytest

from clutchbench import tally
from clutchbench.manifest import Manifest

ROOT = Path(__file__).resolve().parents[2]
M = Manifest(ROOT / "BENCHMARK.json")


QUERY = {"spans": {"pud.query": 8e-3, "pud.resolve": 3e-3,
                   "pud.launch": 1e-3, "pud.count": 1.2e-3,
                   "pud.bitmap": 0.6e-3, "pud.finish": 0.2e-3},
         "counters": {"resolve.lookups": 16, "resolve.computed": 12}}
PREDICT = {"spans": {"pud.predict": 10e-3, "pud.resolve": 4e-3,
                     "pud.launch": 1e-3, "pud.addrs": 3e-3,
                     "pud.assemble": 1e-3},
           "counters": {}}


def _summary(entry, program, requests):
    return {"entry": entry, "requests": requests,
            tally.KEY: program}


@pytest.mark.parametrize("metric,want", [
    ("session_us.count", 500.0), ("resolve_us.count", 750.0),
    ("launch_us.count", 250.0), ("result_us.count", 500.0),
    ("resolve_hits.count", 25.0),
    ("session_us.predict", 500.0), ("resolve_us.predict", 2000.0),
    ("launch_us.predict", 500.0), ("result_us.predict", 2000.0),
])
def test_each_reader_reads_its_number(metric, want):
    program = QUERY if "predict" not in metric else PREDICT
    s = _summary("predict" if "predict" in metric else "query", program,
                 4 if program is QUERY else 2)
    assert M.reader(metric)(s) == pytest.approx(want)


def test_the_four_times_cover_the_job():
    for program, entry, n in ((QUERY, "query", 4), (PREDICT, "predict", 2)):
        s = _summary(entry, program, n)
        parts = sum(M.reader(f"{b}.x")(s) for b in (
            "session_us", "resolve_us", "launch_us", "result_us"))
        outer = program["spans"][f"pud.{entry}"]
        assert parts == pytest.approx(1e6 * outer / n)


@pytest.mark.parametrize("base", ["session_us", "resolve_us", "launch_us",
                                  "result_us", "resolve_hits"])
def test_nothing_to_read_gives_none(base, monkeypatch):
    read = M.reader(base)
    assert read(_summary("query", None, 4)) is None
    assert read(_summary("query", {"spans": {}, "counters": {}}, 4)) is None
    assert read(_summary("query", QUERY, 0)) is None
    if base == "resolve_hits":
        assert read(_summary("predict", PREDICT, 2)) is None
    # a program without the tracing module: no tally, no error
    import repro_torch
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    monkeypatch.delattr(repro_torch, "tracing", raising=False)
    s = {"entry": "query", "requests": 4}
    assert read(s) is None and s[tally.KEY] is None


def test_the_tally_is_the_rise_since_the_last_reading():
    from repro_torch import tracing
    from torch.profiler import ProfilerActivity, profile

    def window(n):
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(n):
                with tracing.span("pud.query"):
                    tracing.count("resolve.lookups", 2)
        return {"entry": "query", "requests": n}

    tally.of({"entry": "query", "requests": 1})     # whatever came before
    first = window(3)
    assert tally.of(first)["counters"]["resolve.lookups"] == 6
    assert tracing.profiled()["pud.query"]["count"] >= 3   # not cleared
    assert M.reader("resolve_hits")(first) == 100.0  # kept for the run
    assert M.reader("session_us")(first) > 0
    again = {"entry": "query", "requests": 3}
    assert M.reader("session_us")(again) is None     # nothing since
    second = window(2)
    assert tally.of(second)["counters"] == {"resolve.lookups": 4}
    tracing.reset_counters()                         # counts from zero
    third = window(1)
    assert tally.of(third)["counters"] == {"resolve.lookups": 2}
    assert set(tally.of(third)["spans"]) == {"pud.query"}
