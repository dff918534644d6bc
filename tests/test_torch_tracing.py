"""``repro_torch.tracing``: spans gated on the profiler, the fused
path's span tree, the resolution counters and the machine backend's
load spans, all on the CPU.

Under ``torch.profiler.profile`` a ``device="cpu"`` fused session marks
each request with ``pud.query`` or ``pud.predict``, and inside it, one
level deep, each step: ``pud.resolve``, ``pud.launch``, ``pud.count``,
``pud.bitmap``, ``pud.finish``, ``pud.assemble`` (a predict's leaf sum
and copy back; ``pud.addrs`` marks only ``leaf_addrs``).  The
counters are checked against counts worked out by hand.
"""

import contextlib

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from repro_torch import convert, tracing
from repro_torch.apps.gbdt import ObliviousForest
from repro_torch.apps.predicate import Table
from repro_torch.core.encoding import ColumnPlan
from repro_torch.kernels.fused_session import FusedTableExec
from repro_torch.kernels.ops import _resolve_scalar_cached
from repro_torch.pud import PudSession
from repro_torch.pud import queries as Q

OUTER = ("pud.query", "pud.predict")


@pytest.fixture(autouse=True)
def fresh_tally():
    tracing.reset_counters()
    yield
    tracing.reset_counters()


def _profile():
    return profile(activities=[ProfilerActivity.CPU])


def _trees(prof) -> list[tuple[str, list[str]]]:
    """Each request's outer span and the ``pud.*`` spans directly under
    it, in order, from the profiler's events."""
    evs = sorted((e for e in prof.events() if e.name.startswith("pud.")),
                 key=lambda e: e.time_range.start)
    trees = []
    for e in evs:
        up = e.cpu_parent
        while up is not None and not up.name.startswith("pud."):
            up = up.cpu_parent
        if e.name in OUTER:
            assert up is None, f"{e.name} inside {up.name}"
            trees.append((e.name, []))
        else:
            assert up is not None and up.name in OUTER, e.name
            assert trees and up.time_range.start <= e.time_range.start \
                and e.time_range.end <= up.time_range.end
            trees[-1][1].append(e.name)
    return trees


def test_span_without_a_profiler_is_one_shared_null_context():
    a, b = tracing.span("pud.a"), tracing.span("pud.b")
    assert a is b and isinstance(a, contextlib.nullcontext)
    outside = tracing.span("pud.outside")
    with _profile() as prof:
        with outside:
            pass
        inside = tracing.span("pud.inside")
        with inside:
            pass
    names = {e.name for e in prof.events()}
    assert "pud.inside" in names and "pud.outside" not in names
    assert inside is not outside
    assert set(tracing.profiled()) == {"pud.inside"}
    with tracing.span("pud.after"):
        pass
    assert set(tracing.profiled()) == {"pud.inside"}


def test_tally_gives_count_and_total_while_recording():
    tracing.count("x", 5)
    with _profile():
        assert tracing.recording()
        with tracing.span("pud.outer"):
            tracing.count("x", 2)
            for _ in range(3):
                with tracing.span("pud.inner"):
                    tracing.count("y")
    assert not tracing.recording()
    got = tracing.profiled()
    outer, inner = got["pud.outer"], got["pud.inner"]
    assert (outer["count"], inner["count"]) == (1, 3)
    assert 0 < inner["total_s"] < outer["total_s"]
    got = tracing.counters()
    assert (got["x"], got["y"]) == (7, 3)
    assert got["launch.fused_predicate_banked"] == 0
    tracing.reset_counters()
    assert tracing.profiled() == {} and "x" not in tracing.counters()


def _table_session(n_bits=8, n=3001, seed=3):
    rng = np.random.default_rng(seed)
    mx = (1 << n_bits) - 1
    feats = [rng.integers(0, mx + 1, n) for _ in range(4)]
    s = PudSession(backend="fused", device="cpu")
    h = s.create_table(convert.table(n_bits, feats), name="t",
                       shards_per_device=2)
    return s, h, mx


def test_fused_table_and_forest_jobs_give_the_span_tree():
    s, h, mx = _table_session()
    qa = dict(fi=0, x0=mx // 8, x1=mx // 2, fj=1, y0=mx // 4,
              y1=3 * mx // 4)
    jobs = [
        Q.Q1(fi=0, x0=mx // 8, x1=mx // 2),
        Q.Q3(**qa),
        Q.Q4(fk=2, **qa),
        Q.Q5(fl=3, fk=2, **qa),
        Q.Compound((Q.Q3(**qa), Q.Q1(fi=2, x0=5, x1=mx - 3)), ("and",),
                   count=True),
        Q.Compound((Q.Q3(**qa), Q.Q1(fi=2, x0=5, x1=mx - 3)), ("or",)),
    ]
    f = ObliviousForest.random(12, 4, 5, 8, seed=1)
    fh = s.load_forest(f, name="f")
    X = np.random.default_rng(2).integers(0, 256, (33, 5))
    want_pred = s.predict(fh, X).result
    want = [s.query(h, q).result for q in jobs]
    tracing.reset_counters()
    with _profile() as prof:
        got = [s.query(h, q).result for q in jobs]
        pred = s.predict(fh, X).result
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(pred, want_pred)
    scan = ["pud.resolve", "pud.launch"]
    assert _trees(prof) == [
        ("pud.query", scan + ["pud.bitmap"]),                   # Q1
        ("pud.query", scan + ["pud.count"]),                    # Q3
        ("pud.query", scan + ["pud.bitmap", "pud.finish"]),     # Q4
        ("pud.query", scan + ["pud.bitmap", "pud.finish"]       # Q5
         + scan + ["pud.count"]),
        ("pud.query", scan + ["pud.count"]),                    # compound
        ("pud.query", scan + ["pud.bitmap"]),                   # compound
        ("pud.predict", ["pud.resolve", "pud.launch", "pud.assemble"]),
    ]
    spans = tracing.profiled()
    assert {k: v["count"] for k, v in spans.items()} == {
        "pud.query": 6, "pud.predict": 1, "pud.resolve": 8,
        "pud.launch": 8, "pud.bitmap": 4, "pud.count": 3,
        "pud.finish": 2, "pud.assemble": 1}
    children = sum(v["total_s"] for k, v in spans.items()
                   if k not in OUTER)
    outer = sum(spans[k]["total_s"] for k in OUTER)
    assert 0 < children < outer


def test_resolution_counters_match_closed_form():
    """Two columns: 8 bits, and 4 bits (past its max of 15 the lt-side
    saturates, one lookup).  Per query, (lookups, Algorithm 1 runs): Q3
    on column 0 (4, 3: its two ranges share the lt scalar 255 - 100);
    the same Q1 range again, from the range cache (2, 0); Q1 on column
    1 past its max (1, 1); Q1 on column 1 below it (2, 1: the lt scalar
    15 - 12 is the scalar just resolved); a compound of two ranges
    already asked (3, 0).  Nothing is counted with no profiler."""
    rng = np.random.default_rng(0)
    table = Table(n_bits=8, features=[
        rng.integers(0, 256, 700).astype(np.uint64),
        rng.integers(0, 16, 700).astype(np.uint64)])
    ex = FusedTableExec(table, num_shards=1, num_chunks=2, device="cpu",
                        plans=(ColumnPlan(8, 2), ColumnPlan(4, 2)))
    batch = [q.to_tuple() for q in (
        Q.Q3(fi=0, x0=10, x1=100, fj=0, y0=20, y1=100),
        Q.Q1(fi=0, x0=10, x1=100),
        Q.Q1(fi=1, x0=3, x1=200),
        Q.Q1(fi=1, x0=10, x1=12),
        Q.Compound((Q.Q1(fi=0, x0=20, x1=100), Q.Q1(fi=1, x0=3, x1=200)),
                   ("or",), count=True))]
    _resolve_scalar_cached.cache_clear()

    def resolved():
        got = tracing.counters()
        return (got.get("resolve.lookups"), got.get("resolve.computed"))

    with _profile():
        with tracing.span("pud.query"):
            want = ex.run(batch)
    assert resolved() == (12, 5)
    # with no profiler: the same answers, nothing counted
    _resolve_scalar_cached.cache_clear()
    ex._idx_cache.clear()
    for g, w in zip(ex.run(batch), want):
        np.testing.assert_array_equal(g, w)
    assert resolved() == (12, 5)
    # the whole batch again: every range from the cache
    with _profile():
        ex.run(batch)
    assert resolved() == (24, 5)


def test_machine_backend_load_spans_keep_their_names():
    rng = np.random.default_rng(1)
    table = Table(n_bits=8, features=[
        rng.integers(0, 256, 300).astype(np.uint64) for _ in range(2)])
    s = PudSession(device="cpu")
    with _profile() as prof:
        h = s.create_table(table, name="m")
        s.query(h, Q.Q1(fi=0, x0=10, x1=200))
    names = {e.name for e in prof.events()}
    assert {"PudQueryEngine.shard", "load_vector.extract",
            "load_vector.encode", "pud.query"} <= names
    # a machine job runs no fused step
    assert {n for n in names if n.startswith("pud.")} == {"pud.query"}
