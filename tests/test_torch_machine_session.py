"""``repro_torch.pud.PudSession(backend="machine", device="cpu")`` held
against the reference's ``repro.pud.PudSession()`` on the same seeded
data.

Both packages' host timers are pinned to one fake clock
(``pinned_clock``: every clock read advances 1 µs), so measured merge
times are equal and every comparison is exact: results bit for bit; job
timelines, ``stats`` and ``cost_summary`` float for float; traces entry
for entry; ``planner_stats`` through queue, admit, evict, reload,
defragment and drop.  The port's ``backend="fused"`` jobs (the kernels'
plain versions) must give the machine results, and a machine session's
fused layout must be its executor's ``fused_config()``.  Also: the
serving front end's machine-job attribution against the reference's,
and the three PuD examples run on the CPU.  Counterparts of the
reference's ``tests/test_pud_session.py``, ``test_host_lanes.py``,
``test_host_barrier.py``, ``test_indram_ops.py`` (the session half),
``test_scheduler.py`` (the pipelines) and ``test_system.py``.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_machine import (
    ARCHS,
    BOTH,
    PORT,
    REF,
    arch,
    forest,
    pin_clock,
    pinned_clock,  # noqa: F401  (a fixture)
    queries,
    same_result,
    stats_key,
    table,
    timeline_key,
    trace_key,
)
from test_torch_pudlint import port_pudlint_sweep  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]


def _sessions(name="modified", **kw):
    return [P.session.PudSession(arch=arch(P, name), **kw, **P.sess)
            for P in BOTH]


def _same_job(jobs):
    same_result(jobs[1].result, jobs[0].result)
    assert jobs[1].backend == jobs[0].backend == "machine"
    assert timeline_key(jobs[1].timeline) == timeline_key(jobs[0].timeline)
    assert stats_key(jobs[1].stats) == stats_key(jobs[0].stats)
    assert jobs[1].makespan_ns == jobs[0].makespan_ns


def _traces(session, handle):
    return [trace_key(e.sub.trace)
            for e in session.executor(handle).engines]


# ------------------------------ queries ------------------------------ #

@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("devices,hosts,lanes", [(1, "shared", 1),
                                                 (2, "shared", 2),
                                                 (2, "per-device", 2)],
                         ids=["1dev", "2dev-shared", "2dev-per-device"])
def test_query_batch_matches_reference_session(pinned_clock, name, devices,
                                               hosts, lanes):
    """Q1-Q5 and compounds merged in the banks and on the host, one
    batch: results equal the reference's and NumPy's, timelines, stats,
    traces and cost summaries float for float; the port's fused job on
    the same session gives the same results."""
    ss = _sessions(name, num_devices=devices, hosts=hosts)
    for s in ss:
        s.set_host_lanes(lanes)
    hs = [s.create_table(table(P), name="t") for P, s in zip(BOTH, ss)]
    jobs = [s.query(h, queries(P)) for P, s, h in zip(BOTH, ss, hs)]
    _same_job(jobs)
    t = table(PORT)
    for q, got in zip(queries(PORT), jobs[1].result):
        assert q.check(t, got)
    assert _traces(ss[1], hs[1]) == _traces(ss[0], hs[0])
    assert ss[1].cost_summary() == ss[0].cost_summary()
    assert timeline_key(ss[1].schedule()) == timeline_key(ss[0].schedule())
    fused = ss[1].query(hs[1], queries(PORT), backend="fused")
    assert fused.backend == "fused" and fused.stats is None
    same_result(fused.result, jobs[1].result)
    ex = [s.executor(h) for s, h in zip(ss, hs)]
    assert ex[1].last_wave_owners == ex[0].last_wave_owners
    assert ex[1].num_shards == 2 * devices


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("q", range(9))
def test_single_query_jobs_match_reference_session(pinned_clock, name, q):
    """Each query alone (Q5's host barrier as the whole job, a compound
    merged in the banks or on the host) on two devices, bit-serial
    engines for the range queries."""
    method = "bitserial" if q < 3 else "clutch"
    ss = _sessions(name, num_devices=2)
    hs = [s.create_table(table(P, records=1500), name="t", method=method)
          for P, s in zip(BOTH, ss)]
    jobs = [s.query(h, queries(P)[q]) for P, s, h in zip(BOTH, ss, hs)]
    _same_job(jobs)
    assert queries(PORT)[q].check(table(PORT, records=1500),
                                  jobs[1].result)
    if method == "bitserial":
        with pytest.raises(TypeError, match="clutch method only"):
            ss[1].query(hs[1], queries(PORT)[q], backend="fused")


Q5_BATCHES = {"only": [4], "first": [4, 0, 1], "last": [2, 3, 4],
              "back-to-back": [4, 4, 6, 4]}


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("where", list(Q5_BATCHES))
def test_q5_host_barrier_in_a_batch_matches_reference(pinned_clock, name,
                                                      where):
    """Q5's phase-2 wave waits on its phase-1 merge's root join (a host
    barrier) wherever it sits in a batch: the job's waves, owners and
    root joins as the reference's."""
    ss = _sessions(name, num_devices=2)
    hs = [s.create_table(table(P, records=1200), name="t")
          for P, s in zip(BOTH, ss)]
    jobs = [s.query(h, [queries(P)[i] for i in Q5_BATCHES[where]])
            for P, s, h in zip(BOTH, ss, hs)]
    _same_job(jobs)
    ex = [s.executor(h) for s, h in zip(ss, hs)]
    assert ex[1].last_wave_owners == ex[0].last_wave_owners
    assert ex[1].last_wave_owners.count(Q5_BATCHES[where].index(4)) == 2
    roots = [h for h in jobs[1].timeline.host_spans if h.label.endswith(":h")]
    assert len(roots) == len(ex[1].last_wave_owners)


@pytest.mark.parametrize("name", ARCHS)
def test_auto_representation_on_the_machine_matches_reference(
        pinned_clock, name):
    data = np.stack([np.random.default_rng(1).integers(0, 13, 900),
                     np.random.default_rng(2).integers(0, 220, 900),
                     np.random.default_rng(3).integers(0, 3500, 900)],
                    axis=1).astype(np.uint64)
    ss = _sessions(name, num_devices=2)
    hs = [s.create_table(data, n_bits=12, name="t", representation="auto")
          for s in ss]
    Q = [P.queries for P in BOTH]
    batch = [[Qm.Q1(fi=0, x0=2, x1=4000), Qm.Q3(fi=1, x0=0, x1=50, fj=2,
                                                 y0=100, y1=3000)]
             for Qm in Q]
    _same_job([s.query(h, b) for s, h, b in zip(ss, hs, batch)])
    assert hs[1].representation == hs[0].representation
    for s, h in zip(ss, hs):
        s.recode_column(h, 2, n_bits=12, num_chunks=4)
    assert [h.status for h in hs] == ["evicted", "evicted"]
    _same_job([s.query(h, b) for s, h, b in zip(ss, hs, batch)])
    assert ss[1].planner_stats() == ss[0].planner_stats()


# ------------------------------ predict ------------------------------ #

@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("replicate,hosts,lanes", [("rowclone", "shared", 1),
                                                   ("host", "shared", 2),
                                                   ("rowclone", "per-device",
                                                    3)],
                         ids=["rowclone", "host", "rowclone-per-device"])
def test_predict_matches_reference_session(pinned_clock, name, replicate,
                                           hosts, lanes):
    """Forest replicas on two devices, cloned in-DRAM or loaded from the
    host; a batch over several waves with a ragged last one: predictions
    bit-equal to the reference's and to ``assemble_leaves``, timelines,
    stats and traces equal; the fused job's predictions equal."""
    ss = _sessions(name, num_devices=2, hosts=hosts)
    for s in ss:
        s.set_host_lanes(lanes)
    fs = [forest(P) for P in BOTH]
    hs = [s.load_forest(f, name="f", replicate=replicate)
          for s, f in zip(ss, fs)]
    X = np.random.default_rng(3).integers(0, 256, (37, 4), dtype=np.uint64)
    jobs = [s.predict(h, X) for s, h in zip(ss, hs)]
    _same_job(jobs)
    addrs = np.ascontiguousarray(PORT.gbdt.reference_leaf_addrs(fs[1], X))
    np.testing.assert_array_equal(
        jobs[1].result, PORT.gbdt.assemble_leaves(fs[1].leaves, addrs))
    assert _traces(ss[1], hs[1]) == _traces(ss[0], hs[0])
    ex = ss[1].executor(hs[1])
    assert ex.wave_width == ss[0].executor(hs[0]).wave_width == 16
    np.testing.assert_array_equal(
        ss[1].predict(hs[1], X, backend="fused").result, jobs[1].result)
    assert ss[1].cost_summary() == ss[0].cost_summary()
    empty = [s.predict(h, X[:0]) for s, h in zip(ss, hs)]
    _same_job(empty)


@pytest.mark.parametrize("mra", [1, 4])
def test_forest_replication_matches_reference(pinned_clock, mra):
    """Four replicas a device, two a channel: with ``"rowclone"`` each
    channel's second replica clones the first in-DRAM (MRACT spans
    under the PULSAR capability), with ``"host"`` every replica loads
    over the pins; the streams, write counts and predictions equal the
    reference's, and cloning writes less."""
    import dataclasses

    ss = [P.session.PudSession(
        sys_cfg=dataclasses.replace(P.cost.DESKTOP, multi_row_act=mra),
        num_devices=1, **P.sess) for P in BOTH]
    X = np.random.default_rng(5).integers(0, 256, (20, 4), dtype=np.uint64)
    writes = {}
    for rep in ("rowclone", "host"):
        hs = [s.load_forest(forest(P), name=rep, groups_per_device=4,
                            banks_per_group=2, replicate=rep)
              for P, s in zip(BOTH, ss)]
        assert _traces(ss[1], hs[1]) == _traces(ss[0], hs[0])
        counts = [e.sub.trace.counts()
                  for e in ss[1].executor(hs[1]).engines]
        writes[rep] = sum(c.get("write", 0) for c in counts)
        if rep == "rowclone":
            clone = "mract" if mra > 1 else "rowclone"
            assert sum(c.get(clone, 0) for c in counts) > 0
        _same_job([s.predict(h, X) for s, h in zip(ss, hs)])
        for s, h in zip(ss, hs):
            s.drop(h)
    assert writes["rowclone"] < writes["host"]


@pytest.mark.parametrize("channels", ["auto", "spread", 0, [1, 0]],
                         ids=["auto", "spread", "ch0", "ch1-ch0"])
def test_table_placement_policies_match_reference(pinned_clock, channels):
    """Shards placed round-robin, spread, on one channel or on a list:
    the placements, the job and the cost summary equal the reference's;
    the scheduled time lies between the overlap and serial bounds."""
    ss = _sessions(num_devices=1)
    hs = [s.create_table(table(P, records=9000), name="t",
                         channels=channels, cols_per_bank=4096)
          for P, s in zip(BOTH, ss)]
    for (d0, sub0), (d1, sub1) in zip(ss[0].executor(hs[0]).placements,
                                      ss[1].executor(hs[1]).placements):
        g = [next(g for g in d.groups if g.sub is sub)
             for d, sub in ((d0, sub0), (d1, sub1))]
        assert g[1].banks == g[0].banks
    _same_job([s.query(h, queries(P)[:3]) for P, s, h in zip(BOTH, ss, hs)])
    cs = [s.cost_summary() for s in ss]
    assert cs[1] == cs[0]
    dev = cs[1]["devices"][0]
    assert dev["time_overlap_ns"] <= dev["time_scheduled_ns"] <= \
        dev["time_serial_ns"]


def test_set_hosts_repoints_ready_executors_as_the_reference(pinned_clock):
    ss = _sessions(num_devices=2)
    hs = [s.create_table(table(P, records=800), name="t")
          for P, s in zip(BOTH, ss)]
    for s in ss:
        s.set_hosts("per-device")
        s.set_host_lanes(4)
    assert all(s.executor(h).hosts == "per-device" for s, h in zip(ss, hs))
    _same_job([s.query(h, queries(P)[4]) for P, s, h in zip(BOTH, ss, hs)])
    for s in ss:
        with pytest.raises(ValueError, match="hosts must be"):
            s.set_hosts("bogus")
        with pytest.raises(ValueError, match="host_lanes"):
            s.set_host_lanes(0)


def test_clear_traces_matches_reference(pinned_clock):
    ss = _sessions(num_devices=1)
    hs = [s.create_table(table(P, records=600), name="t")
          for P, s in zip(BOTH, ss)]
    for s, h in zip(ss, hs):
        s.clear_traces(h)
    assert _traces(ss[1], hs[1]) == _traces(ss[0], hs[0])
    assert all(e.sub.trace.entries == []
               for e in ss[1].executor(hs[1]).engines)
    _same_job([s.query(h, queries(P)[1]) for P, s, h in zip(BOTH, ss, hs)])
    assert ss[1].cost_summary() == ss[0].cost_summary()


# ------------------------------ planner ------------------------------ #

def _tiny(P, backend="machine"):
    """A one-channel fleet of 8 banks of 4,096 columns."""
    cfg = P.cost.SystemConfig(
        name="tiny", bandwidth_gbps=10.0, channels=1, ranks_per_channel=1,
        banks_per_rank=8, cols_per_bank=4096, host_power_w=5.0,
        host_idle_power_w=1.0)
    kw = dict(P.sess, backend=backend) if P is PORT else P.sess
    return P.session.PudSession(sys_cfg=cfg, num_devices=1, **kw)


def test_planner_lifecycle_matches_reference(pinned_clock):
    """On 8 banks: a pinned table (2 banks), a second (4), a 7-bank
    table that cannot fit even by eviction (queued) and a 1-bank one
    queued behind it (FIFO); dropping the pinned one admits both by a
    defragmentation and an eviction; reloading the evicted one evicts
    the cold ones; an explicit evict and reload.  After every step the
    statuses, ``planner_stats`` and job results equal the
    reference's."""
    ss = [_tiny(P) for P in BOTH]

    def step(fn):
        out = [fn(P, s, i) for i, (P, s) in enumerate(zip(BOTH, ss))]
        assert ss[1].planner_stats() == ss[0].planner_stats()
        return out

    def t(P, n):
        return table(P, records=n, features=6)

    a = step(lambda P, s, i: s.create_table(t(P, 4000), name="a",
                                            pinned=True))
    b = step(lambda P, s, i: s.create_table(t(P, 16000), name="b"))
    c = step(lambda P, s, i: s.create_table(t(P, 28000), name="c",
                                            shards_per_device=1))
    d = step(lambda P, s, i: s.create_table(t(P, 500), name="d",
                                            shards_per_device=1))
    assert [h.status for h in c + d] == ["queued"] * 4
    assert ss[1].planner_stats()["queued"] == ["c", "d"]
    for P, s, h in zip(BOTH, ss, d):
        with pytest.raises(RuntimeError, match="queued for capacity"):
            s.query(h, queries(P)[0])
    step(lambda P, s, i: s.drop(a[i]))
    assert [h.status for h in b + c + d] == ["evicted"] * 2 + ["ready"] * 4
    st_ = ss[1].planner_stats()
    # one more eviction from c's first attempt, rolled back
    assert st_["defrag_banks_moved"] == 4 and st_["evictions"] == 2
    _same_job(step(lambda P, s, i: s.query(c[i], queries(P)[:5])))
    _same_job(step(lambda P, s, i: s.query(b[i], queries(P)[5:7])))
    assert [h.status for h in b + c + d] == ["ready"] * 2 + \
        ["evicted"] * 4
    assert ss[1].planner.cold_resources() == ss[0].planner.cold_resources()
    step(lambda P, s, i: s.evict(b[i]))
    _same_job(step(lambda P, s, i: s.query(b[i], queries(P)[2])))
    assert ss[1].cost_summary() == ss[0].cost_summary()
    for h in (b, c, d):
        step(lambda P, s, i: s.drop(h[i]))
    assert ss[1].planner_stats()["resources"] == {}
    with pytest.raises(KeyError):
        ss[1].drop(b[1])


def test_session_errors_match_reference():
    ss = _sessions(num_devices=1)
    hs = [s.create_table(table(P, records=300), name="t")
          for P, s in zip(BOTH, ss)]
    fh = [s.load_forest(forest(P), name="f") for P, s in zip(BOTH, ss)]
    for P, s, h, f in zip(BOTH, ss, hs, fh):
        with pytest.raises(TypeError, match="is a table, not a forest"):
            s.predict(h, np.zeros((1, 4), np.uint64))
        with pytest.raises(TypeError, match="is a forest, not a table"):
            s.query(f, queries(P)[0])
        with pytest.raises(ValueError, match="backend must be"):
            P.session.PudSession(backend="bogus", **P.sess)
        with pytest.raises(ValueError, match="hosts must be"):
            P.session.PudSession(hosts="bogus", **P.sess)
        with pytest.raises(ValueError, match="representation"):
            s.create_table(table(P), representation="auto",
                           method="bitserial")
        s.drop(h)
        assert h.status == "dropped"
        with pytest.raises(KeyError):
            s.query(h, queries(P)[0])


@pytest.mark.parametrize("name", ARCHS)
def test_fused_layout_is_the_machine_executors_fused_config(name):
    """A machine session's fused jobs build from ``fused_config()``; a
    fused session lays the same resource out without the planner, with
    the same shards and chunks; per-column plans and forests alike."""
    for kw in ({}, {"representation": "auto"}):
        ms = PORT.session.PudSession(arch=arch(PORT, name), num_devices=2,
                                     device="cpu")
        fs = PORT.session.PudSession(arch=arch(PORT, name), num_devices=2,
                                     backend="fused", device="cpu")
        t = table(PORT, records=700, n_bits=8)
        mh, fh = ms.create_table(t, name="t", **kw), \
            fs.create_table(t, name="t", **kw)
        cfg = ms.executor(mh).fused_config()
        ms.query(mh, queries(PORT)[0], backend="fused")
        fx = [ms._fused["t"], fs.executor(fh)]
        for x in fx:
            assert (x.num_shards, x.plan.num_chunks) == \
                (cfg["num_shards"], cfg["num_chunks"])
            assert x.plans == cfg.get("plans", x.plans)
            assert x.plans == fx[0].plans
        f = forest(PORT)
        mfh, ffh = ms.load_forest(f, name="f", **kw), \
            fs.load_forest(f, name="f", **kw)
        cfg = ms.executor(mfh).fused_config()
        ms.predict(mfh, np.zeros((2, 4), np.uint64), backend="fused")
        fx = [ms._fused["f"], fs.executor(ffh)]
        for x in fx:
            assert x.num_chunks == cfg["num_chunks"]
            assert x.plan == fx[0].plan


def test_fused_session_admits_to_the_planner_at_its_first_machine_job(
        pinned_clock):
    """A fused session lays a table out with no bank capacity; a
    machine job admits it then: equal to the reference's session, or
    the reference's queued text when the fleet cannot hold it."""
    fs = PORT.session.PudSession(num_devices=1, backend="fused",
                                 device="cpu")
    h = fs.create_table(table(PORT), name="t")
    assert h.status == "ready" and "t" not in fs.planner.resources
    js = REF.session.PudSession(num_devices=1, verify="off")
    jh = js.create_table(table(REF), name="t")
    _same_job([js.query(jh, queries(REF)[:5]),
               fs.query(h, queries(PORT)[:5], backend="machine")])
    assert fs.planner.resources["t"].state == "ready"
    tiny = _tiny(PORT, backend="fused")
    big = tiny.create_table(table(PORT, records=40000), name="big")
    assert big.status == "ready"
    with pytest.raises(RuntimeError, match="queued for capacity"):
        tiny.query(big, queries(PORT)[0], backend="machine")
    assert big.status == "ready"
    tiny.drop(big)
    assert tiny.planner_stats()["resources"] == {}
    fs.evict(h)
    assert h.status == "evicted" and \
        fs.planner.resources["t"].state == "evicted"
    same_result(fs.query(h, queries(PORT)[0]).result,
                queries(PORT)[0].reference(table(PORT)))


def test_power_up_seeds_do_not_change_results(monkeypatch):
    """Results and timelines never depend on the power-up draw: two
    seeds, equal jobs."""
    jobs = []
    for seed in (0, 11):
        pin_clock(monkeypatch)
        s = PORT.session.PudSession(num_devices=2, seed=seed, device="cpu")
        h = s.create_table(table(PORT, records=900), name="t")
        f = s.load_forest(forest(PORT), name="f")
        jobs.append((s.query(h, queries(PORT)), s.predict(
            f, np.random.default_rng(1).integers(0, 256, (9, 4)))))
    for a, b in zip(*jobs):
        same_result(a.result, b.result)
        assert stats_key(a.stats) == stats_key(b.stats)
    assert not np.array_equal(
        PORT.session.PudSession(seed=0, device="cpu").devices[0]
        .alloc_banks(1).state.numpy(),
        PORT.session.PudSession(seed=11, device="cpu").devices[0]
        .alloc_banks(1).state.numpy())


# ------------------------- serving attribution ------------------------- #

def test_service_attribution_of_a_machine_job_matches_reference(
        pinned_clock):
    """A query batch and a predict batch through both packages'
    ``PudService``: per-request latencies float for float (queries
    through ``last_wave_owners``, predicts through ``wave_width``),
    stats on every response; the port's recorded jobs attributed by
    the reference's service give the port's latencies."""
    ss = _sessions(num_devices=2)
    for P, s in zip(BOTH, ss):
        s.create_table(table(P), name="events")
        s.load_forest(forest(P), name="rank")
    svcs = [P.service.PudService(s) for P, s in zip(BOTH, ss)]
    X = np.random.default_rng(4).integers(0, 256, (40, 4), dtype=np.uint64)
    spans = ((0, 3), (3, 20), (20, 21), (21, 40))
    outs, jobs = [[], []], [[], []]
    for kind in ("query", "predict"):
        for i, (P, svc) in enumerate(zip(BOTH, svcs)):
            if kind == "query":
                for rid, q in enumerate(queries(P)):
                    svc.submit(P.service.PudRequest(rid=rid,
                                                    resource="events",
                                                    query=q))
            else:
                for rid, (lo, hi) in enumerate(spans):
                    svc.submit(P.service.PudRequest(rid=100 + rid,
                                                    resource="rank",
                                                    X=X[lo:hi]))
            outs[i] += svc.flush()
            jobs[i].append(svc.last_job)
    for a, b in zip(*outs):
        assert (b.rid, b.latency_ns, b.batch_size, b.ok) == \
            (a.rid, a.latency_ns, a.batch_size, a.ok)
        same_result(b.result, a.result)
        assert stats_key(b.stats) == stats_key(a.stats)
    hq = REF.session.TableHandle(name="events", session=ss[0])
    hp = REF.session.ForestHandle(name="rank", session=ss[0])
    n = len(queries(PORT))
    assert svcs[0]._query_latencies(hq, jobs[1][0], n) == \
        [r.latency_ns for r in outs[1][:n]]
    assert svcs[0]._predict_latencies(hp, jobs[1][1],
                                      [hi - lo for lo, hi in spans]) == \
        [r.latency_ns for r in outs[1][n:]]
    assert len({r.latency_ns for r in outs[1][:n]}) > 1


# ------------------------------ examples ------------------------------ #

def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["torch_quickstart", "torch_predicate_eval",
                                  "torch_gbdt_inference"])
def test_pud_examples_run_on_the_cpu(name, capsys, monkeypatch):
    """The three PuD examples' ``main()`` on the CPU, small: each checks
    its machine and fused results against NumPy itself and prints the
    modeled ``stats``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert _example(name).main(["--device", "cpu", "--small"]) == 0
    assert "makespan" in capsys.readouterr().out
