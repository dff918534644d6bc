"""The PuD serving stack: ``repro_torch.serve`` against ``repro.serve``.

Both packages serve one data set: 256 records of 8 features at 8 bits
over 2 devices, and a forest of 4 trees of depth 3.  The reference runs
its machine session (its fused backend needs ``pl.load``, which the
installed JAX lacks); the port runs ``PudSession(device="cpu")``, every
kernel's plain version.

* Arrivals: the same seed gives the same arrivals (times, classes,
  rids, deadlines, query tuples, instances); trace files are byte-equal
  and each package loads the other's.
* Admission: the same offers and takes give the same rid order and the
  same shed texts.
* Flush: the same results, rid handling and error texts; the port's
  attribution (the reference's fused contract) sums back to the job's
  measured wall-clock.
* The loop: both sessions wrapped so that every job reports one fixed
  ``wallclock_ns`` computed from its query kinds and instance count
  (``stats`` None, the fused contract); the two ``ServingLoop``\\ s then
  give the same records, splits, probes and report, and the same result
  for every request that completed.

Tolerances: none (exact equality) for integers, results, copied floats
(arrival times, deadlines, attributed latencies, clock readings) and
texts; ``rel=1e-12`` where attributed shares are summed back to a
wall-clock (two roundings of an float64 product).
"""

import json

import numpy as np
import pytest
import torch

from repro.apps.gbdt import ObliviousForest as JForest
from repro.pud import queries as JQ
from repro.pud.session import JobResult as JJob
from repro.pud.session import PudSession as JSession
from repro.serve import admission as JA
from repro.serve import arrivals as JArr
from repro.serve import batcher as JB
from repro.serve import loop as JL
from repro.serve import pud_service as JS
from repro_torch import convert
from repro_torch.apps.predicate import Table
from repro_torch.pud import PudSession
from repro_torch.pud import queries as TQ
from repro_torch.pud.session import JobResult as TJob
from repro_torch.serve import admission as TA
from repro_torch.serve import arrivals as TArr
from repro_torch.serve import batcher as TB
from repro_torch.serve import loop as TL
from repro_torch.serve import pud_service as TS

N_BITS = 8
COLS = 4096
JPKG = dict(Q=JQ, A=JA, Arr=JArr, B=JB, L=JL, S=JS, Job=JJob)
TPKG = dict(Q=TQ, A=TA, Arr=TArr, B=TB, L=TL, S=TS, Job=TJob)


def _data(n=256, f=8, seed=0):
    return np.random.default_rng(seed).integers(0, 2 ** N_BITS, (n, f))


def _table():
    d = _data()
    return Table(N_BITS, [np.ascontiguousarray(d[:, f], dtype=np.uint64)
                          for f in range(d.shape[1])])


@pytest.fixture(scope="module")
def sessions():
    """(reference machine session, port CPU session), each holding the
    table "events" and the forest "rank"."""
    forest = JForest.random(num_trees=4, depth=3, num_features=8,
                            n_bits=N_BITS, seed=0)
    js = JSession(num_devices=2, verify="off")
    js.create_table(_data(), name="events", n_bits=N_BITS,
                    cols_per_bank=COLS)
    js.load_forest(forest, name="rank")
    ts = PudSession(backend="fused", num_devices=2, device="cpu")
    ts.create_table(_data(), name="events", n_bits=N_BITS)
    ts.load_forest(convert.forest(forest.feature_idx, forest.thresholds,
                                  forest.leaves, forest.n_bits,
                                  forest.num_features), name="rank")
    return js, ts


def _same_result(got, want):
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert type(got) is type(want) and got == want, (got, want)


# --------------------------------------------------------------------- #
# (a) Arrivals
# --------------------------------------------------------------------- #
def _mix(P, deadline_ns=2e6, **kw):
    Arr = P["Arr"]
    return Arr.WorkloadMix(
        table="events", forest="rank", predict_frac=0.25, predict_batch=4,
        classes=(Arr.ClassSpec("interactive", weight=4.0, share=0.5,
                               deadline_ns=deadline_ns),
                 Arr.ClassSpec("batch", weight=1.0, share=0.5)), **kw)


def _fields(a):
    req = a.request
    return (a.arrive_ns, a.cls, a.rid, a.deadline_abs_ns, req.deadline_ns,
            req.resource_name,
            None if req.query is None else req.query.to_tuple(),
            None if req.X is None else np.asarray(req.X).tolist())


GENERATORS = [
    ("poisson_arrivals", dict(rate_rps=10_000, n=48, seed=42)),
    ("poisson_arrivals", dict(rate_rps=3e5, n=24, seed=5, start_ns=17.5,
                              rid_base=1_000)),
    ("bursty_arrivals", dict(rate_rps=10_000, n=48, seed=7, on_ns=1e6,
                             off_ns=1e6, burst_factor=4.0)),
    ("bursty_arrivals", dict(rate_rps=2e5, n=32, seed=21, on_ns=4e5,
                             off_ns=7e5, burst_factor=3.0, rid_base=9)),
]


@pytest.mark.parametrize("gen,kw", GENERATORS,
                         ids=[f"{g}-{k['seed']}" for g, k in GENERATORS])
def test_arrivals_equal_the_reference_float_for_float(gen, kw):
    want = getattr(JArr, gen)(_mix(JPKG), **kw)
    got = getattr(TArr, gen)(_mix(TPKG), **kw)
    assert len(got) == len(want) == kw["n"]
    for g, w in zip(got, want):
        assert _fields(g) == _fields(w)
    kinds = {g.request.query.to_tuple()[0] for g in got
             if g.request.query is not None}
    assert len(kinds) >= 4 and any(g.request.X is not None for g in got)


def test_trace_files_are_byte_equal_and_load_across_packages(tmp_path):
    kw = dict(rate_rps=10_000, n=24, seed=3)
    jarr = JArr.poisson_arrivals(_mix(JPKG), **kw)
    tarr = TArr.poisson_arrivals(_mix(TPKG), **kw)
    jpath, tpath = tmp_path / "ref.jsonl", tmp_path / "port.jsonl"
    JArr.save_trace(str(jpath), jarr)
    TArr.save_trace(str(tpath), tarr)
    assert tpath.read_bytes() == jpath.read_bytes()
    t_from_j = TArr.load_trace(str(jpath))
    j_from_t = JArr.load_trace(str(tpath))
    assert [_fields(a) for a in t_from_j] == [_fields(a) for a in tarr]
    assert [_fields(a) for a in j_from_t] == [_fields(a) for a in jarr]
    assert all(isinstance(a.request, TS.PudRequest) for a in t_from_j)


def _every_kind(Q):
    return [Q.Q1(0, 1, 2), Q.Q2(0, 1, 2, 3, 4, 5), Q.Q3(0, 1, 2, 3, 4, 5),
            Q.Q4(0, 1, 2, 3, 4, 5, 6), Q.Q5(0, 1, 2, 3, 4, 5, 6, 7),
            Q.Compound((Q.Q1(0, 1, 2), Q.Q3(1, 2, 3, 4, 5, 6)), ("or",),
                       count=True, merge="dram"),
            Q.Compound((Q.Q2(0, 1, 2, 3, 4, 5), Q.Q1(2, 0, 9),
                        Q.Q3(1, 2, 3, 4, 5, 6)), ("and", "or"),
                       merge="host")]


def test_query_from_tuple_round_trips_every_kind():
    for tq, jq in zip(_every_kind(TQ), _every_kind(JQ)):
        assert TArr.query_from_tuple(tq.to_tuple()) == tq
        assert TArr.query_from_tuple(jq.to_tuple()) == tq
        # as a JSON trace carries it: lists, not tuples
        wire = json.loads(json.dumps(tq.to_tuple()))
        assert TArr.query_from_tuple(wire) == tq
        assert JArr.query_from_tuple(wire).to_tuple() == tq.to_tuple()
    with pytest.raises(ValueError, match="unknown query tuple"):
        TArr.query_from_tuple(("q9", 1))


# --------------------------------------------------------------------- #
# (b) Admission
# --------------------------------------------------------------------- #
def _arrival(P, rid, cls, t=0.0, deadline=None):
    return P["Arr"].Arrival(arrive_ns=t, cls=cls, request=P["S"].PudRequest(
        rid=rid, resource="events", query=P["Q"].Q1(0, 10, 200),
        deadline_ns=deadline))


def _admission_trace(P, seed):
    """Random offers and takes against a 3-class controller; returns
    each step's outcome (shed text or None, taken rids) and the
    counters."""
    Arr = P["Arr"]
    adm = P["A"].AdmissionController(
        (Arr.ClassSpec("hot", weight=3.0), Arr.ClassSpec("warm", weight=2.0),
         Arr.ClassSpec("cold", weight=1.0)),
        capacity=6, starvation_bound=3)
    rng = np.random.default_rng(seed)
    out, t = [], 0.0
    for rid in range(200):
        if rng.random() < 0.6:
            t += float(rng.exponential(10.0))
            cls = ("hot", "warm", "cold")[int(rng.integers(0, 3))]
            shed = adm.offer(_arrival(P, rid, cls, t))
            out.append(None if shed is None else
                       (shed.rid, shed.ok, shed.error, shed.latency_ns))
        else:
            out.append([a.rid for a in adm.take(int(rng.integers(1, 5)))])
    return out, (adm.admitted, adm.shed, adm.depth)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_admission_matches_reference_offer_for_offer(seed):
    got, got_counts = _admission_trace(TPKG, seed)
    want, want_counts = _admission_trace(JPKG, seed)
    assert got == want and got_counts == want_counts
    assert any(o and isinstance(o, tuple) for o in got)       # some shed


def test_admission_weighted_shares_and_fifo_within_class():
    adm = TA.AdmissionController(
        (TArr.ClassSpec("hot", weight=3.0), TArr.ClassSpec("cold", weight=1.0)),
        capacity=64, starvation_bound=100)
    for i in range(8):
        adm.offer(_arrival(TPKG, i, "hot", t=i))
        adm.offer(_arrival(TPKG, 100 + i, "cold", t=i))
    taken = adm.take(8)
    hot = [a.rid for a in taken if a.cls == "hot"]
    cold = [a.rid for a in taken if a.cls == "cold"]
    # 3:1 weights -> 6 hot, 2 cold out of 8; FIFO inside each class
    assert len(hot) == 6 and len(cold) == 2
    assert hot == sorted(hot) and cold == sorted(cold)


def test_admission_starvation_bound():
    adm = TA.AdmissionController(
        (TArr.ClassSpec("hot", weight=100.0),
         TArr.ClassSpec("cold", weight=1.0)),
        capacity=64, starvation_bound=3)
    for i in range(10):
        adm.offer(_arrival(TPKG, i, "hot", t=i))
    adm.offer(_arrival(TPKG, 99, "cold", t=0.5))
    taken = adm.take(6)
    # despite the 100:1 weight, cold's head is served within the bound
    cold_pos = [k for k, a in enumerate(taken) if a.cls == "cold"]
    assert cold_pos and cold_pos[0] <= 3


def test_admission_sheds_with_explicit_429():
    adm = TA.AdmissionController((TArr.ClassSpec("only"),), capacity=2)
    assert adm.offer(_arrival(TPKG, 1, "only")) is None
    assert adm.offer(_arrival(TPKG, 2, "only")) is None
    shed = adm.offer(_arrival(TPKG, 3, "only"))
    assert shed is not None and not shed.ok and shed.rid == 3
    assert shed.error.startswith("429 ") and shed.stats is None
    assert adm.depth == 2 and adm.shed == 1 and adm.admitted == 2
    taken = adm.take(10)
    assert [a.rid for a in taken] == [1, 2] and adm.depth == 0
    with pytest.raises(KeyError, match="unknown priority class"):
        adm.offer(_arrival(TPKG, 4, "nope"))


# --------------------------------------------------------------------- #
# (c) PudService.flush
# --------------------------------------------------------------------- #
def _flush_requests(P):
    Q, S = P["Q"], P["S"]
    rng = np.random.default_rng(1)
    qa = dict(fi=0, x0=30, x1=130, fj=1, y0=60, y1=190)
    queries = [Q.Q1(0, 10, 200), Q.Q2(**qa), Q.Q3(**qa), Q.Q4(fk=2, **qa),
               Q.Q5(fl=3, fk=2, **qa),
               Q.Compound((Q.Q1(4, 20, 230), Q.Q3(**qa)), ("and",),
                          merge="dram"),
               Q.Compound((Q.Q1(6, 0, 16), Q.Q2(**qa), Q.Q3(**qa)),
                          ("or", "and"), count=True, merge="dram")]
    reqs = [S.PudRequest(rid=10 + i, resource="events", query=q)
            for i, q in enumerate(queries)]
    # predicts interleaved with the queries: each group keeps its order
    reqs.insert(2, S.PudRequest(rid=1, resource="rank",
                                X=rng.integers(0, 256, (5, 8))))
    reqs.insert(5, S.PudRequest(rid=2, resource="rank",
                                X=rng.integers(0, 256, (40, 8))))
    return reqs


def test_flush_results_equal_the_reference(sessions):
    js, ts = sessions
    jsvc, tsvc = JS.PudService(js), TS.PudService(ts)
    for r in _flush_requests(JPKG):
        jsvc.submit(r)
    for r in _flush_requests(TPKG):
        tsvc.submit(r)
    assert tsvc.queue_depth == jsvc.queue_depth == 9
    want, got = jsvc.flush(), tsvc.flush()
    assert tsvc.queue_depth == 0
    assert [r.rid for r in got] == [r.rid for r in want]
    for g, w in zip(got, want):
        assert (g.ok, g.error, g.batch_size) == (w.ok, w.error, w.batch_size)
        _same_result(g.result, w.result)
        assert g.stats is None and g.latency_ns > 0
    assert [r.batch_size for r in got] == [7, 7, 2, 7, 7, 2, 7, 7, 7]
    assert [len(r.result) for r in got if r.rid in (1, 2)] == [5, 40]
    tab = _table()
    for r, req in zip(got, _flush_requests(TPKG)):
        if req.query is not None:
            assert req.query.check(tab, r.result)


def test_submit_after_cancel_reuses_rid(sessions):
    svc = TS.PudService(sessions[1])
    svc.submit(TS.PudRequest(rid=7, resource="events",
                             query=TQ.Q1(0, 10, 200)))
    assert svc.queue_depth == 1
    assert svc.cancel(7)
    assert svc.queue_depth == 0
    # the rid is free again immediately
    svc.submit(TS.PudRequest(rid=7, resource="events",
                             query=TQ.Q1(1, 10, 200)))
    with pytest.raises(ValueError, match="duplicate request id 7"):
        svc.submit(TS.PudRequest(rid=7, resource="events",
                                 query=TQ.Q1(2, 10, 200)))
    assert svc.queue_depth == 1
    rs = svc.flush()
    assert [r.rid for r in rs] == [7] and rs[0].ok
    _same_result(rs[0].result, TQ.Q1(1, 10, 200).reference(_table()))
    assert svc.queue_depth == 0
    # and free again after the flush retired it
    svc.submit(TS.PudRequest(rid=7, resource="events",
                             query=TQ.Q1(0, 10, 200)))
    assert svc.cancel(7) and not svc.cancel(7)


def test_interleaved_submit_cancel_flush_accounting(sessions):
    svc = TS.PudService(sessions[1])
    for rid in range(4):
        svc.submit(TS.PudRequest(rid=rid, resource="events",
                                 query=TQ.Q1(rid % 8, 10, 200)))
    svc.cancel(1)
    svc.cancel(3)
    svc.submit(TS.PudRequest(rid=1, resource="events",
                             query=TQ.Q1(5, 20, 210)))
    assert svc.queue_depth == 3
    rs = svc.flush()
    assert [r.rid for r in rs] == [0, 2, 1]     # arrival order kept
    assert all(r.ok and r.batch_size == 3 for r in rs)
    assert svc.queue_depth == 0


def _error_text(fn):
    try:
        fn()
    except (KeyError, TypeError) as e:
        return type(e), str(e)
    raise AssertionError("no error raised")


def test_failed_flush_keeps_queue_and_errors_match_reference(sessions):
    js, ts = sessions
    jsvc, tsvc = JS.PudService(js), TS.PudService(ts)
    for svc, P in ((jsvc, JPKG), (tsvc, TPKG)):
        svc.submit(P["S"].PudRequest(rid=1, resource="events",
                                     query=P["Q"].Q1(0, 10, 200)))
        svc.submit(P["S"].PudRequest(rid=2, resource="nope",
                                     query=P["Q"].Q1(0, 10, 200)))
    got = _error_text(tsvc.flush)
    assert got[0] is KeyError and got == _error_text(jsvc.flush)
    assert tsvc.queue_depth == 2
    assert tsvc.cancel(2)
    rs = tsvc.flush()
    assert [r.rid for r in rs] == [1] and rs[0].ok
    # a query against a forest, a predict against a table
    for name, kind in (("rank", "query"), ("events", "predict")):
        got = _error_text(lambda: tsvc._handle(name, kind))
        assert got[0] is TypeError
        assert got == _error_text(lambda: jsvc._handle(name, kind))
    assert ts.resource_kind("nope") is None
    assert (ts.resource_kind("events"), ts.resource_kind("rank")) == \
        ("table", "forest")


def test_attribution_sums_to_the_batch_wallclock(sessions):
    """The fused contract: a query batch shares the measured wall-clock
    evenly, a predict batch in proportion to instance counts, and the
    shares sum to ``last_job.wallclock_ns``."""
    svc = TS.PudService(sessions[1])
    for rid in range(3):
        svc.submit(TS.PudRequest(rid=rid, resource="events",
                                 query=TQ.Q1(rid, 10, 200)))
    rs = svc.flush()
    wall = svc.last_job.wallclock_ns
    assert wall > 0 and all(r.latency_ns == wall / 3 for r in rs)
    assert sum(r.latency_ns for r in rs) == pytest.approx(wall, rel=1e-12)
    rng = np.random.default_rng(2)
    svc.submit(TS.PudRequest(rid=1, resource="rank",
                             X=rng.integers(0, 256, (10, 8))))
    svc.submit(TS.PudRequest(rid=2, resource="rank",
                             X=rng.integers(0, 256, (30, 8))))
    rp = svc.flush()
    wall = svc.last_job.wallclock_ns
    assert [r.latency_ns for r in rp] == [wall * 10 / 40, wall * 30 / 40]
    assert sum(r.latency_ns for r in rp) == pytest.approx(wall, rel=1e-12)
    assert rp[1].latency_ns == pytest.approx(3 * rp[0].latency_ns,
                                             rel=1e-12)


def test_serving_stack_refuses_the_cpu_unless_asked(monkeypatch):
    """No fallback: without CUDA and without ``device="cpu"`` the
    session a service needs cannot be made."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TS.PudService(PudSession(backend="fused"))


# --------------------------------------------------------------------- #
# (d) The loop, record for record
# --------------------------------------------------------------------- #
# a job's wall-clock in ns: the sum of its queries' costs, or a fixed
# cost plus one per instance
QUERY_NS = {"q1": 1_000.0, "q2": 1_500.0, "q3": 1_200.0, "q4": 6_000.0,
            "q5": 11_000.0, "compound": 2_500.0}
PREDICT_NS, INSTANCE_NS = 2_000.0, 250.0
# the benchmark's probe batch (Q1, Q2, Q3, Q5) and what follows from it
M_PROBE = QUERY_NS["q1"] + QUERY_NS["q2"] + QUERY_NS["q3"] + QUERY_NS["q5"]
CAP_RPS = 4 / (M_PROBE / 1e9)
MAX_BATCH = 6


class FixedCost:
    """A session whose jobs report a fixed wall-clock computed from their
    query kinds and instance count, with ``stats`` None (the fused
    contract); everything else is the wrapped session's."""

    def __init__(self, inner, job_cls):
        self.inner, self.job_cls = inner, job_cls

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def query(self, handle, queries):
        job = self.inner.query(handle, queries)
        wall = sum(QUERY_NS[q.to_tuple()[0]] for q in queries)
        return self.job_cls(result=job.result, wallclock_ns=wall)

    def predict(self, handle, X):
        job = self.inner.predict(handle, X)
        wall = PREDICT_NS + INSTANCE_NS * np.asarray(X).shape[0]
        return self.job_cls(result=job.result, wallclock_ns=wall)


def _recording(batcher_cls):
    class Recording(batcher_cls):
        """A batcher that keeps every committed response by rid."""

        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.committed = {}

        def dispatch(self, handle, kind, reqs):
            out = super().dispatch(handle, kind, reqs)
            self.committed.update((r.rid, r) for r in out.responses)
            return out

    return Recording


def _classes(P, deadline_ns):
    Arr = P["Arr"]
    return (Arr.ClassSpec("interactive", weight=4.0, deadline_ns=deadline_ns),
            Arr.ClassSpec("bulk", weight=1.0))


def _arrivals(P, how, frac=0.5, seed=20, n=30, slo=1.0):
    """``serving_load.py``'s arrival shapes over the fixed costs:
    merged interactive + bulk Poisson or bursty arrivals at ``frac`` of
    the probed capacity (interactive deadline ``slo`` probe makespans),
    or synchronized burst cohorts."""
    Arr = P["Arr"]
    if how == "cohorts":
        tight = 0.2 * M_PROBE
        inter = Arr.WorkloadMix(table="events", kinds=("q1",),
                                classes=_classes(P, tight)[:1])
        bulk = Arr.WorkloadMix(table="events", kinds=("q5", "compound"),
                               classes=_classes(P, tight)[1:])
        rng = np.random.default_rng(seed)
        out = []
        for b in range(12):
            t0 = b * 4.0 * M_PROBE
            out += [inter.sample_request(rng, b * 100 + k, t0)
                    for k in range(4)]
            out += [bulk.sample_request(rng, b * 100 + 10 + k, t0)
                    for k in range(2)]
        return out, tight
    deadline = slo * M_PROBE
    inter = Arr.WorkloadMix(table="events", kinds=("q1", "q2", "q3"),
                            classes=_classes(P, deadline)[:1])
    bulk = Arr.WorkloadMix(table="events", forest="rank", predict_frac=0.3,
                           predict_batch=8, kinds=("q4", "q5", "compound"),
                           classes=_classes(P, deadline)[1:])
    rate = frac * CAP_RPS
    kw = {}
    gen = Arr.poisson_arrivals
    if how == "bursty":
        gen = Arr.bursty_arrivals
        kw = dict(on_ns=0.632 * M_PROBE, off_ns=0.632 * M_PROBE,
                  burst_factor=4.0)
    a = gen(inter, rate_rps=rate / 2, n=n, seed=seed, **kw)
    b = gen(bulk, rate_rps=rate / 2, n=n, seed=seed + 1, rid_base=100_000,
            **kw)
    return sorted(a + b, key=lambda x: x.arrive_ns), deadline


def _serve(P, session, how, split=True, **kw):
    arrivals, deadline = _arrivals(P, how, **kw)
    svc = P["S"].PudService(FixedCost(session, P["Job"]))
    batcher = _recording(P["B"].DeadlineBatcher)(svc, enabled=split)
    adm = P["A"].AdmissionController(
        _classes(P, deadline), capacity=4 * MAX_BATCH,
        starvation_bound=2 * MAX_BATCH)
    loop = P["L"].ServingLoop(svc, adm, batcher, max_batch=MAX_BATCH)
    return loop.run(arrivals), batcher.committed


def _record(r):
    return (r.rid, r.cls, r.arrive_ns, r.ok, r.error, r.start_ns,
            r.finish_ns, r.latency_ns)


RUNS = [("poisson", dict(frac=0.15, seed=20)),
        ("poisson", dict(frac=0.5, seed=21)),
        ("poisson", dict(frac=12.0, seed=22)),
        ("poisson", dict(frac=3.0, seed=23, slo=0.3)),
        ("bursty", dict(frac=0.5, seed=21)),
        ("cohorts", dict(split=True, seed=22)),
        ("cohorts", dict(split=False, seed=22))]


@pytest.mark.parametrize("how,kw", RUNS, ids=[
    f"{h}-{'-'.join(f'{k}{v}' for k, v in kw.items())}" for h, kw in RUNS])
def test_serving_loop_matches_reference_record_for_record(sessions, how,
                                                          kw):
    js, ts = sessions
    want, want_resp = _serve(JPKG, js, how, **kw)
    got, got_resp = _serve(TPKG, ts, how, **kw)
    assert [_record(r) for r in got.records] == \
        [_record(r) for r in want.records]
    assert (got.splits, got.probes, got.duration_ns) == \
        (want.splits, want.probes, want.duration_ns)
    assert json.dumps(got.to_json()) == json.dumps(want.to_json())
    assert got.decisions == want.decisions == []
    ok = [r.rid for r in got.records if r.ok]
    assert ok and set(ok) <= set(got_resp)
    for rid in ok:
        g, w = got_resp[rid], want_resp[rid]
        assert (g.latency_ns, g.batch_size) == (w.latency_ns, w.batch_size)
        _same_result(g.result, w.result)
    # every failure says why; every unexecuted request is a 429
    assert all(r.error for r in got.records if not r.ok)
    assert all(r.error.startswith("429 ") for r in got.records
               if r.start_ns is None)
    if got.completed >= 2:
        assert got.p99_ns >= got.p50_ns > 0
    if how == "poisson" and kw["frac"] > 1:
        assert got.shed > 0                   # over capacity: it sheds
    if kw.get("slo", 1.0) < 1:
        # a tight SLO under overload: budgets expire in the queue (shed
        # unexecuted) and the batcher splits to save the rest
        assert got.splits > 0 and any(
            "expired before batch start" in (r.error or "")
            for r in got.records)
    if how == "cohorts":
        # splitting saves the tight-deadline members that ride behind a
        # Q5; without it they fail in their batch
        if kw["split"]:
            assert got.splits > 0 and got.probes > got.splits
        else:
            assert got.splits == 0 and any(
                "deadline exceeded" in (r.error or "") for r in got.records)


def _pressed_batch(P):
    """A Q5 whose cost delays its batch-mates: a tight-deadline Q1 and a
    ``merge="dram"`` Compound that only survive a split."""
    Q, S = P["Q"], P["S"]
    return [
        S.PudRequest(rid=1, resource="events",
                     query=Q.Q5(1, 2, 3, 10, 200, 4, 20, 220)),
        S.PudRequest(rid=2, resource="events", query=Q.Q1(0, 10, 200),
                     deadline_ns=1_000.0),
        S.PudRequest(rid=3, resource="events",
                     query=Q.Compound((Q.Q1(0, 10, 200),
                                       Q.Q3(1, 5, 100, 2, 50, 150)),
                                      ("and",), count=True, merge="dram"),
                     deadline_ns=4_000.0),
    ]


@pytest.mark.parametrize("split", [False, True])
def test_batcher_dispatch_matches_reference(sessions, split):
    outs = []
    for P, session in ((JPKG, sessions[0]), (TPKG, sessions[1])):
        svc = P["S"].PudService(FixedCost(session, P["Job"]))
        b = P["B"].DeadlineBatcher(svc, enabled=split)
        outs.append(b.dispatch(svc._handle("events", "query"), "query",
                               _pressed_batch(P)))
    want, got = outs
    assert (got.makespan_ns, got.splits, got.probes, len(got.jobs)) == \
        (want.makespan_ns, want.splits, want.probes, len(want.jobs))
    for g, w in zip(got.responses, want.responses):
        assert (g.rid, g.ok, g.error, g.latency_ns, g.batch_size) == \
            (w.rid, w.ok, w.error, w.latency_ns, w.batch_size)
        _same_result(g.result, w.result)
    if split:
        assert [r.ok for r in got.responses] == [True, True, True]
        assert got.splits >= 1 and got.responses[1].latency_ns <= 1_000.0
        assert _pressed_batch(TPKG)[2].query.check(_table(),
                                                   got.responses[2].result)
    else:
        assert [r.ok for r in got.responses] == [True, False, False]
        assert all("deadline exceeded" in r.error
                   for r in got.responses if not r.ok)


@pytest.mark.parametrize("n,max_depth", [(5, 3), (16, 3), (16, 1), (7, 2)])
def test_batcher_halves_an_all_late_batch_as_the_reference(sessions, n,
                                                           max_depth):
    """Every member late together: the batch halves, earlier half first,
    down to ``max_depth``; outcomes equal the reference's."""
    outs = []
    for P, session in ((JPKG, sessions[0]), (TPKG, sessions[1])):
        Q, S = P["Q"], P["S"]
        svc = S.PudService(FixedCost(session, P["Job"]))
        reqs = [S.PudRequest(rid=i, resource="events",
                             query=Q.Q1(i % 8, 10 + i, 200),
                             deadline_ns=900.0 + 150.0 * (i % 3))
                for i in range(n)]
        b = P["B"].DeadlineBatcher(svc, max_depth=max_depth)
        outs.append(b.dispatch(svc._handle("events", "query"), "query",
                               reqs))
    want, got = outs
    assert (got.makespan_ns, got.splits, got.probes, len(got.jobs)) == \
        (want.makespan_ns, want.splits, want.probes, len(want.jobs))
    assert got.splits > 0
    for g, w in zip(got.responses, want.responses):
        assert (g.rid, g.ok, g.error, g.latency_ns, g.batch_size) == \
            (w.rid, w.ok, w.error, w.latency_ns, w.batch_size)
        _same_result(g.result, w.result)


def _edge_arrivals(P):
    """Hand-placed arrivals: a deadline that ends exactly at its batch's
    start (dispatched with a zero budget), one that ends before it
    (shed), a flood past the admission capacity, and predicts of
    unequal sizes sharing one batch."""
    Arr, Q, S = P["Arr"], P["Q"], P["S"]
    rng = np.random.default_rng(4)

    def arrival(rid, t, cls, query=None, X=None, deadline=None):
        return Arr.Arrival(arrive_ns=t, cls=cls, request=S.PudRequest(
            rid=rid, resource="rank" if X is not None else "events",
            query=query, X=X, deadline_ns=deadline))

    q5 = Q.Q5(1, 2, 3, 10, 200, 4, 20, 220)
    out = [arrival(0, 0.0, "bulk", q5),
           # the Q5 alone holds the clock to 11,000 ns
           arrival(1, 100.0, "interactive", Q.Q1(0, 10, 200),
                   deadline=10_900.0),              # ends at the start
           arrival(2, 200.0, "interactive", Q.Q2(0, 5, 90, 1, 7, 250),
                   deadline=10_799.5),              # ends before it
           arrival(3, 300.0, "interactive", Q.Q3(2, 5, 90, 1, 7, 250),
                   deadline=50_000.0)]
    for k, b in enumerate((3, 7, 11, 5)):
        out.append(arrival(10 + k, 400.0 + k, "bulk",
                           X=rng.integers(0, 256, (b, 8))))
    out += [arrival(100 + k, 60_000.0 + k, "bulk",
                    Q.Q4(k % 8, 1, 10, 200, 2, 20, 240))
            for k in range(12)]
    return out


def test_serving_loop_edges_match_reference(sessions):
    reports = []
    for P, session in ((JPKG, sessions[0]), (TPKG, sessions[1])):
        svc = P["S"].PudService(FixedCost(session, P["Job"]))
        batcher = _recording(P["B"].DeadlineBatcher)(svc)
        adm = P["A"].AdmissionController(_classes(P, None), capacity=8,
                                         starvation_bound=2)
        rep = P["L"].ServingLoop(svc, adm, batcher, max_batch=8).run(
            _edge_arrivals(P))
        reports.append((rep, batcher.committed))
    (want, want_resp), (got, got_resp) = reports
    assert [_record(r) for r in got.records] == \
        [_record(r) for r in want.records]
    assert json.dumps(got.to_json()) == json.dumps(want.to_json())
    for rid, g in got_resp.items():
        w = want_resp[rid]
        assert (g.ok, g.latency_ns, g.batch_size) == \
            (w.ok, w.latency_ns, w.batch_size)
        _same_result(g.result, w.result)
    by_rid = {r.rid: r for r in got.records}
    assert by_rid[1].start_ns == 11_000.0 and not by_rid[1].ok
    assert by_rid[1].error.startswith("deadline exceeded")
    assert by_rid[2].start_ns is None and "expired" in by_rid[2].error
    assert sum(r.start_ns is None and "queue full" in r.error
               for r in got.records) == 3
    assert {got_resp[10 + k].batch_size for k in range(4)} == {4}
