"""The serving loop's fourth step on a machine session: the autoscaler,
the PL401 audit and the retirement of traces, ``repro_torch.serve``
against ``repro.serve``.

Counterparts of the reference's ``tests/test_serving.py`` cases
``test_serving_loop_retires_traces_after_dispatch``,
``test_serving_loop_audits_dispatches_for_pl401``,
``test_autoscaler_never_slower_than_best_static``,
``test_autoscaler_window_and_band_gate_reevaluation`` and
``test_autoscaler_evicts_cold_resources`` (the PL401 diagnostics and
the collector's serving records are in ``test_torch_pudlint.py``), plus
a loop that re-evaluates on every job.  Both packages serve 256 records
of 8 features at 8 bits and a forest of 4 trees of depth 3 on
``PudSession(num_devices=2)`` machine sessions, the port's with its bank
state on the CPU; both packages' host timers are pinned to one fake
clock (``pinned_clock``), so every comparison is exact: the loops'
records record for record, the audited requests, the autoscalers'
decisions field for field and each session's ``(host_lanes, hosts)``
after them.  The port's sessions run ``verify="strict"`` under the
port's trace sweep.
"""

import dataclasses

import numpy as np
import pytest

from repro.apps.gbdt import ObliviousForest as JForest
from repro.core import machine as j_machine
from repro.pud import queries as JQ
from repro.pud.session import PudSession as JSession
from repro.serve import admission as JA
from repro.serve import arrivals as JArr
from repro.serve import autoscaler as JAuto
from repro.serve import batcher as JB
from repro.serve import loop as JL
from repro.serve import pud_service as JS
from repro_torch.apps.gbdt import ObliviousForest as TForest
from repro_torch.core import machine as t_machine
from repro_torch.pud import queries as TQ
from repro_torch.pud.session import PudSession as TSession
from repro_torch.serve import admission as TA
from repro_torch.serve import arrivals as TArr
from repro_torch.serve import autoscaler as TAuto
from repro_torch.serve import batcher as TB
from repro_torch.serve import loop as TL
from repro_torch.serve import pud_service as TS
from test_torch_machine import pinned_clock  # noqa: F401  (a fixture)
from test_torch_pudlint import port_pudlint_sweep  # noqa: F401  (autouse)

N_BITS = 8
COLS = 4096
REF = dict(Q=JQ, A=JA, Arr=JArr, Auto=JAuto, B=JB, L=JL, S=JS,
           Session=JSession, Forest=JForest, machine=j_machine,
           kw={"verify": "off"})
PORT = dict(Q=TQ, A=TA, Arr=TArr, Auto=TAuto, B=TB, L=TL, S=TS,
            Session=TSession, Forest=TForest, machine=t_machine,
            kw={"device": "cpu"})
BOTH = (REF, PORT)


def _data(n=256, f=8, seed=0):
    return np.random.default_rng(seed).integers(0, 2 ** N_BITS, (n, f))


def _served(P, forest=True, tables=("events",), **kw):
    """A machine session holding the tables (and the forest "rank"),
    behind a ``PudService``."""
    sess = P["Session"](num_devices=kw.pop("num_devices", 2), **P["kw"])
    for name in tables:
        sess.create_table(_data(kw.get("records", 256)), name=name,
                          n_bits=N_BITS, cols_per_bank=COLS)
    if forest:
        sess.load_forest(P["Forest"].random(num_trees=4, depth=3,
                                            num_features=8, n_bits=N_BITS,
                                            seed=0), name="rank")
    return P["S"].PudService(sess)


def _mix(P):
    Arr = P["Arr"]
    return Arr.WorkloadMix(
        table="events", forest="rank", predict_frac=0.25, predict_batch=4,
        classes=(Arr.ClassSpec("interactive", weight=4.0, share=0.5,
                               deadline_ns=2e6),
                 Arr.ClassSpec("batch", weight=1.0, share=0.5)))


def _record(r):
    return (r.rid, r.cls, r.arrive_ns, r.ok, r.error, r.start_ns,
            r.finish_ns, r.latency_ns)


def _engines(svc, name):
    return svc.session.planner.ensure_ready(name).engines


def _serve(P, svc, n, seed, autoscaler=None):
    mix = _mix(P)
    arr = P["Arr"].poisson_arrivals(mix, rate_rps=20_000, n=n, seed=seed)
    adm = P["A"].AdmissionController(mix.classes, capacity=16)
    return P["L"].ServingLoop(svc, adm, P["B"].DeadlineBatcher(svc),
                              autoscaler=autoscaler).run(arr)


# --------------------------------------------------------------------- #
# The loop: traces retired, dispatches audited
# --------------------------------------------------------------------- #

def test_serving_loop_retires_traces_after_dispatch(pinned_clock):
    """Every dispatch ends with ``clear_traces`` on its resource: the
    records equal the reference's and every subarray's trace is empty
    afterwards in both packages."""
    svcs = [_served(P) for P in BOTH]
    reports = [_serve(P, svc, 10, 11) for P, svc in zip(BOTH, svcs)]
    assert any(r.start_ns is not None for r in reports[1].records)
    assert [_record(r) for r in reports[1].records] == \
        [_record(r) for r in reports[0].records]
    assert reports[1].to_json() == reports[0].to_json()
    assert reports[1].decisions == reports[0].decisions == []
    for svc in svcs:
        for name in ("events", "rank"):
            assert all(len(eng.sub.trace.entries) == 0
                       and not eng.sub.trace.host_events
                       for eng in _engines(svc, name))


def test_serving_loop_audits_dispatches_for_pl401(pinned_clock):
    """Every dispatched request reaches the collector of its package, the
    same records in both; a correct loop never dispatches a deadline
    that precedes its start, so the serving pass stays clean (the
    sweeps' drains would fail this test otherwise)."""
    from repro_torch.analysis import pudlint

    collectors = [P["machine"]._LINT_REGISTRY for P in BOTH]
    assert all(c is not None for c in collectors)  # both sweeps installed
    before = [len(c._serving) for c in collectors]
    svcs = [_served(P) for P in BOTH]
    for P, svc in zip(BOTH, svcs):
        _serve(P, svc, 6, 9)
    audited = [c._serving[b:] for c, b in zip(collectors, before)]
    assert audited[1], "dispatches must be audited"
    assert audited[1] == audited[0]
    assert {tuple(sorted(r)) for r in audited[1]} == \
        {("cls", "deadline_ns", "rid", "start_ns")}
    assert not pudlint.serving_admission_diags(audited[1])


# --------------------------------------------------------------------- #
# The autoscaler
# --------------------------------------------------------------------- #

def _decision(d):
    return dataclasses.astuple(d)


def _config(sess):
    return sess.sys_cfg.host_lanes, sess.hosts


def test_autoscaler_never_slower_than_best_static(pinned_clock):
    decisions = []
    for P in BOTH:
        svc = _served(P)
        sess = svc.session
        scaler = P["Auto"].UtilizationAutoscaler(
            sess, lane_options=(1, 2, 4), window=1,
            lo_util=0.0, hi_util=0.0)   # every observation triggers
        th = svc._handle("events", "query")
        svc.submit(P["S"].PudRequest(rid=1, resource="events",
                                     query=P["Q"].Q1(0, 10, 200)))
        svc.submit(P["S"].PudRequest(rid=2, resource="events",
                                     query=P["Q"].Q3(1, 5, 100, 2, 50, 150)))
        svc.flush()
        ex = sess.executor(th)
        decision = scaler.observe(ex, svc.last_job.timeline)
        assert decision is not None
        # argmin guarantee: the chosen config IS the best static one
        assert decision.predicted_ns <= decision.static_best_ns
        assert decision.predicted_ns <= decision.baseline_ns + 1e-6
        # the session adopted the decision
        assert _config(sess) == (decision.host_lanes, decision.hosts)
        # and the next scheduled job really achieves the prediction
        tl = ex.schedule(sess.sys_cfg)
        assert tl.makespan_ns == pytest.approx(decision.predicted_ns)
        assert scaler.decisions == [decision]
        decisions.append((_decision(decision), _config(sess),
                          tl.makespan_ns))
    assert decisions[1] == decisions[0]


def test_autoscaler_window_and_band_gate_reevaluation(pinned_clock):
    utils = []
    for P in BOTH:
        svc = _served(P)
        sess = svc.session
        scaler = P["Auto"].UtilizationAutoscaler(
            sess, window=3, lo_util=0.0, hi_util=1.0)  # band covers all
        th = svc._handle("events", "query")
        svc.submit(P["S"].PudRequest(rid=1, resource="events",
                                     query=P["Q"].Q1(0, 10, 200)))
        svc.flush()
        ex = sess.executor(th)
        tl = svc.last_job.timeline
        assert scaler.observe(ex, tl) is None      # window filling
        assert scaler.observe(ex, tl) is None
        assert scaler.observe(ex, tl) is None      # full, but in-band
        assert scaler.observe(ex, None) is None    # fused jobs: no signal
        assert scaler.decisions == []
        assert _config(sess) == (1, "shared")
        utils.append(tl.host_utilization)
    assert utils[1] == utils[0]
    with pytest.raises(ValueError, match="window must be >= 1"):
        TAuto.UtilizationAutoscaler(sess, window=0)


def test_autoscaler_evicts_cold_resources(pinned_clock):
    out = []
    for P in BOTH:
        svc = _served(P, forest=False, tables=("hot", "cold"),
                      num_devices=1, records=128)
        sess = svc.session
        scaler = P["Auto"].UtilizationAutoscaler(
            sess, lane_options=(1, 2), window=1, lo_util=0.0, hi_util=0.0,
            evict_idle=2)
        th = svc._handle("hot", "query")
        for rid in range(3):
            svc.submit(P["S"].PudRequest(rid=rid, resource="hot",
                                         query=P["Q"].Q1(0, 10, 200)))
            svc.flush()
            # one job a resource between retirements, as the loop does
            # (the sweeps lint whole traces)
            sess.clear_traces(th)
        decision = scaler.observe(sess.executor(th), svc.last_job.timeline)
        assert decision is not None and "cold" in decision.evicted
        assert sess.planner.resources["cold"].state == "evicted"
        assert sess.planner.resources["hot"].state == "ready"
        out.append((_decision(decision), _config(sess),
                    sess.planner_stats()))
    assert out[1] == out[0]


def test_serving_loop_with_autoscaler_matches_reference(pinned_clock):
    """The loop re-evaluating on every committed job (window 1, an empty
    band), as the chip smoke's phase 14 runs it: the same records, the
    same decisions in the report and on the scaler, and the sessions end
    on the same config; each decision is the argmin of its candidates."""
    runs = []
    for P in BOTH:
        svc = _served(P)
        scaler = P["Auto"].UtilizationAutoscaler(
            svc.session, lane_options=(1, 2, 4),
            host_options=("shared", "per-device"), window=1,
            lo_util=0.0, hi_util=0.0)
        rep = _serve(P, svc, 12, 5, autoscaler=scaler)
        assert rep.decisions == scaler.decisions
        runs.append((rep, scaler, svc.session))
    (want, jscaler, jsess), (got, scaler, sess) = runs
    assert got.decisions, "every committed job re-evaluates"
    assert [_record(r) for r in got.records] == \
        [_record(r) for r in want.records]
    assert [_decision(d) for d in got.decisions] == \
        [_decision(d) for d in want.decisions]
    assert all(d.predicted_ns <= d.static_best_ns for d in got.decisions)
    assert _config(sess) == _config(jsess)
    assert dataclasses.asdict(sess.sys_cfg) == \
        dataclasses.asdict(jsess.sys_cfg)
