"""``repro_torch.analysis`` (pudlint and its seeded-mutation harness)
held against the reference's ``repro.analysis`` on the CPU.

Counterparts of the reference's ``tests/test_pudlint.py``.  The port's
subarrays live on the CPU (``device="cpu"``); every report is compared
through ``LintReport.to_json()``, which must be equal (codes, severities,
messages, groups, waves, segments, rows, order):

* the unmutated baselines lint clean in both packages;
* each seeded violation is flagged with its expected code, and the
  port's report equals the reference's for the same mutation;
* diagnostic formatting and JSON, the three ``enforce`` modes,
  ``Timeline.verify`` and ``PudSession(verify=...)`` on a tampered job;
* a random single edit of a valid trace is behaviour-preserving under
  the port's ``replay`` or flagged, and reported as the reference
  reports it; random edits of the seeded streams likewise;
* the ``TraceCollector`` lints a subarray's trace when the subarray dies
  without keeping its state alive, and drains PL401 records once.

This file also defines :func:`port_pudlint_sweep`, the port's
counterpart of the reference conftest's sweep, which the port's
machine-recording test files import (an autouse fixture is active in
every module that holds it).  Tolerances: none, every comparison is
exact.
"""

import dataclasses
import functools
import gc
import weakref

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.analysis import mutations as JM
from repro.analysis import pudlint as JL
from repro.core import machine as j_machine
from repro_torch.analysis import mutations as TM
from repro_torch.analysis import pudlint as TL
from repro_torch.core import machine as t_machine
from repro_torch.pud.session import PudSession as TSession

CPU = "cpu"


@pytest.fixture(autouse=True)
def port_pudlint_sweep(request):
    """Lint every command trace the port records during a test.

    Every port ``BankedSubarray`` built during the test registers in
    ``repro_torch.core.machine._LINT_REGISTRY``; at teardown each
    survivor's trace is linted (the dead were linted when they died) and
    error-severity diagnostics, PL401 serving records included, fail the
    test.  Port sessions built without an explicit ``verify=`` run
    strict.  ``@pytest.mark.pudlint_skip`` opts a test out, as it does
    of the reference's sweep."""
    if request.node.get_closest_marker("pudlint_skip"):
        yield
        return
    collector = TL.TraceCollector()
    t_machine._LINT_REGISTRY = collector
    old_default = TSession.DEFAULT_VERIFY
    TSession.DEFAULT_VERIFY = "strict"
    try:
        yield
        report = collector.drain()
        if report.errors:
            pytest.fail("pudlint found errors in the port's recorded "
                        "traces:\n" + report.summary(limit=12),
                        pytrace=False)
    finally:
        t_machine._LINT_REGISTRY = None
        TSession.DEFAULT_VERIFY = old_default


# the tests below record invalid traces on purpose (both sweeps skip them)
pytestmark = pytest.mark.pudlint_skip

NAMES = (list(JM.STREAM_VIOLATIONS) + list(JM.TIMELINE_VIOLATIONS)
         + ["clone-across-channels", "stale-recode-planes"])


@functools.lru_cache(maxsize=None)
def _violations() -> tuple:
    """``(name, code, reference report, port report)`` of every seeded
    violation, computed once."""
    return tuple((jn, jc, jr, tr) for (jn, jc, jr), (tn, tc, tr) in zip(
        JM.seeded_violations(), TM.seeded_violations(CPU), strict=True)
        if (jn, jc) == (tn, tc))


def _same(got, want) -> None:
    assert got.to_json() == want.to_json()
    assert [str(d) for d in got.diagnostics] == \
        [str(d) for d in want.diagnostics]


# --------------------------------------------------------------------- #
# Non-vacuity: baselines clean, every seeded class caught
# --------------------------------------------------------------------- #

def test_baselines_lint_clean_and_equal_the_reference():
    want = JM.baseline_reports()
    got = TM.baseline_reports(CPU)
    assert list(got) == list(want)
    for name, report in got.items():
        assert report.ok and not report.diagnostics, \
            f"{name}: {report.summary()}"
        _same(report, want[name])


@pytest.mark.parametrize("name", NAMES)
def test_seeded_violation_detected_as_the_reference(name):
    found = {v[0]: v for v in _violations()}
    assert len(found) == len(NAMES)
    _, code, want, got = found[name]
    assert code in got.codes(), (
        f"{name}: expected {code}, got {sorted(got.codes())} "
        f"-- {got.summary()}")
    _same(got, want)


def test_enough_distinct_violation_classes():
    codes = {v[1] for v in _violations()}
    assert len(_violations()) >= 8
    assert len(codes) >= 8


def test_self_test_summary_equals_the_reference():
    got = TM.self_test(CPU)
    assert got == JM.self_test()
    assert got["classes"] == len(NAMES)
    assert got["distinct_codes"] >= 8


def test_recorders_raise_without_cuda_unless_a_device_is_named(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for rec in (TM.record_good, TM.record_plain, TM.record_read_then_reuse,
                TM.record_write_then_rewrite):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            rec()
        assert rec(device=CPU).state.device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TM.self_test()


# --------------------------------------------------------------------- #
# Diagnostics & report plumbing
# --------------------------------------------------------------------- #

def test_diagnostic_formatting_and_json():
    report = TL.lint_stream(TM.mut_row_oob(TM.stream_of(
        TM.record_good(device=CPU))))
    d = next(iter(report.diagnostics))
    assert d.code in TL.CODES
    assert d.code in str(d)
    js = report.to_json()
    assert js["errors"] == len(report.errors)
    assert all("code" in row for row in js["diagnostics"])
    assert TL.CODES == JL.CODES
    want = JL.lint_stream(JM.mut_row_oob(JM.stream_of(JM.record_good())))
    _same(report, want)
    assert report.summary(limit=1) == want.summary(limit=1)


def test_enforce_modes():
    report = TL.lint_stream(TM.mut_row_oob(TM.stream_of(
        TM.record_good(device=CPU))))
    with pytest.raises(TL.PudLintError) as err:
        TL.enforce(report, "strict", where="here")
    assert err.value.report is report
    want = JL.lint_stream(JM.mut_row_oob(JM.stream_of(JM.record_good())))
    with pytest.raises(JL.PudLintError) as ref_err:
        JL.enforce(want, "strict", where="here")
    assert str(err.value) == str(ref_err.value)
    with pytest.warns(UserWarning):
        TL.enforce(report, "warn")
    assert TL.enforce(report, "off") is report
    with pytest.raises(ValueError, match="verify mode must be"):
        TL.enforce(report, "loud")
    clean = TL.LintReport()
    assert TL.enforce(clean, "strict") is clean


def test_timeline_verify_method():
    from repro.core.scheduler import ChannelScheduler as JSched
    from repro_torch.core.scheduler import ChannelScheduler as TSched

    streams = [TM.stream_of(TM.record_good(device=CPU), "g0"),
               TM.stream_of(TM.record_plain(device=CPU), "g1")]
    tl = TSched(TM.SYS_CFG).schedule(streams)
    assert tl.verify(sys_cfg=TM.SYS_CFG, streams=streams).ok
    bad = TM.mut_clone_io(tl, streams)
    with pytest.raises(TL.PudLintError) as err:
        bad.verify(sys_cfg=TM.SYS_CFG, streams=streams)
    jstreams = [JM.stream_of(JM.record_good(), "g0"),
                JM.stream_of(JM.record_plain(), "g1")]
    jbad = JM.mut_clone_io(JSched(JM.SYS_CFG).schedule(jstreams), jstreams)
    with pytest.raises(JL.PudLintError) as ref_err:
        jbad.verify(sys_cfg=JM.SYS_CFG, streams=jstreams)
    _same(err.value.report, ref_err.value.report)
    assert str(err.value) == str(ref_err.value)
    assert not bad.verify(sys_cfg=TM.SYS_CFG, streams=streams,
                          mode="off").ok


def test_session_strict_flags_corrupt_job(monkeypatch):
    """A session job whose scheduled timeline is tampered with raises
    under ``verify="strict"`` with the reference's report, and passes
    under ``verify="off"``; a clean job passes strict."""
    from test_torch_machine import BOTH, pin_clock

    def run(P, verify):
        dev = P.device.PuDDevice(P.machine.PuDArch.MODIFIED, channels=1,
                                 ranks_per_channel=1, banks_per_rank=8,
                                 num_rows=1024, cols_per_bank=4096, **P.dev)
        s = P.session.PudSession(sys_cfg=P.cost.DESKTOP, devices=[dev],
                                 verify=verify, **P.dev)
        h = s.create_table(P.predicate.Table.generate(4096, 8, seed=0),
                           cols_per_bank=4096)
        return s.query(h, P.queries.Q1(fi=0, x0=10, x1=120))

    pin_clock(monkeypatch)
    assert run(BOTH[1], "strict").result is not None

    def corrupting(real_lint):
        def corrupt_lint(timeline, sys_cfg=None, streams=None):
            k = next(i for i, w in enumerate(timeline.waves)
                     if w.io_bytes == 0.0)
            timeline.waves[k] = dataclasses.replace(
                timeline.waves[k], end_ns=timeline.waves[k].start_ns)
            return real_lint(timeline, sys_cfg=sys_cfg, streams=streams)
        return corrupt_lint

    errors = []
    for P, lint in zip(BOTH, (JL, TL)):
        pin_clock(monkeypatch)
        monkeypatch.setattr(lint, "lint_timeline",
                            corrupting(lint.lint_timeline))
        with pytest.raises(lint.PudLintError) as err:
            run(P, "strict")
        errors.append(err.value)
        run(P, "off")                           # off never raises
    assert errors[1].report.codes() == {"PL304"}
    _same(errors[1].report, errors[0].report)
    assert str(errors[1]) == str(errors[0])


def test_session_verify_argument_checks_as_the_reference():
    from repro.pud.session import PudSession as JSession

    msgs = []
    for cls, kw in ((JSession, {}), (TSession, {"device": CPU})):
        with pytest.raises(ValueError) as err:
            cls(verify="loud", **kw)
        msgs.append(str(err.value))
        assert cls(verify="warn", **kw).verify == "warn"
    assert msgs[0] == msgs[1]
    assert TSession.DEFAULT_VERIFY == "off"
    assert TSession(device=CPU).verify == "off"


# --------------------------------------------------------------------- #
# Property: single-edit mutations are behaviour-preserving or flagged
# --------------------------------------------------------------------- #

def _record_linear(sub, rng):
    """A short random-but-valid straight-line program on rows 0..5.
    Returns the state after the host loads (WRITE payloads are not
    recorded in traces, so replay needs the pre-compute state)."""
    data = rng.integers(0, 2**32, size=(3, sub.num_words), dtype=np.uint32)
    sub.alloc(6)
    sub.host_write_rows(0, data)
    snapshot = sub.state.copy() if isinstance(sub.state, np.ndarray) \
        else sub.state.clone()
    sub.maj3_into_acc(0, 1, 2)
    sub.rowcopy(sub.G[0], 3)
    sub.ambit_or(0, 1, 4)
    sub.host_read_row(3)
    sub.host_read_row(4)
    return snapshot


def _replay_observables(template, snapshot, entries):
    sub = t_machine.BankedSubarray(
        num_banks=template.num_banks, num_rows=template.num_rows,
        num_cols=template.num_cols, arch=template.arch, device=CPU)
    sub.state[:] = snapshot
    reads = []
    t_machine.replay(entries, sub, reads=reads)
    return [np.asarray(r).copy() for r in reads]


def _edit(M, stream, entries, kind):
    """One single edit of a recorded stream (and of its entries, for the
    replay), in either package's terms."""
    PuDOp = type(stream.ops[0])
    if kind == "retarget-read":
        # a compute read of a never-written row: never preserving
        # (power-up content is random), so pudlint must flag it
        w = next(i for i, o in enumerate(stream.ops) if o is PuDOp.ROWCOPY)
        if entries is not None:
            e = entries[w]
            entries[w] = dataclasses.replace(e, rows=(30, e.rows[1]))
        return w, M._set_rows(stream, w, (30, stream.rows[w][1]))
    if kind == "copy-to-clone":
        # ROWCOPY -> ROWCLONE moves the same data by another transport
        w = next(i for i, o in enumerate(stream.ops) if o is PuDOp.ROWCOPY)
        if entries is not None:
            entries[w] = dataclasses.replace(entries[w], op=PuDOp.ROWCLONE)
        ops = stream.ops[:w] + (PuDOp.ROWCLONE,) + stream.ops[w + 1:]
        return w, dataclasses.replace(stream, ops=ops)
    # duplicate a host READ: pure observation
    w = next(i for i, o in enumerate(stream.ops) if o is PuDOp.READ)
    if entries is not None:
        entries.insert(w, entries[w])
    return w, M._insert_wave(stream, w, PuDOp.READ, stream.rows[w],
                             stream.segs[w])


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2**16), data=st.data())
def test_single_edit_mutation_preserving_or_flagged(seed, data):
    kw = dict(num_banks=2, num_rows=64, num_cols=64, seed=seed)
    rec = t_machine.BankedSubarray(arch=t_machine.PuDArch.UNMODIFIED,
                                   device=CPU, **kw)
    ref = j_machine.BankedSubarray(arch=j_machine.PuDArch.UNMODIFIED, **kw)
    snapshot = _record_linear(rec, np.random.default_rng(seed))
    _record_linear(ref, np.random.default_rng(seed))
    entries = list(rec.trace.entries)
    stream = TM.stream_of(rec)
    assert TL.lint_stream(stream).ok

    kind = data.draw(st.sampled_from(
        ["retarget-read", "copy-to-clone", "oversize-noop"]))
    w, mutated = _edit(TM, stream, entries, kind)
    report = TL.lint_stream(mutated)
    _, ref_mutated = _edit(JM, JM.stream_of(ref), None, kind)
    _same(report, JL.lint_stream(ref_mutated))

    base_reads = _replay_observables(rec, snapshot, rec.trace.entries)
    try:
        mut_reads = _replay_observables(rec, snapshot, entries)
    except Exception:
        assert not report.ok, (
            f"{kind}: replay rejects the mutant but pudlint passed it")
        return
    # the mutant may add observations (a duplicated READ), but every
    # original observation must still appear, in order
    it = iter(mut_reads)
    preserved = all(any(np.array_equal(b, m) for m in it)
                    for b in base_reads)
    assert preserved or not report.ok, (
        f"{kind} at wave {w}: mutation changes replay observables "
        f"yet pudlint found nothing")


def _draw_edit(data) -> dict:
    return {"kind": data.draw(st.sampled_from(
                ["retarget", "delete", "duplicate", "edge", "arch", "move"])),
            "wave": data.draw(st.integers(0, 200)),
            "operand": data.draw(st.integers(0, 3)),
            "row": data.draw(st.integers(0, 70)),
            "seg": data.draw(st.integers(0, 20)),
            "drop": data.draw(st.integers(0, 20)),
            "add": data.draw(st.lists(st.integers(0, 8), max_size=2))}


def _random_edit(M, stream, draw):
    """One random single edit of a seeded stream, described by plain
    values drawn once (so both packages receive the same edit)."""
    n = len(stream.ops)
    kind = draw["kind"]
    w = draw["wave"] % n
    if kind == "retarget":
        rows = stream.rows[w]
        k = draw["operand"] % len(rows)
        new = list(rows)
        new[k] = draw["row"]
        return M._set_rows(stream, w, tuple(new))
    if kind == "delete":
        return M._del_wave(stream, w)
    if kind == "duplicate":
        return M._insert_wave(stream, w, stream.ops[w], stream.rows[w],
                              stream.segs[w])
    if kind == "edge":
        sid = draw["seg"] % len(stream.segments)
        after = tuple(d for d in stream.segments[sid].after
                      if d != draw["drop"] % len(stream.segments))
        return M._set_after(stream, sid, after + tuple(draw["add"]))
    if kind == "arch":
        return M.mut_wrong_arch(stream)
    # move a wave into another segment
    sid = draw["seg"] % len(stream.segments)
    return dataclasses.replace(
        stream, segs=stream.segs[:w] + (sid,) + stream.segs[w + 1:])


@settings(max_examples=60, deadline=None)
@given(which=st.sampled_from(["record_good", "record_plain",
                              "record_read_then_reuse",
                              "record_write_then_rewrite"]),
       data=st.data())
def test_random_single_edits_report_as_the_reference(which, data):
    """Random single edits of the seeded streams (operand retargets in
    and out of range, deleted, duplicated and moved waves, rewired
    dependency edges, the wrong arch): equal reports, also when an edit
    makes a cycle or a dangling reference."""
    draw = _draw_edit(data)
    got = TL.lint_stream(_random_edit(
        TM, TM.stream_of(getattr(TM, which)(device=CPU)), draw))
    want = JL.lint_stream(_random_edit(
        JM, JM.stream_of(getattr(JM, which)()), draw))
    _same(got, want)


def test_replay_collects_reads():
    kw = dict(num_banks=2, num_rows=64, num_cols=64,
              arch=t_machine.PuDArch.UNMODIFIED, seed=11, device=CPU)
    rec = t_machine.BankedSubarray(**kw)
    fresh = t_machine.BankedSubarray(**kw)
    rec.alloc(2)
    rec.host_write_row(0, np.arange(rec.num_words, dtype=np.uint32))
    fresh.state[:] = rec.state          # WRITE payloads are not replayed
    rec.rowcopy(0, 1)
    rec.host_read_row(1)
    reads = []
    t_machine.replay(rec.trace.entries, fresh, reads=reads)
    assert len(reads) == 1
    assert np.array_equal(np.asarray(reads[0])[0],
                          np.arange(rec.num_words, dtype=np.uint32))


# --------------------------------------------------------------------- #
# The collector
# --------------------------------------------------------------------- #

def test_trace_collector_lints_at_death_without_keeping_state(monkeypatch):
    """A registered subarray is linted when it dies, as the reference's
    collector lints it; the finalizer keeps its trace, never its state
    tensor; ``drain`` lints the survivors and reports each once."""
    collector = TL.TraceCollector()
    ref_collector = JL.TraceCollector()
    monkeypatch.setattr(t_machine, "_LINT_REGISTRY", collector)
    monkeypatch.setattr(j_machine, "_LINT_REGISTRY", ref_collector)
    dead = TM.record_good(device=CPU)
    JM.record_good()
    state = weakref.ref(dead.state)
    # a bad trace on a survivor: an Ambit merge result lands in ROW_ZERO
    alive = TM.record_plain(device=CPU)
    alive.and_wave(0, 1, alive.ROW_ZERO)
    ref_alive = JM.record_plain()
    ref_alive.and_wave(0, 1, ref_alive.ROW_ZERO)
    assert collector.count == ref_collector.count == 2
    del dead
    gc.collect()
    assert state() is None, "the finalizer kept the state tensor alive"
    assert len(collector._reports) == 1 and collector._reports[0].ok
    got, want = collector.drain(), ref_collector.drain()
    assert got.codes() == {"PL102"}
    _same(got, want)
    assert collector.drain().ok and not collector.drain().diagnostics


def test_trace_collector_drains_serving_records():
    collector = TL.TraceCollector()
    ref_collector = JL.TraceCollector()
    for c in (collector, ref_collector):
        c.add_serving({"rid": 9, "start_ns": 50.0, "deadline_ns": 10.0})
    report = collector.drain()
    assert [d.code for d in report.errors] == ["PL401"]
    _same(report, ref_collector.drain())
    assert collector.drain().ok  # drained records do not re-report


def test_serving_admission_diags_flags_preceding_deadline():
    recs = [
        {"rid": 1, "cls": "hot", "start_ns": 100.0, "deadline_ns": 40.0},
        {"rid": 2, "cls": "hot", "start_ns": 100.0, "deadline_ns": 200.0},
        {"rid": 3, "start_ns": 100.0, "deadline_ns": None},
        {"rid": 4, "start_ns": 100.0, "deadline_ns": 100.0 - 1e-7},
        {"rid": 5, "cls": "bulk", "start_ns": 3e9, "deadline_ns": 1.5e9},
    ]
    diags = TL.serving_admission_diags(recs)
    assert [d.to_dict() for d in diags] == \
        [d.to_dict() for d in JL.serving_admission_diags(recs)]
    assert len(diags) == 2
    d = diags[0]
    assert d.code == "PL401" and d.severity == "error"
    assert "request 1" in d.message and "[hot]" in d.message
    assert TL.CODES["PL401"] == ("error", "deadline-precedes-start")
