"""The port's PuD machine model (``repro_torch.core.machine`` and
``core.device``) held against the reference's on the CPU.

Both packages get the same seeds and the same operations (drawn by
hypothesis where a sequence is random); every comparison is exact:
whole ``[banks, rows, words]`` states bit for bit (the port's int32
tensor viewed as ``uint32``), traces entry for entry (row operands,
segments, cross-group clone flags), host reads word for word, device
free maps, addresses and defragmentation moves equal, and errors of
one type and message.  Counterparts of the reference's
``tests/test_banked.py``, ``test_indram_ops.py`` and the placement half
of ``test_pud_session.py``.

The first part of this file is the machine-backend tests' shared
set-up, which ``test_torch_engines.py``, ``test_torch_cost.py`` and
``test_torch_machine_session.py`` import from here: ``REF`` and
``PORT`` bundle each package's PuD-model modules under one set of
names, with ``dev`` the keywords the port's constructors need to keep
their state on the CPU (the reference's are empty), so a scenario
written once runs on either package and returns what the test compares.
"""

import types

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.apps.gbdt as j_gbdt
import repro.apps.pipeline as j_pipeline
import repro.apps.predicate as j_predicate
import repro.core.bitserial as j_bitserial
import repro.core.clutch as j_clutch
import repro.core.cost as j_cost
import repro.core.device as j_device
import repro.core.encoding as j_encoding
import repro.core.machine as j_machine
import repro.core.scheduler as j_scheduler
import repro.pud.executors as j_executors
import repro.pud.planner as j_planner
import repro.pud.queries as j_queries
import repro.pud.session as j_session
import repro.serve.pud_service as j_service
import repro_torch.apps.gbdt as t_gbdt
import repro_torch.apps.pipeline as t_pipeline
import repro_torch.apps.predicate as t_predicate
import repro_torch.core.bitserial as t_bitserial
import repro_torch.core.clutch as t_clutch
import repro_torch.core.cost as t_cost
import repro_torch.core.device as t_device
import repro_torch.core.encoding as t_encoding
import repro_torch.core.machine as t_machine
import repro_torch.core.scheduler as t_scheduler
import repro_torch.pud.executors as t_executors
import repro_torch.pud.planner as t_planner
import repro_torch.pud.queries as t_queries
import repro_torch.pud.session as t_session
import repro_torch.serve.pud_service as t_service


def _bundle(prefix: str, dev: dict, sess: dict) -> types.SimpleNamespace:
    g = globals()
    names = ("gbdt", "pipeline", "predicate", "bitserial", "clutch", "cost",
             "device", "encoding", "machine", "scheduler", "executors",
             "planner", "queries", "session", "service")
    ns = types.SimpleNamespace(**{n: g[f"{prefix}_{n}"] for n in names})
    ns.dev = dev
    ns.sess = sess
    ns.name = prefix
    return ns


REF = _bundle("j", {}, {"verify": "off"})
PORT = _bundle("t", {"device": "cpu"}, {"device": "cpu"})
BOTH = (REF, PORT)
ARCHS = ("modified", "unmodified")


def arch(P, name: str):
    return P.machine.PuDArch(name)


def state(sub) -> np.ndarray:
    """A subarray's ``[banks, rows, words]`` state as NumPy ``uint32``."""
    s = sub.state
    if isinstance(s, torch.Tensor):
        return s.cpu().numpy().view(np.uint32)
    return s


def _row(r):
    return tuple(int(x) for x in r) if isinstance(r, np.ndarray) else int(r)


def entries(trace) -> list:
    """Trace entries with their row operands as plain ints (per-bank
    arrays as tuples) and whether they are cross-group clones."""
    return [(e.op.value, tuple(_row(r) for r in e.rows), e.seg,
             e.xsrc is not None) for e in trace.entries]


def trace_key(trace) -> tuple:
    return (entries(trace),
            [(s.sid, s.label, s.after, s.after_host) for s in trace.segments],
            [(h.hid, h.label, h.after, h.after_host, h.duration_ns,
              h.bytes_in, h.parallelism) for h in trace.host_events],
            trace.from_reset)


def timeline_key(tl) -> tuple:
    """Every scheduled wave and host span, the makespan and the
    tallies, as plain values (float for float)."""
    return ([(w.group, w.op.value, w.seg, w.seg_label, w.start_ns,
              w.end_ns, w.channels, w.banks, w.io_bytes) for w in tl.waves],
            [(h.label, h.start_ns, h.end_ns, h.host, h.lanes)
             for h in tl.host_spans],
            tl.makespan_ns, tl.channel_busy_ns, tl.group_busy_ns,
            tl.group_span_ns, tl.group_elems)


def stats_key(st) -> tuple:
    return (st.wave_done_ns, st.wave_busy_ns, st.host_ns, st.makespan_ns,
            st.device_ns, st.host_lane_busy_ns, st.host_utilization,
            st.serialized_ns, st.overlapped_ns, st.overlap_efficiency)


def same_result(a, b) -> None:
    """Results equal bit for bit, of one type (bitmaps, ints, floats)."""
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b)
        for x, y in zip(a, b):
            same_result(x, y)
    else:
        assert type(a) is type(b) and a == b, (a, b)


def table(P, records: int = 3000, n_bits: int = 8, features: int = 6,
          seed: int = 1):
    return P.predicate.Table.generate(records, n_bits,
                                      num_features=features, seed=seed)


def forest(P, trees: int = 12, depth: int = 3, features: int = 4,
           n_bits: int = 8, seed: int = 2):
    return P.gbdt.ObliviousForest.random(trees, depth, features, n_bits,
                                         seed=seed)


def queries(P, mx: int = 255) -> list:
    """Q1-Q5 and compounds merged in the banks and on the host."""
    Q = P.queries
    qa = dict(fi=0, x0=mx // 8, x1=mx // 2, fj=1, y0=mx // 4,
              y1=3 * mx // 4)
    qb = dict(fi=2, x0=mx // 3, x1=mx, fj=5, y0=0, y1=mx // 5)
    terms = (Q.Q1(fi=4, x0=mx // 10, x1=9 * mx // 10), Q.Q2(**qa),
             Q.Q3(**qb))
    return [Q.Q1(fi=0, x0=mx // 8, x1=mx // 2), Q.Q2(**qa), Q.Q3(**qa),
            Q.Q4(fk=2, **qa), Q.Q5(fl=3, fk=2, **qa),
            Q.Compound(terms, ("or", "and")),
            Q.Compound(terms[:2], ("and",), count=True),
            Q.Compound(terms, ("and", "or"), merge="host"),
            Q.Compound(terms[1:], ("or",), count=True, merge="host")]


class FakeTime:
    """A clock that advances one microsecond a read: the measured host
    merges of both packages become equal, so their timelines can be
    compared float for float."""

    def __init__(self) -> None:
        self.t = 0.0

    def perf_counter(self) -> float:
        self.t += 1e-6
        return self.t


def pin_clock(monkeypatch) -> None:
    """Pin both packages' host timers (``HostTimer`` and the executors'
    merge-leaf timers) to fresh fake clocks and restart their label
    counters, so the two record the same labels and durations."""
    for P in BOTH:
        monkeypatch.setattr(P.pipeline, "time", FakeTime())
        monkeypatch.setattr(P.executors, "time", FakeTime())
        monkeypatch.setattr(P.executors.QueryBatchExecutor, "_uid", 0)
        monkeypatch.setattr(P.executors.GbdtBatchExecutor, "_uid", 0)
        monkeypatch.setattr(P.predicate.PudQueryEngine, "_host_uid", 0)


@pytest.fixture
def pinned_clock(monkeypatch):
    pin_clock(monkeypatch)


def _subs(name, banks, rows, cols, seed=3, mra=1):
    return [P.machine.BankedSubarray(banks, rows, cols, arch(P, name),
                                     seed=seed, multi_row_act=mra, **P.dev)
            for P in BOTH]


def _same(subs):
    np.testing.assert_array_equal(state(subs[1]), state(subs[0]))
    assert trace_key(subs[1].trace) == trace_key(subs[0].trace)


def _both(subs, fn):
    """Run ``fn(sub)`` on both; equal results, or equal errors."""
    out = []
    for s in subs:
        try:
            out.append(("ok", fn(s)))
        except Exception as e:  # compared below, type and text
            out.append(("err", type(e).__name__, str(e)))
    if out[0][0] == "ok" and out[1][0] == "ok":
        a, b = out[0][1], out[1][1]
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b
    else:
        assert out[0] == out[1]
    return out[0][0] == "ok"


def _draw_op(data, sub, name, rows):
    """One random primitive call (a closure over plain values, so both
    subarrays receive the same operation)."""
    nb, lim = sub.num_banks, rows - 8
    row = st.integers(0, rows - 1)
    data_row = st.integers(0, max(lim - 1, 0))
    vec = st.lists(st.integers(0, rows - 1), min_size=nb, max_size=nb)
    src = st.one_of(row, vec.map(lambda v: np.array(v, np.int64)))
    kinds = ["rowcopy", "rowclone", "rowinit", "mract", "rowclone_rows",
             "and", "or", "ambit_and", "ambit_or", "maj3", "write",
             "write_rows", "read", "peek", "alloc", "segment"]
    kinds += ["not", "tra"] if name == "modified" else ["frac_apa"]
    k = data.draw(st.sampled_from(kinds))
    if k == "rowcopy":
        s, d = data.draw(src), data.draw(data_row)
        return k, lambda x: x.rowcopy(s, d)
    if k == "rowclone":
        s, d = data.draw(data_row), data.draw(data_row)
        return k, lambda x: x.rowclone(s, d)
    if k == "rowinit":
        d, ones = data.draw(data_row), data.draw(st.booleans())
        return k, lambda x: x.rowinit(d, ones=ones)
    if k in ("mract", "rowclone_rows"):
        n = data.draw(st.integers(1, 6))
        s = data.draw(st.integers(0, max(lim - n, 0)))
        d = data.draw(st.sampled_from([s, min(s + n, max(lim - n, 0)),
                                       data.draw(st.integers(
                                           0, max(lim - n, 0)))]))
        if k == "mract":
            return k, lambda x: x.mract_clone(s, d, n)
        return k, lambda x: x.rowclone_rows(s, d, n)
    if k in ("and", "or", "ambit_and", "ambit_or"):
        a, b, d = data.draw(src), data.draw(src), data.draw(data_row)
        fn = {"and": "and_wave", "or": "or_wave"}.get(k, k)
        return k, lambda x: getattr(x, fn)(a, b, d)
    if k == "maj3":
        a, b, c = data.draw(src), data.draw(src), data.draw(src)
        return k, lambda x: x.maj3_into_acc(a, b, c)
    if k == "not":
        s, d = data.draw(src), data.draw(data_row)
        return k, lambda x: x.bulk_not(s, d)
    if k == "tra":
        return k, lambda x: x.tra()
    if k == "frac_apa":
        slot = data.draw(st.integers(0, 3))
        return k, lambda x: (x.frac(slot), x.apa())[1]
    if k in ("write", "write_rows"):
        n = 1 if k == "write" else data.draw(st.integers(1, 4))
        d = data.draw(st.integers(0, max(lim - n, 0)))
        per_bank = data.draw(st.booleans())
        shape = ((nb,) if per_bank else ()) + \
            (() if k == "write" else (n,)) + (sub.num_words,)
        w = np.random.default_rng(data.draw(st.integers(0, 99))).integers(
            0, 2 ** 32, shape, dtype=np.uint32)
        if k == "write":
            return k, lambda x: x.host_write_row(d, w)
        return k, lambda x: x.host_write_rows(d, w)
    if k in ("read", "peek"):
        r = data.draw(row)
        return k, lambda x: (x.host_read_row(r) if k == "read"
                             else x.peek(r))
    if k == "alloc":
        n = data.draw(st.integers(1, 8))
        return k, lambda x: x.alloc(n)
    label = data.draw(st.sampled_from(["", "a", "b"]))
    return k, lambda x: x.trace.begin_segment(label)


# random streams read rows no wave wrote: opted out of the reference's
# trace lint (conftest), as the reference's own invalid-stream tests are
@pytest.mark.pudlint_skip
@pytest.mark.parametrize("name", ARCHS)
@settings(deadline=None, max_examples=40)
@given(st.integers(1, 4), st.integers(24, 48), st.sampled_from([32, 96]),
       st.integers(1, 4), st.integers(0, 50), st.data())
def test_random_primitive_sequences_match_reference(name, banks, rows, cols,
                                                    mra, seed, data):
    """Every primitive, broadcast and per-bank operands, the PULSAR
    capability on and off: after each operation the states, traces and
    any host read or error are equal."""
    subs = _subs(name, banks, rows, cols, seed=seed, mra=mra)
    _same(subs)
    for _ in range(data.draw(st.integers(1, 30))):
        _, fn = _draw_op(data, subs[0], name, rows)
        _both(subs, fn)
        _same(subs)
    assert subs[1].rows_free == subs[0].rows_free
    assert subs[1].trace.counts() == subs[0].trace.counts()
    assert subs[1].trace.pud_ops == subs[0].trace.pud_ops


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("mra", [1, 4])
def test_cross_group_clone_and_replay_match_reference(name, mra):
    """``clone_rows_from`` records MRACT/ROWCLONE waves flagged as
    cross-group; ``replay`` of a recorded stream onto a twin holding the
    pre-stream state reaches the same state and readouts."""
    src = _subs(name, 2, 40, 64, seed=1, mra=mra)
    dst = _subs(name, 2, 40, 64, seed=2, mra=mra)
    for s in src:
        s.host_write_rows(3, np.arange(6 * 2, dtype=np.uint32).reshape(
            6, 2) * 0x01010101)
    for s, d in zip(src, dst):
        d.clone_rows_from(s, 3, 10, 6)
    _same(dst)
    assert any(e[3] for e in entries(dst[1].trace))
    snaps = [state(d).copy() for d in dst]
    for d in dst:
        d.trace.clear()
        d.rowcopy(np.array([10, 11]), 20)
        d.ambit_or(12, 13, 21)
        d.rowclone_rows(10, 30, 6)
        if name == "modified":
            d.maj3_into_acc(20, 21, d.ROW_ONE)
            d.bulk_not(d.T0, 22)
        else:
            d.maj3_into_acc(20, 21, d.ROW_ZERO)
        d.host_read_row(22)
    twins = _subs(name, 2, 40, 64, seed=9, mra=mra)
    twins[0].state[...] = snaps[0]
    twins[1].state.copy_(torch.from_numpy(snaps[1].view(np.int32)))
    reads = [[], []]
    for P, t, d, r in zip(BOTH, twins, dst, reads):
        P.machine.replay(d.trace.entries, t, reads=r)
    _same(twins)
    np.testing.assert_array_equal(state(twins[1]), state(dst[1]))
    assert [x.tolist() for x in reads[1]] == [x.tolist() for x in reads[0]]
    with pytest.raises(ValueError, match="matching bank counts"):
        dst[1].clone_rows_from(_subs(name, 3, 40, 64)[1], 0, 0, 1)


def test_single_bank_subarray_view_matches_reference():
    subs = [P.machine.Subarray(64, 128, arch(P, "unmodified"), seed=4,
                               **P.dev) for P in BOTH]
    for s in subs:
        s.host_write_row(0, np.full(4, 0xDEADBEEF, np.uint32))
        s.maj3_into_acc(0, s.ROW_ONE, 0)
    assert subs[1].rows.shape == (64, 4)
    np.testing.assert_array_equal(subs[1].rows.numpy().view(np.uint32),
                                  subs[0].rows)
    for r in (0, 60, 61):
        np.testing.assert_array_equal(subs[1].host_read_row(r),
                                      subs[0].host_read_row(r))
        np.testing.assert_array_equal(subs[1].peek(r), subs[0].peek(r))
    assert subs[1].peek(0).shape == (4,)
    _same(subs)


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_power_up_state_is_the_reference_draw(seed):
    """Unwritten rows equal the reference's random power-up content; the
    constant rows are 0 and all-ones."""
    subs = _subs("modified", 3, 32, 64, seed=seed)
    _same(subs)
    assert (state(subs[1])[:, subs[1].ROW_ONE] == 0xFFFFFFFF).all()
    assert (state(subs[1])[:, subs[1].ROW_ZERO] == 0).all()
    assert len(subs[1].powerup_ns) == 2


ERRORS = [
    ("mract span", "modified", lambda s: s.mract_clone(0, 10, 4)),
    ("mract overlap", "modified", lambda s: s.mract_clone(0, 1, 2)),
    ("apa without frac", "unmodified", lambda s: s.apa()),
    ("tra on unmodified", "unmodified", lambda s: s.tra()),
    ("not on unmodified", "unmodified", lambda s: s.bulk_not(0, 1)),
    ("frac on modified", "modified", lambda s: s.frac(0)),
    ("bad per-bank shape", "modified",
     lambda s: s.rowcopy(np.array([1, 2, 3]), 4)),
    ("row budget", "modified", lambda s: s.alloc(40)),
]


@pytest.mark.parametrize("what,name,fn", ERRORS, ids=[e[0] for e in ERRORS])
def test_errors_match_reference(what, name, fn):
    subs = _subs(name, 2, 32, 64, mra=3)
    assert not _both(subs, fn)
    _same(subs)


@pytest.mark.parametrize("kw", [dict(num_cols=33), dict(num_banks=0),
                                dict(multi_row_act=0)],
                         ids=["cols", "banks", "mra"])
def test_constructor_errors_match_reference(kw):
    args = dict(num_banks=1, num_rows=32, num_cols=64)
    args.update(kw)
    msgs = []
    for P in BOTH:
        with pytest.raises(ValueError) as e:
            P.machine.BankedSubarray(**args, **P.dev)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_model_needs_a_device_without_cuda(monkeypatch):
    """No fallback: with no CUDA and no ``device`` the model's state
    cannot be made (nor a machine session)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PORT.machine.BankedSubarray(1, 32, 64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PORT.device.PuDDevice(PORT.machine.PuDArch.MODIFIED)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PORT.session.PudSession()
    assert PORT.machine.BankedSubarray(1, 32, 64, device="cpu").state \
        .device.type == "cpu"


def test_trace_bookkeeping_matches_reference():
    traces = [P.machine.CommandTrace() for P in BOTH]
    for t in traces:
        s1 = t.begin_segment("a")
        t.emit(_op(t, "rowcopy"), 1, 2)
        h = t.add_host_event("m", after=(s1,), bytes_in=64.0,
                             parallelism=3)
        t.begin_segment("b", after=(), after_host=(h,))
        t.emit_rows(_op(t, "read"), 4, 3)
        t.set_host_duration(h, 12.5)
    assert trace_key(traces[1]) == trace_key(traces[0])
    assert traces[1].counts() == traces[0].counts() == {"rowcopy": 1,
                                                        "read": 3}
    assert traces[1].count(_op(traces[1], "read")) == 3
    assert traces[1].pud_ops == traces[0].pud_ops == 1
    for t in traces:
        t.clear()
    assert trace_key(traces[1]) == trace_key(traces[0])
    assert traces[1].from_reset is False


def _op(trace, name):
    mod = REF.machine if isinstance(trace, REF.machine.CommandTrace) \
        else PORT.machine
    return mod.PuDOp(name)


# ----------------------------- the device ----------------------------- #

def _devices(name="modified", **kw):
    return [P.device.PuDDevice(arch(P, name), **kw, **P.dev) for P in BOTH]


def _free_map(dev):
    return (dev.free_ranges, dev.banks_free, dev.largest_free_run,
            [(g.banks, g.label, g.active_elems) for g in dev.groups])


@settings(deadline=None, max_examples=30)
@given(st.data())
def test_device_placement_and_free_map_match_reference(data):
    """Random allocations (first fit, one channel, a channel list,
    ``"spread"``) and frees: placements, free maps, MemoryError texts
    and addresses equal."""
    devs = _devices(channels=3, ranks_per_channel=2, banks_per_rank=4,
                    num_rows=32, cols_per_bank=64)
    live = [[], []]
    for _ in range(data.draw(st.integers(1, 14))):
        if live[0] and data.draw(st.booleans()):
            i = data.draw(st.integers(0, len(live[0]) - 1))
            for d, lv in zip(devs, live):
                d.free_banks(lv.pop(i))
        else:
            n = data.draw(st.integers(1, 9))
            ch = data.draw(st.sampled_from(
                [None, 0, 2, [0, 1], [2, 0], "spread"]))
            outs = []
            for d, lv in zip(devs, live):
                try:
                    lv.append(d.alloc_banks(n, label=f"g{n}", channels=ch,
                                            active_elems=n * 10))
                    outs.append("ok")
                except (MemoryError, IndexError) as e:
                    outs.append((type(e).__name__, str(e)))
            assert outs[0] == outs[1]
        assert _free_map(devs[1]) == _free_map(devs[0])
    for b in (0, 5, 23):
        assert devs[1].address(b).__dict__ == devs[0].address(b).__dict__
    for d in devs:
        assert d.parallel_cols == 24 * 64 and d.banks_per_channel == 8


@pytest.mark.parametrize("rowclone", [True, False])
@pytest.mark.parametrize("mra", [1, 3])
def test_defragment_matches_reference(rowclone, mra):
    """Fragment a device, defragment it: banks moved, the new
    placements, the relocation waves in each moved group's stream and
    the coalesced free map equal; every group's state is untouched."""
    devs = _devices(channels=2, ranks_per_channel=1, banks_per_rank=8,
                    num_rows=32, cols_per_bank=64, multi_row_act=mra)
    groups = []
    for d in devs:
        gs = [d.alloc_banks(2, label=f"g{i}", channels=i % 2)
              for i in range(6)]
        for g in gs:
            g.alloc(5)
            g.host_write_rows(0, np.full((5, 2), 7, np.uint32))
        for i in (0, 3):
            d.free_banks(gs[i])
        groups.append([g for i, g in enumerate(gs) if i not in (0, 3)])
    before = [[state(g).copy() for g in gs] for gs in groups]
    moved = [d.defragment(rowclone=rowclone) for d in devs]
    assert moved[0] == moved[1] > 0
    assert _free_map(devs[1]) == _free_map(devs[0])
    for a, b in zip(groups[0], groups[1]):
        assert trace_key(b.trace) == trace_key(a.trace)
    for gs, snap in zip(groups, before):
        for g, s in zip(gs, snap):
            np.testing.assert_array_equal(state(g), s)
    assert [st.label for st in devs[1].streams()] == \
        [st.label for st in devs[0].streams()]


def test_device_schedule_and_cost_summary_match_reference():
    """Two groups on one channel and one on the other, LUTs loaded and
    compared: the device timeline and cost summary equal float for
    float."""
    devs = _devices("unmodified", num_rows=256, cols_per_bank=128,
                    channels=2, ranks_per_channel=2, banks_per_rank=4)
    for P, d in zip(BOTH, devs):
        vals = np.arange(3 * 128, dtype=np.uint64).reshape(3, 128) % 200
        for i, ch in enumerate((0, 0, 1)):
            sub = d.alloc_banks(3, label="eng", channels=ch,
                                active_elems=300)
            eng = P.clutch.ClutchEngine(sub, vals, 8, num_chunks=2)
            eng.predicate("<", 17 + i, segment="q")
            sub.host_read_row(eng.predicate(">=", 99).row)
    sys_cfg = [P.cost.DESKTOP for P in BOTH]
    assert timeline_key(devs[1].schedule(sys_cfg[1])) == \
        timeline_key(devs[0].schedule(sys_cfg[0]))
    assert devs[1].cost_summary(sys_cfg[1]) == \
        devs[0].cost_summary(sys_cfg[0])
    with pytest.raises(ValueError, match="not placed"):
        devs[1].free_banks(PORT.machine.BankedSubarray(1, 32, 64,
                                                       device="cpu"))
