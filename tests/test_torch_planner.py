"""The representation planner and the DRAM model it prices with, held
against the reference package's.

The port's ``core.encoding`` helpers, ``core.machine.BankedSubarray``,
``core.clutch.ClutchEngine``, ``core.cost`` and
``core.scheduler.ChannelScheduler``, and ``pud.planner``'s
``_probe_makespan``, ``choose_representation`` and
``choose_forest_plan`` get the same inputs as ``repro``'s, made from a
seed with NumPy or drawn by hypothesis.  Every comparison is exact
(tolerance 0): subarray states, bitmaps and traces equal entry for
entry, makespans and timeline times equal float for float, plans equal
field for field, and errors of the same type and message.
"""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.apps import gbdt as JG
from repro.apps import predicate as JP
from repro.core import clutch as jclutch
from repro.core import cost as jcost
from repro.core import encoding as jenc
from repro.core import machine as jmach
from repro.core import scheduler as jsched
from repro.pud import planner as jplan
from repro_torch import convert
from repro_torch.core import clutch as tclutch
from repro_torch.core import cost as tcost
from repro_torch.core import encoding as tenc
from repro_torch.core import machine as tmach
from repro_torch.core import scheduler as tsched
from repro_torch.pud import planner as tplan
from test_torch_pudlint import port_pudlint_sweep  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
ARCHS = [(jmach.PuDArch.MODIFIED, tmach.PuDArch.MODIFIED),
         (jmach.PuDArch.UNMODIFIED, tmach.PuDArch.UNMODIFIED)]
ARCH_IDS = ["modified", "unmodified"]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fields(plans):
    return [(p.n_bits, p.num_chunks) for p in plans]


def _entries(trace):
    return [(e.op.value, tuple(int(r) for r in e.rows), e.seg)
            for e in trace.entries]


def _table(t):
    return convert.table(t.n_bits, t.features)


def _forest(f):
    return convert.forest(f.feature_idx, f.thresholds, f.leaves, f.n_bits,
                          f.num_features)


# ------------------------------ encoding ------------------------------ #

@settings(deadline=None, max_examples=60)
@given(st.integers(1, 32), st.integers(1, 2048), st.integers(0, 4),
       st.data())
def test_encoding_helpers_match_reference(n_bits, budget, headroom, data):
    c = data.draw(st.integers(1, n_bits))
    assert tenc.column_footprint_rows(n_bits, c) == \
        jenc.column_footprint_rows(n_bits, c)
    assert tenc.ColumnPlan(n_bits, c).rows_required == \
        jenc.ColumnPlan(n_bits, c).rows_required
    try:
        want = jenc.min_chunks_for_budget(n_bits, budget).widths
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)):
            tenc.min_chunks_for_budget(n_bits, budget)
    else:
        assert tenc.min_chunks_for_budget(n_bits, budget).widths == want
    n = data.draw(st.integers(0, 40))
    vals = np.random.default_rng(n_bits * 7 + n).integers(
        0, 1 << n_bits, n, dtype=np.uint64)
    assert tenc.infer_n_bits(vals, headroom=headroom) == \
        jenc.infer_n_bits(vals, headroom=headroom)
    with pytest.raises(ValueError, match="headroom"):
        tenc.infer_n_bits(vals, headroom=-1)


@pytest.mark.parametrize("arch", ARCHS, ids=ARCH_IDS)
@settings(deadline=None, max_examples=20)
@given(st.integers(1, 12), st.integers(1, 3), st.integers(1, 96),
       st.sampled_from([False, True]), st.data())
def test_load_vector_matches_reference(arch, n_bits, banks, n, complement,
                                       data):
    c = data.draw(st.integers(1, n_bits))
    rng = np.random.default_rng(n_bits * 100 + n)
    shape = (banks, n) if data.draw(st.sampled_from([0, 1])) else (n,)
    vals = rng.integers(0, 1 << n_bits, shape, dtype=np.uint64)
    subs = (jmach.BankedSubarray(banks, 4096 + 8, 96, arch[0], seed=n),
            tmach.BankedSubarray(banks, 4096 + 8, 96, arch[1], seed=n,
                                 device="cpu"))
    jl = jenc.load_vector(subs[0], vals, jenc.make_plan(n_bits, c),
                          complement=complement)
    tl = tenc.load_vector(subs[1], vals, tenc.make_plan(n_bits, c),
                          complement=complement)
    assert (tl.plan.widths, tl.cp, tl.complement) == \
        (jl.plan.widths, jl.cp, jl.complement)
    np.testing.assert_array_equal(
        subs[1].state.numpy().view(np.uint32), subs[0].state)
    assert _entries(subs[1].trace) == _entries(subs[0].trace)


# --------------------------- Algorithm 1 ----------------------------- #

@pytest.mark.parametrize("arch", ARCHS, ids=ARCH_IDS)
@settings(deadline=None, max_examples=25)
@given(st.integers(1, 10), st.integers(1, 70),
       st.sampled_from([False, True]), st.data())
def test_clutch_engine_matches_reference(arch, n_bits, n, clamp, data):
    """Every operator on drawn scalars (the boundaries and, with
    ``clamp``, scalars past the column's max): bitmaps, PuD op counts,
    subarray states and traces equal, segments included."""
    c = data.draw(st.integers(1, n_bits))
    mx = (1 << n_bits) - 1
    vals = np.random.default_rng(n).integers(0, mx + 1, n, dtype=np.uint64)
    subs = (jmach.BankedSubarray(1, 2 * ((1 << n_bits) + 64), 96, arch[0]),
            tmach.BankedSubarray(1, 2 * ((1 << n_bits) + 64), 96, arch[1],
                                 device="cpu"))
    if data.draw(st.sampled_from([False, True])):
        kws = ({"num_chunks": c}, {"num_chunks": c})
    else:
        kws = ({"plan": jenc.ColumnPlan(n_bits, c)},
               {"plan": tenc.ColumnPlan(n_bits, c)})
    engines = (
        jclutch.ClutchEngine(subs[0], vals, n_bits, clamp=clamp, **kws[0]),
        tclutch.ClutchEngine(subs[1], vals, n_bits, clamp=clamp, **kws[1]))
    hi = 3 * mx + 5 if clamp else mx
    scalars = [0, 1, mx, mx - 1, mx // 2,
               data.draw(st.integers(0, hi))]
    if clamp:
        scalars += [mx + 1, hi]
    save = [s.alloc(1) for s in subs]
    for op in ("<", "<=", ">", ">=", "=="):
        for k, x in enumerate(scalars):
            kwargs = [{}, {}]
            if k == 1:
                kwargs = [{"save_to": save[0]}, {"save_to": save[1]}]
            if k == 2:
                kwargs = [{"segment": f"{op}{x}"}] * 2
            rj = engines[0].predicate(op, x, **kwargs[0])
            rt = engines[1].predicate(op, x, **kwargs[1])
            assert (rt.row, rt.pud_ops) == (rj.row, rj.pud_ops), (op, x)
            np.testing.assert_array_equal(engines[1].read_bitmap(rt.row),
                                          engines[0].read_bitmap(rj.row))
    np.testing.assert_array_equal(
        subs[1].state.numpy().view(np.uint32), subs[0].state)
    assert _entries(subs[1].trace) == _entries(subs[0].trace)
    assert subs[1].trace.segments == [
        tmach.Segment(s.sid, s.label, s.after, s.after_host)
        for s in subs[0].trace.segments]
    if not clamp:
        for e in engines:
            with pytest.raises(ValueError, match="out of range"):
                e.predicate("<", mx + 1)


# ------------------------- costs and schedules ------------------------ #

def test_system_configs_and_op_costs_match_reference():
    assert set(tcost.SYSTEMS) == set(jcost.SYSTEMS)
    for name, t in tcost.SYSTEMS.items():
        j = jcost.SYSTEMS[name]
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert (t.total_banks, t.parallel_cols) == \
            (j.total_banks, j.parallel_cols)
        assert hash(t) == hash(dataclasses.replace(t))
        for op in tmach.PuDOp:
            if op in (tmach.PuDOp.READ, tmach.PuDOp.WRITE):
                continue
            jop = jmach.PuDOp(op.value)
            assert tcost.ACTS_PER_OP[op] == jcost.ACTS_PER_OP[jop]
            assert tcost.op_latency(op, t.timings) == \
                jcost.op_latency(jop, j.timings)
            for banks in (None, 1, 5, 64):
                assert tcost.wave_time(op, t, banks) == \
                    jcost.wave_time(jop, j, banks)


def _random_streams(pkg_mach, pkg_sched, seed: int):
    """Three groups over two channels (one spanning both, ranks of
    several banks), each a chain of segments with double-buffered
    branches and host events: labeled ones joined across groups, a
    measured one and one gated on an empty segment."""
    rng = np.random.default_rng(seed)
    ops = [pkg_mach.PuDOp(o) for o in
           ("rowcopy", "tra", "apa", "frac", "not", "read", "write",
            "rowclone", "and", "mract")]
    footprints = [{0: {0: 4, 1: 2}}, {1: {0: 3}}, {0: {0: 1}, 1: {1: 5}}]
    streams = []
    for g, fp in enumerate(footprints):
        tr = pkg_mach.CommandTrace()
        for step in range(int(rng.integers(3, 6))):
            after = None
            if step and rng.random() < 0.4:
                after = (int(rng.integers(0, tr.current_segment + 1)),)
            hosts = ()
            if tr.host_events and rng.random() < 0.5:
                hosts = (len(tr.host_events) - 1,)
            tr.begin_segment(f"s{step}", after=after, after_host=hosts)
            for _ in range(int(rng.integers(0 if step == 2 else 1, 6))):
                tr.emit(ops[int(rng.integers(len(ops)))], 0)
            if rng.random() < 0.6:
                tr.add_host_event(
                    label=f"merge{step}" if rng.random() < 0.5 else "",
                    duration_ns=(float(rng.integers(10, 500))
                                 if rng.random() < 0.3 else None),
                    bytes_in=float(rng.integers(0, 1 << 16)),
                    parallelism=int(rng.integers(1, 4)))
        streams.append(pkg_sched.GroupStream.from_trace(
            f"g{g}", tr, fp, 1024 * (g + 1),
            active_elems=None if g else 77))
    return streams


@pytest.mark.parametrize("host_lanes", [1, 3])
@pytest.mark.parametrize("seed", range(6))
def test_scheduler_matches_reference(seed, host_lanes):
    """Timelines equal field for field: every wave's group, op,
    segment, start, end, channels, banks and bytes, every host span,
    the busy and span maps and the makespan."""
    jcfg = dataclasses.replace(jcost.DESKTOP, host_lanes=host_lanes)
    tcfg = dataclasses.replace(tcost.DESKTOP, host_lanes=host_lanes)
    jt = jsched.ChannelScheduler(jcfg).schedule(
        _random_streams(jmach, jsched, seed))
    tt = tsched.ChannelScheduler(tcfg).schedule(
        _random_streams(tmach, tsched, seed))
    assert tt.makespan_ns == jt.makespan_ns
    assert [(w.group, w.op.value, w.seg, w.seg_label, w.start_ns, w.end_ns,
             w.channels, w.banks, w.io_bytes) for w in tt.waves] == \
        [(w.group, w.op.value, w.seg, w.seg_label, w.start_ns, w.end_ns,
          w.channels, w.banks, w.io_bytes) for w in jt.waves]
    assert [dataclasses.astuple(h) for h in tt.host_spans] == \
        [dataclasses.astuple(h) for h in jt.host_spans]
    assert (tt.channel_busy_ns, tt.group_busy_ns, tt.group_span_ns,
            tt.group_elems) == (jt.channel_busy_ns, jt.group_busy_ns,
                                jt.group_span_ns, jt.group_elems)
    assert len(tt.host_spans) > 0


def test_scheduler_raises_on_a_dependency_cycle():
    for mach, sched in ((jmach, jsched), (tmach, tsched)):
        tr = mach.CommandTrace()
        tr.emit(mach.PuDOp.ROWCOPY, 0, 1)
        tr.segments[0] = mach.Segment(0, "", (1,))
        tr.begin_segment("b", after=(0,))
        tr.emit(mach.PuDOp.ROWCOPY, 0, 1)
        s = sched.GroupStream.from_trace("g", tr, {0: {0: 1}}, 64)
        cfg = jcost.DESKTOP if mach is jmach else tcost.DESKTOP
        with pytest.raises(sched.DependencyCycleError):
            sched.ChannelScheduler(cfg).schedule([s])


@pytest.mark.parametrize("kind", ["range", "gt"])
@pytest.mark.parametrize("arch", ARCHS, ids=ARCH_IDS)
def test_probe_makespan_matches_reference(arch, kind):
    """Every (n_bits <= 32, num_chunks) whose footprint is at most 1,024
    rows, on DESKTOP, whose fields both packages hold equal."""
    assert dataclasses.asdict(tcost.DESKTOP) == \
        dataclasses.asdict(jcost.DESKTOP)
    pairs = [(b, c) for b in range(1, 33) for c in range(1, b + 1)
             if tenc.column_footprint_rows(b, c) <= 1024]
    assert len(pairs) == 485
    for b, c in pairs:
        want = jplan._probe_makespan(b, c, arch[0], jcost.DESKTOP, kind)
        got = tplan._probe_makespan(b, c, arch[1], tcost.DESKTOP, kind)
        assert type(got) is float and got == want, (b, c)


# ------------------------------ the chooser --------------------------- #

def _adaptive_precision_table():
    """``benchmarks/adaptive_precision.py``'s table: widths 4/6/8/12/16
    declared at 16 bits, 2,048 records."""
    rng = np.random.default_rng(31)
    return JP.Table(n_bits=16, features=[
        rng.integers(0, 1 << w, 2048).astype(np.uint64)
        for w in (4, 6, 8, 12, 16)])


@pytest.mark.parametrize("arch", ARCHS, ids=ARCH_IDS)
def test_choose_representation_on_the_adaptive_precision_table(arch):
    t = _adaptive_precision_table()
    want = jplan.choose_representation(t, arch[0], sys_cfg=jcost.DESKTOP)
    got = tplan.choose_representation(_table(t), arch[1],
                                      sys_cfg=tcost.DESKTOP)
    assert _fields(got) == _fields(want)
    assert all(isinstance(p, tenc.ColumnPlan) for p in got)
    c_def = tplan._default_uniform_chunks(16, arch[1], 5, 1024)
    assert 5 * tenc.column_footprint_rows(16, c_def) == 300
    assert sum(p.rows_required for p in got) == 164


@pytest.mark.parametrize("arch", ARCHS, ids=ARCH_IDS)
def test_choose_representation_on_a_lineitem_sample(arch):
    """A 4,096-record sample with ``chip_smoke.py`` phase 11's TPC-H
    ``lineitem`` ranges: the plans that phase hard-codes are the
    reference's."""
    smoke = _chip_smoke()
    cols = smoke.lineitem_columns(4096, seed=0)
    want = jplan.choose_representation(JP.Table(32, cols), arch[0])
    got = tplan.choose_representation(convert.table(32, cols), arch[1])
    assert _fields(got) == _fields(want)
    assert tuple(_fields(got)) == smoke.LINEITEM_AUTO_PLANS[arch[1].value]
    assert [p.n_bits for p in got] == [
        int(hi).bit_length() for _, _, hi in smoke.LINEITEM_COLUMNS]


@settings(deadline=None, max_examples=25)
@given(st.integers(4, 16), st.integers(1, 6), st.integers(0, 3),
       st.sampled_from([256, 512, 1024, 2048]), st.data())
def test_choose_representation_matches_reference_on_drawn_tables(
        n_decl, n_feat, headroom, num_rows, data):
    """Drawn widths, ``headroom``, ``num_rows``, ``num_chunks`` and
    ``row_budget`` (a tight one makes ``_shrink_to_budget`` run, or
    raise): equal plans, or the same error."""
    arch = data.draw(st.sampled_from(ARCHS))
    widths = [data.draw(st.integers(0, n_decl)) for _ in range(n_feat)]
    rng = np.random.default_rng(sum(widths) + 97 * n_feat)
    t = JP.Table(n_decl, [rng.integers(0, 1 << w, 50, dtype=np.uint64)
                          for w in widths])
    kw = dict(num_rows=num_rows, headroom=headroom)
    if data.draw(st.sampled_from([False, True])):
        kw["num_chunks"] = data.draw(st.integers(1, n_decl))
    if data.draw(st.sampled_from([False, True])):
        kw["row_budget"] = data.draw(st.integers(8, num_rows))
    try:
        want = jplan.choose_representation(t, arch[0], **kw)
    except (MemoryError, ValueError) as e:
        with pytest.raises(type(e)) as got:
            tplan.choose_representation(_table(t), arch[1], **kw)
        assert str(got.value) == str(e)
        return
    assert _fields(tplan.choose_representation(_table(t), arch[1], **kw)) \
        == _fields(want)


@pytest.mark.parametrize("case", [
    # (n_bits, widths, num_rows, row_budget): the defaults cannot fit ...
    (32, [32] * 8, 256, None),
    # ... or the tightened budget cannot be met by any chunking
    (8, [8, 8, 8], 1024, 20),
    (16, [16, 3], 1024, 30),
])
@pytest.mark.parametrize("arch", ARCHS, ids=ARCH_IDS)
def test_memory_errors_match_reference(arch, case):
    n_bits, widths, num_rows, budget = case
    rng = np.random.default_rng(1)
    cols = [rng.integers(0, 1 << w, 64, dtype=np.uint64) for w in widths]
    with pytest.raises(MemoryError) as want:
        jplan.choose_representation(JP.Table(n_bits, cols), arch[0],
                                    num_rows=num_rows, row_budget=budget)
    with pytest.raises(MemoryError) as got:
        tplan.choose_representation(convert.table(n_bits, cols), arch[1],
                                    num_rows=num_rows, row_budget=budget)
    assert str(got.value) == str(want.value)
    f = JG.ObliviousForest.random(4, 2, 300, n_bits=16, seed=0)
    with pytest.raises(MemoryError) as want:
        jplan.choose_forest_plan(f, arch[0], num_rows=256)
    with pytest.raises(MemoryError) as got:
        tplan.choose_forest_plan(_forest(f), arch[1], num_rows=256)
    assert str(got.value) == str(want.value)


@settings(deadline=None, max_examples=40)
@given(st.integers(1, 32), st.integers(1, 12), st.integers(64, 4096),
       st.data())
def test_default_uniform_chunks_matches_reference(n_bits, n_feat, num_rows,
                                                  data):
    """The fixed default is one rule in the port: ``fit_chunks`` (how a
    fixed table is laid out) under ``_default_uniform_chunks``."""
    arch = data.draw(st.sampled_from(ARCHS))
    start = data.draw(st.sampled_from([None, 1, n_bits]))
    try:
        want = jplan._default_uniform_chunks(n_bits, arch[0], n_feat,
                                             num_rows, start=start)
    except MemoryError as e:
        with pytest.raises(MemoryError, match=str(e)):
            tplan._default_uniform_chunks(n_bits, arch[1], n_feat,
                                          num_rows, start=start)
        return
    assert tplan._default_uniform_chunks(n_bits, arch[1], n_feat, num_rows,
                                         start=start) == want


@pytest.mark.parametrize("n_bits", [8, 12, 16])
@pytest.mark.parametrize("arch", ARCHS, ids=ARCH_IDS)
def test_choose_forest_plan_matches_reference(arch, n_bits):
    rng = np.random.default_rng(n_bits)
    for thr_max, headroom, chunks in ((400, 0, None), (1 << n_bits, 0, None),
                                      (40, 2, None), (200, 0, 3)):
        f = JG.ObliviousForest(
            rng.integers(0, 5, (12, 3)).astype(np.int32),
            rng.integers(0, min(thr_max, 1 << n_bits), (12, 3))
            .astype(np.uint64),
            rng.normal(size=(12, 8)).astype(np.float32), n_bits, 5)
        kw = dict(headroom=headroom, num_chunks=chunks)
        want = jplan.choose_forest_plan(f, arch[0], **kw)
        got = tplan.choose_forest_plan(_forest(f), arch[1], **kw)
        assert (got.n_bits, got.num_chunks) == (want.n_bits,
                                                want.num_chunks)
