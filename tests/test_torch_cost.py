"""The port's cost model, scheduler and pipeline accounting held against
the reference's, float for float (tolerance 0).

``core.cost`` (wave times and energies, ``trace_cost``,
``timeline_cost``, the compare-kernel costs and the CPU/GPU baselines,
``conversion_cost_ns``), ``core.scheduler`` (``ChannelScheduler`` on
random streams with segments, host events, shared labels, lanes, gangs
and domains -- the port's indexed ``schedule`` must choose as the
reference's rescan does -- ``Timeline``'s views, ``rekey_stream``,
``federate_timelines``, ``predict_makespan``) and
``apps.pipeline.stats_from_timeline``.  Counterparts of the reference's
``tests/test_cost_model.py``, ``test_scheduler.py``,
``test_host_barrier.py`` and ``test_host_lanes.py``.
"""

import dataclasses

import pytest
from hypothesis import given, settings, strategies as st

from test_torch_machine import ARCHS, BOTH, PORT, REF, stats_key, timeline_key
from test_torch_pudlint import port_pudlint_sweep  # noqa: F401  (autouse)

SYSTEMS = ("desktop-ddr4-2666", "edge-ddr4-2400", "gpu-a100-hbm2")
OPS = ("rowcopy", "tra", "apa", "frac", "not", "read", "write", "rowclone",
       "rowinit", "and", "or", "mract")


def _sys(P, name, **kw):
    return dataclasses.replace(P.cost.SYSTEMS[name], **kw)


@pytest.mark.parametrize("name", SYSTEMS)
def test_platforms_waves_and_energies_match_reference(name):
    for P in BOTH:
        assert sorted(P.cost.SYSTEMS) == sorted(SYSTEMS)
    s = [_sys(P, name, multi_row_act=4) for P in BOTH]
    assert dataclasses.asdict(s[1]) == dataclasses.asdict(s[0])
    assert (s[1].total_banks, s[1].parallel_cols) == \
        (s[0].total_banks, s[0].parallel_cols)
    for op in OPS:
        for banks in (None, 1, 7, 64):
            if op not in ("read", "write"):
                assert PORT.cost.wave_time(PORT.cost.PuDOp(op), s[1], banks) \
                    == REF.cost.wave_time(REF.cost.PuDOp(op), s[0], banks)
        for banks in (1, 7, 64):
            assert PORT.cost.wave_energy_nj(PORT.cost.PuDOp(op), banks, s[1]) \
                == REF.cost.wave_energy_nj(REF.cost.PuDOp(op), banks, s[0])
    counts = {"rowcopy": 9, "tra": 3, "frac": 2, "apa": 2, "read": 4,
              "write": 5, "mract": 1, "and": 2}
    for banks in (None, 3, 32):
        assert PORT.cost.sequence_time_ns(counts, s[1], banks) == \
            REF.cost.sequence_time_ns(counts, s[0], banks)
        assert PORT.cost.sequence_energy_nj(counts, s[1], banks) == \
            REF.cost.sequence_energy_nj(counts, s[0], banks)
    for n in (0.0, 4096.0, 3e9):
        assert PORT.cost.transfer_time_ns(n, s[1]) == \
            REF.cost.transfer_time_ns(n, s[0])
        assert PORT.cost.transfer_energy_nj(n, s[1]) == \
            REF.cost.transfer_energy_nj(n, s[0])


@pytest.mark.parametrize("channels,elems,io", [(None, None, True),
                                               (1, 1000, True),
                                               (2, None, False),
                                               (5, 77, True)])
def test_trace_cost_matches_reference(channels, elems, io):
    counts = {"rowcopy": 40, "tra": 12, "not": 3, "read": 2, "write": 60}
    got = [P.cost.trace_cost(counts, P.cost.DESKTOP, banks=32,
                             cols_per_bank=65536, include_host_io=io,
                             channels=channels, elems=elems) for P in BOTH]
    assert dataclasses.asdict(got[1]) == dataclasses.asdict(got[0])
    assert got[1].throughput_geps == got[0].throughput_geps
    assert got[1].elems_per_uj == got[0].elems_per_uj


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("system", SYSTEMS)
def test_compare_costs_and_baselines_match_reference(name, system):
    """``pud_compare_cost`` for Clutch and bit-serial (both accountings,
    with and without the readout), the CPU/GPU scans and the
    conversion cost, at the paper's widths."""
    for n_bits, chunks in ((8, 1), (16, 2), (32, 5), (32, 12)):
        for method in ("clutch", "bitserial"):
            for paper in (False, True):
                for readout in (True, False):
                    c = [P.cost.pud_compare_cost(
                        method, n_bits, P.machine.PuDArch(name),
                        P.cost.SYSTEMS[system], chunks=chunks,
                        include_readout=readout, paper_accounting=paper)
                        for P in BOTH]
                    assert dataclasses.asdict(c[1]) == \
                        dataclasses.asdict(c[0])
        for fn in ("cpu_scan_cost", "cpu_tree_cost", "gpu_scan_cost"):
            c = [getattr(P.cost, fn)(n_bits, 2 ** 25, P.cost.SYSTEMS[system])
                 for P in BOTH]
            assert dataclasses.asdict(c[1]) == dataclasses.asdict(c[0])
        for comp in (False, True):
            assert PORT.cost.conversion_cost_ns(
                2 ** 25, n_bits, chunks, PORT.cost.SYSTEMS[system],
                complement=comp) == REF.cost.conversion_cost_ns(
                2 ** 25, n_bits, chunks, REF.cost.SYSTEMS[system],
                complement=comp)
    with pytest.raises(ValueError):
        PORT.cost.pud_compare_cost("bogus", 8, PORT.machine.PuDArch(name),
                                   PORT.cost.DESKTOP)


# ------------------------------ scheduling ------------------------------ #

def _draw_streams(data, P, n_groups, shared_labels):
    """Random group streams: placements on 3 channels, segments with
    ``after`` sets and host barriers, host events with shared labels,
    measured or modeled durations and parallelism hints."""
    ops = [P.machine.PuDOp(o) for o in ("rowcopy", "tra", "read", "write",
                                        "not", "rowclone", "and")]
    streams = []
    for g in range(n_groups):
        trace = P.machine.CommandTrace()
        for _ in range(data.draw(st.integers(0, 5))):
            kind = data.draw(st.sampled_from(["wave", "wave", "seg",
                                              "host"]))
            if kind == "wave":
                for _ in range(data.draw(st.integers(1, 4))):
                    trace.emit(ops[data.draw(st.integers(0, 6))], 1)
            elif kind == "seg":
                prev = list(range(len(trace.segments)))
                after = tuple(data.draw(st.lists(st.sampled_from(prev),
                                                 max_size=2, unique=True)))
                hosts = tuple(range(len(trace.host_events)))[-1:] \
                    if data.draw(st.booleans()) else ()
                trace.begin_segment(data.draw(st.sampled_from(["", "x",
                                                               "y"])),
                                    after=after if after else None,
                                    after_host=hosts)
            else:
                label = data.draw(st.sampled_from(shared_labels + [""]))
                measured = data.draw(st.sampled_from([None, 5.0, 120.0]))
                trace.add_host_event(
                    label, after_host=tuple(range(len(trace.host_events)))
                    [-1:] if data.draw(st.booleans()) else (),
                    duration_ns=measured,
                    bytes_in=float(data.draw(st.integers(0, 4096))),
                    parallelism=data.draw(st.integers(1, 3)))
        ch = data.draw(st.sampled_from([{0: {0: 2}}, {1: {0: 1, 1: 3}},
                                        {0: {0: 1}, 2: {1: 2}}]))
        stream = P.scheduler.GroupStream.from_trace(
            f"g{g}", trace, ch, 64,
            active_elems=data.draw(st.sampled_from([None, 50])))
        streams.append(dataclasses.replace(
            stream, host=data.draw(st.integers(0, 1))))
    return streams


class _Replay:
    """Feeds one recorded list of choices to two scenario builds."""

    def __init__(self, data) -> None:
        self.data = data
        self.log: list = []
        self.pos = None

    def draw(self, strategy):
        if self.pos is None:
            v = self.data.draw(strategy)
            self.log.append(v)
            return v
        v = self.log[self.pos]
        self.pos += 1
        return v

    def rewind(self) -> None:
        self.pos = 0


@settings(deadline=None, max_examples=60)
@given(st.integers(1, 4), st.integers(1, 3), st.data())
def test_scheduler_matches_reference_on_random_streams(n_groups, lanes,
                                                       data):
    """Random streams scheduled by both packages: every wave, host span
    and tally equal float for float, or one error of one type (a
    dependency cycle)."""
    rec = _Replay(data)
    streams = []
    for P in BOTH:
        streams.append(_draw_streams(rec, P, n_groups, ["m", "n"]))
        rec.rewind()
    sys_cfg = [_sys(P, "desktop-ddr4-2666", host_lanes=lanes) for P in BOTH]
    out = []
    for P, ss, c in zip(BOTH, streams, sys_cfg):
        try:
            out.append(timeline_key(P.scheduler.ChannelScheduler(c)
                                    .schedule(ss)))
        except P.scheduler.DependencyCycleError as e:
            out.append(("cycle", str(e)[:40]))
    assert out[1] == out[0]


def _scheduled(P, lanes=2, hosts=(0, 1)):
    """Three groups over two channels with a shared merge label, a
    barrier and a ganged event: a timeline with every view non-trivial."""
    traces = []
    for g in range(3):
        t = P.machine.CommandTrace()
        t.begin_segment(f"c{g}")
        for op in ("rowcopy", "tra", "rowcopy", "read"):
            t.emit(P.machine.PuDOp(op), g)
        h = t.add_host_event("join", bytes_in=2048.0, parallelism=2)
        t.begin_segment("p2", after_host=(h,))
        t.emit(P.machine.PuDOp("rowcopy"), 1)
        t.add_host_event(f"leaf{g}", duration_ns=77.0 * (g + 1))
        traces.append(t)
    streams = [dataclasses.replace(P.scheduler.GroupStream.from_trace(
        f"g{g}", t, {g % 2: {0: 2 + g}}, 128), host=hosts[g % len(hosts)])
        for g, t in enumerate(traces)]
    cfg = _sys(P, "desktop-ddr4-2666", host_lanes=lanes)
    return P.scheduler.ChannelScheduler(cfg), streams, cfg


@pytest.mark.parametrize("lanes,hosts", [(1, (0,)), (2, (0, 1)),
                                         (3, (0, 1))])
def test_timeline_views_and_cost_match_reference(lanes, hosts):
    tls = []
    for P in BOTH:
        sched, streams, cfg = _scheduled(P, lanes, hosts)
        tl = sched.schedule(streams)
        tls.append(tl)
        kc = P.cost.timeline_cost(tl, cfg)
        views = (tl.host_lane_busy_ns, tl.host_utilization, tl.host_wall_ns,
                 tl.device_span_ns, tl.host_busy_ns, tl.segment_spans(),
                 tl.serial_bound_ns, tl.overlap_bound_ns,
                 [tl.channel_utilization(c) for c in (0, 1, 7)],
                 dataclasses.asdict(kc),
                 sched.predict_makespan(streams),
                 sched.predict_makespan(streams, by_segment=True))
        if P is REF:
            want = views
        else:
            assert views == want
    assert timeline_key(tls[1]) == timeline_key(tls[0])


@pytest.mark.parametrize("merge_ns", [0.0, 250.0])
@pytest.mark.parametrize("n", [1, 2, 3])
def test_rekey_and_federation_match_reference(merge_ns, n):
    """Per-device timelines re-keyed and federated: channels re-keyed,
    same-label host spans unified, the serving merge appended."""
    out = []
    for P in BOTH:
        tls = []
        for d in range(n):
            sched, streams, _ = _scheduled(P, 2, (0, 1))
            streams = [P.scheduler.rekey_stream(s, d, 2,
                                                host=d if d % 2 else None)
                       for s in streams]
            assert [s.footprint for s in streams] == [
                {d * 2 + c: r for c, r in s0.footprint.items()}
                for s0 in _scheduled(P)[1]]
            tls.append(sched.schedule(streams[d % 3:] or streams))
        fed = P.scheduler.federate_timelines(tls, merge_ns=merge_ns)
        out.append(timeline_key(fed))
    assert out[1] == out[0]


@pytest.mark.parametrize("lanes", [1, 2])
def test_stats_from_timeline_match_reference(lanes):
    out = []
    for P in BOTH:
        sched, streams, _ = _scheduled(P, lanes)
        tl = sched.schedule(streams)
        st_ = P.pipeline.stats_from_timeline(
            tl, ["g0", "g1", "g2"], [["c0", "join", "leaf0"],
                                     ["c1", "c2", "p2", "leaf1", "leaf2"]],
            [10.0, 20.0])
        out.append(stats_key(st_))
        assert st_.num_waves == 2
    assert out[1] == out[0]
    timers = [P.pipeline.HostTimer() for P in BOTH]
    for t in timers:
        assert t.measure(lambda a, b=1: a + b, 2, b=3) == 5
        assert len(t.samples_ns) == 1 and t.samples_ns[0] >= 0
