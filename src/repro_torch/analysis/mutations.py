"""Seeded-mutation self-test harness for pudlint.

The reference package's ``analysis/mutations.py`` under the same names.
The recorders build their subarrays on an explicit ``device`` (the card
unless the caller names another; with no CUDA and no ``device`` they
raise), and :func:`seeded_violations`, :func:`baseline_reports` and
:func:`self_test` pass it on.  The streams, timelines and reports are
host data and equal the reference's.

A static analyzer that reports nothing on every input is
indistinguishable from a working one, so this module proves pudlint is
*non-vacuous*: it records small known-good command streams (which lint
clean), seeds exactly one violation of each class into a copy -- drop a
dependency edge, swap a staging row, oversize an MRACT span, clobber a
constant row, shrink a scheduled wave, ... -- and exposes the resulting
``(name, expected diagnostic code, report)`` triples.
:func:`seeded_violations` drives both the pytest self-test
(``tests/test_torch_pudlint.py``) and the chip smoke's phase 14; each
must see every mutation flagged with its expected code and the
unmutated baselines flagged with nothing.

Mutations edit the recorded artifacts, never the machine: stream
mutations are tuple surgery on :class:`~repro_torch.core.scheduler.\
GroupStream` copies, timeline mutations are
:func:`dataclasses.replace` surgery on
:class:`~repro_torch.core.scheduler.ScheduledWave` placements, the
device-level mutation records a genuinely-invalid cross-channel clone,
and the representation-level mutation declares a
:class:`~repro_torch.core.encoding.ColumnPlan` the encoded LUT planes never
saw (the stale state a skipped ``recode_column`` rebuild leaves).
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np

from repro_torch.core import cost
from repro_torch.core.machine import BankedSubarray, PuDArch, PuDOp
from repro_torch.core.scheduler import ChannelScheduler, GroupStream, Timeline

from .pudlint import (
    LintReport,
    lint_stream,
    lint_timeline,
    representation_diags,
)

#: System config every seeded schedule uses: DESKTOP with the PULSAR
#: capability the good trace's MRACT wave needs.
SYS_CFG = replace(cost.DESKTOP, multi_row_act=4)

#: Footprint the seeded streams pretend to occupy (2 banks, channel 0).
_FOOTPRINT = {0: {0: 2}}


# --------------------------------------------------------------------- #
# Known-good recordings
# --------------------------------------------------------------------- #
def record_good(arch: PuDArch = PuDArch.UNMODIFIED,
                seed: int = 1, device=None) -> BankedSubarray:
    """A representative clean stream: host loads, a MAJ3 chain, an
    Ambit merge, a PULSAR multi-row clone, readouts feeding a host
    merge, and a wave gated on the host barrier."""
    sub = BankedSubarray(num_banks=2, num_rows=64, num_cols=64,
                         arch=arch, seed=seed, multi_row_act=4,
                         device=device)
    sub.alloc(8)
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 2**32, size=(4, sub.num_words), dtype=np.uint32)
    sub.host_write_rows(0, data)                  # seg 0: rows 0-3
    tr = sub.trace
    tr.begin_segment("compute")
    sub.maj3_into_acc(0, 1, 2)
    acc = sub.T0 if arch is PuDArch.MODIFIED else sub.G[0]
    sub.rowcopy(acc, 4)                           # park the result
    tr.begin_segment("merge")
    sub.ambit_and(0, 1, 5)
    tr.begin_segment("clone")
    sub.rowclone_rows(0, 8, 4)                    # one MRACT span-4 wave
    tr.begin_segment("readout")
    sub.host_read_row(4)
    sub.host_read_row(5)
    hid = tr.add_host_event("merge:final", bytes_in=64.0)
    tr.begin_segment("post", after_host=(hid,))
    sub.rowinit(6, ones=True)                     # barrier-gated wave
    return sub


def record_plain(seed: int = 3, device=None) -> BankedSubarray:
    """A minimal clean stream with NO host events (uniformly shiftable
    on the timeline -- the channel-overlap mutation needs that)."""
    sub = BankedSubarray(num_banks=2, num_rows=64, num_cols=64,
                         arch=PuDArch.UNMODIFIED, seed=seed, device=device)
    sub.alloc(4)
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 2**32, size=(3, sub.num_words), dtype=np.uint32)
    sub.host_write_rows(0, data)
    sub.trace.begin_segment("compute")
    sub.maj3_into_acc(0, 1, 2)
    sub.rowcopy(sub.G[0], 3)
    sub.trace.begin_segment("readout")
    sub.host_read_row(3)
    return sub


def record_read_then_reuse(seed: int = 5, device=None) -> BankedSubarray:
    """seg0 writes a row, seg1 reads it, seg2 overwrites it -- the
    WAR/WAW mutation substrate."""
    sub = BankedSubarray(num_banks=2, num_rows=64, num_cols=64,
                         arch=PuDArch.UNMODIFIED, seed=seed, device=device)
    r = sub.alloc(1)
    sub.host_write_row(r, np.zeros(sub.num_words, dtype=np.uint32))
    sub.trace.begin_segment("read")
    sub.host_read_row(r)
    sub.trace.begin_segment("reuse")
    sub.rowinit(r)
    return sub


def record_write_then_rewrite(seed: int = 7, device=None) -> BankedSubarray:
    """seg0 host-writes a row, seg1 rowinits it to ZERO, seg2 rowinits
    it to ONE -- the WAW mutation substrate (no reads at all)."""
    sub = BankedSubarray(num_banks=2, num_rows=64, num_cols=64,
                         arch=PuDArch.UNMODIFIED, seed=seed, device=device)
    r = sub.alloc(1)
    sub.host_write_row(r, np.zeros(sub.num_words, dtype=np.uint32))
    sub.trace.begin_segment("zero")
    sub.rowinit(r)
    sub.trace.begin_segment("one")
    sub.rowinit(r, ones=True)
    return sub


def stream_of(sub: BankedSubarray, label: str = "g0") -> GroupStream:
    return GroupStream.from_trace(label, sub.trace, _FOOTPRINT,
                                  sub.num_cols, machine=sub)


# --------------------------------------------------------------------- #
# Tuple surgery on GroupStream copies
# --------------------------------------------------------------------- #
def _find(stream: GroupStream, op: PuDOp, k: int = 0) -> int:
    hits = [i for i, o in enumerate(stream.ops) if o is op]
    return hits[k]


def _set_rows(stream: GroupStream, w: int, rows: tuple) -> GroupStream:
    new = list(stream.rows)
    new[w] = rows
    return replace(stream, rows=tuple(new))


def _del_wave(stream: GroupStream, w: int) -> GroupStream:
    drop = lambda t: t[:w] + t[w + 1:]  # noqa: E731 - local tuple helper
    return replace(stream, ops=drop(stream.ops), segs=drop(stream.segs),
                   rows=drop(stream.rows))


def _insert_wave(stream: GroupStream, w: int, op: PuDOp, rows: tuple,
                 sid: int) -> GroupStream:
    return replace(
        stream,
        ops=stream.ops[:w] + (op,) + stream.ops[w:],
        segs=stream.segs[:w] + (sid,) + stream.segs[w:],
        rows=stream.rows[:w] + (rows,) + stream.rows[w:])


def _set_after(stream: GroupStream, sid: int,
               after: tuple) -> GroupStream:
    segs = list(stream.segments)
    segs[sid] = replace(segs[sid], after=tuple(after))
    return replace(stream, segments=tuple(segs))


# --------------------------------------------------------------------- #
# Stream-level seeded violations (pudlint passes 1-2)
# --------------------------------------------------------------------- #
def mut_uninit_read(s: GroupStream) -> GroupStream:
    """Retarget a compute copy's source to a never-written data row."""
    w = _find(s, PuDOp.ROWCOPY)
    return _set_rows(s, w, (20, s.rows[w][1]))


def mut_const_write(s: GroupStream) -> GroupStream:
    """Land the Ambit merge result in ROW_ZERO."""
    w = _find(s, PuDOp.AND)
    a, b, _ = s.rows[w]
    return _set_rows(s, w, (a, b, s.num_rows - 1))


def mut_row_oob(s: GroupStream) -> GroupStream:
    """Point a readout past the subarray's last row."""
    w = _find(s, PuDOp.READ)
    return _set_rows(s, w, (s.num_rows + 3,))


def mut_drop_frac(s: GroupStream) -> GroupStream:
    """Delete the Frac wave that arms the APA."""
    return _del_wave(s, _find(s, PuDOp.FRAC))


def mut_wrong_arch(s: GroupStream) -> GroupStream:
    """Claim the stream ran on the other substrate."""
    other = (PuDArch.MODIFIED if s.arch is PuDArch.UNMODIFIED
             else PuDArch.UNMODIFIED)
    return replace(s, arch=other)


def mut_clobber_result(s: GroupStream) -> GroupStream:
    """Overwrite the Ambit merge result before anything reads it."""
    w = _find(s, PuDOp.AND)
    dst = s.rows[w][-1]
    return _insert_wave(s, w + 1, PuDOp.ROWINIT,
                        (s.num_rows - 1, dst), s.segs[w])


def mut_stale_staging(s: GroupStream) -> GroupStream:
    """Re-fire the Ambit merge without re-staging its operands."""
    w = _find(s, PuDOp.AND)
    return _insert_wave(s, w + 1, PuDOp.AND, s.rows[w], s.segs[w])


def mut_drop_edge_raw(s: GroupStream) -> GroupStream:
    """The readout segment forgets the compute segments it reads."""
    return _set_after(s, s.segs[_find(s, PuDOp.READ)], ())


def mut_skip_edge_war(s: GroupStream) -> GroupStream:
    """The reuse segment skips over the read segment it overwrites
    (applied to :func:`record_read_then_reuse`)."""
    return _set_after(s, s.segs[_find(s, PuDOp.ROWINIT)], (0,))


def mut_skip_edge_waw(s: GroupStream) -> GroupStream:
    """The second rewrite skips over the first (applied to
    :func:`record_write_then_rewrite`)."""
    return _set_after(s, s.segs[_find(s, PuDOp.ROWINIT, k=1)], (0,))


def mut_host_no_readout(s: GroupStream) -> GroupStream:
    """The host merge forgets the readout segment feeding it."""
    he = s.host_events[0]
    return replace(s, host_events=(replace(he, after=()),)
                   + s.host_events[1:])


def mut_dangling_dep(s: GroupStream) -> GroupStream:
    """A segment depends on a segment id that does not exist."""
    return _set_after(s, s.segs[_find(s, PuDOp.READ)], (77,))


def mut_dep_cycle(s: GroupStream) -> GroupStream:
    """Point the compute segment at the merge segment that (already)
    depends on it."""
    compute = s.segs[_find(s, PuDOp.ROWCOPY)]
    merge = s.segs[_find(s, PuDOp.AND)]
    return _set_after(s, compute, (merge,))


def mut_mract_overspan(s: GroupStream) -> GroupStream:
    """Oversize the MRACT span past the recorded capability."""
    w = _find(s, PuDOp.MRACT)
    src, dst, _ = s.rows[w]
    return _set_rows(s, w, (src, dst, (s.multi_row_act or 1) + 4))


#: name -> (builder of the good subarray, expected code, mutator).
STREAM_VIOLATIONS = {
    "read-uninit-row": (record_good, "PL101", mut_uninit_read),
    "write-const-row": (record_good, "PL102", mut_const_write),
    "row-out-of-bounds": (record_good, "PL103", mut_row_oob),
    "drop-frac-before-apa": (record_good, "PL104", mut_drop_frac),
    "wrong-arch-op": (record_good, "PL105", mut_wrong_arch),
    "clobber-unread-result": (record_good, "PL106", mut_clobber_result),
    "reread-consumed-staging": (record_good, "PL107", mut_stale_staging),
    "drop-dep-edge-raw": (record_good, "PL201", mut_drop_edge_raw),
    "skip-dep-edge-war": (record_read_then_reuse, "PL202",
                          mut_skip_edge_war),
    "skip-dep-edge-waw": (record_write_then_rewrite, "PL203",
                          mut_skip_edge_waw),
    "host-without-readout": (record_good, "PL204", mut_host_no_readout),
    "dangling-dep": (record_good, "PL205", mut_dangling_dep),
    "dep-cycle": (record_good, "PL206", mut_dep_cycle),
    "mract-overspan": (record_good, "PL301", mut_mract_overspan),
}


# --------------------------------------------------------------------- #
# Timeline-level seeded violations (pudlint pass 3)
# --------------------------------------------------------------------- #
def _clone_timeline(tl: Timeline, waves) -> Timeline:
    return Timeline(waves=list(waves), makespan_ns=tl.makespan_ns,
                    channel_busy_ns=dict(tl.channel_busy_ns),
                    group_busy_ns=dict(tl.group_busy_ns),
                    group_span_ns=dict(tl.group_span_ns),
                    group_elems=dict(tl.group_elems),
                    host_spans=list(tl.host_spans))


def mut_channel_overlap(tl: Timeline, streams) -> Timeline:
    """Uniformly shift the second group's waves onto the first group's
    span: every within-group constraint survives the rigid shift, but
    the two groups now fight over channel 0."""
    others = [w for w in tl.waves if w.group == streams[1].label]
    delta = min(w.start_ns for w in others) - min(
        w.start_ns for w in tl.waves if w.group == streams[0].label)
    waves = [w if w.group != streams[1].label else
             replace(w, start_ns=w.start_ns - delta,
                     end_ns=w.end_ns - delta)
             for w in tl.waves]
    return _clone_timeline(tl, waves)


def mut_wave_underrun(tl: Timeline, streams) -> Timeline:
    """Halve the APA wave's scheduled duration (shaving the tFAW/tRRD
    stagger that the charge-sharing mechanism needs)."""
    waves = list(tl.waves)
    k = next(i for i, w in enumerate(waves) if w.op is PuDOp.APA)
    w = waves[k]
    waves[k] = replace(w, end_ns=w.start_ns + w.duration_ns / 2)
    return _clone_timeline(tl, waves)


def mut_dep_time(tl: Timeline, streams) -> Timeline:
    """Launch the barrier-gated 'post' wave at t=0, before the host
    merge (and the segments it chains after) completed."""
    waves = list(tl.waves)
    k = next(i for i, w in enumerate(waves) if w.seg_label == "post")
    w = waves[k]
    waves[k] = replace(w, start_ns=0.0, end_ns=w.duration_ns)
    return _clone_timeline(tl, waves)


def mut_clone_io(tl: Timeline, streams) -> Timeline:
    """Report pin bytes on the in-DRAM MRACT clone wave."""
    waves = list(tl.waves)
    k = next(i for i, w in enumerate(waves) if w.op is PuDOp.MRACT)
    waves[k] = replace(waves[k], io_bytes=16.0)
    return _clone_timeline(tl, waves)


def mut_op_swap(tl: Timeline, streams) -> Timeline:
    """The timeline claims a different op than the recorded stream."""
    waves = list(tl.waves)
    k = next(i for i, w in enumerate(waves) if w.op is PuDOp.ROWCOPY)
    waves[k] = replace(waves[k], op=PuDOp.ROWCLONE)
    return _clone_timeline(tl, waves)


#: name -> (expected code, mutator(timeline, streams) -> timeline).
TIMELINE_VIOLATIONS = {
    "overlap-channel-hold": ("PL303", mut_channel_overlap),
    "shrink-wave-window": ("PL304", mut_wave_underrun),
    "jump-host-barrier": ("PL305", mut_dep_time),
    "clone-with-pin-bytes": ("PL306", mut_clone_io),
    "swap-scheduled-op": ("PL307", mut_op_swap),
}


# --------------------------------------------------------------------- #
# Device-level seeded violation (PL302)
# --------------------------------------------------------------------- #
def cross_channel_clone_report(device=None) -> LintReport:
    """Record a genuinely-invalid cross-channel clone on a 2-channel
    device and return its device-level lint report."""
    from repro_torch.core.device import PuDDevice

    from .pudlint import clone_confinement_diags

    dev = PuDDevice(PuDArch.UNMODIFIED, channels=2, ranks_per_channel=1,
                    banks_per_rank=4, num_rows=64, cols_per_bank=64,
                    device=device)
    a = dev.alloc_banks(2, channels=0, label="srcgrp")
    b = dev.alloc_banks(2, channels=1, label="dstgrp")
    a.alloc(2)
    b.alloc(2)
    a.host_write_rows(0, np.zeros((2, a.num_words), dtype=np.uint32))
    b.clone_rows_from(a, 0, 0, 2)      # clones cannot cross channels
    return LintReport(clone_confinement_diags(dev))


# --------------------------------------------------------------------- #
# Representation-level seeded violation (PL501)
# --------------------------------------------------------------------- #
def _representation_engine(device=None):
    """A small encoded column plus the :class:`ColumnPlan` it was
    actually encoded under."""
    from repro_torch.core.clutch import ClutchEngine
    from repro_torch.core.encoding import ColumnPlan

    sub = BankedSubarray(num_banks=1, num_rows=128, num_cols=64,
                         arch=PuDArch.UNMODIFIED, seed=11, device=device)
    plan = ColumnPlan(n_bits=8, num_chunks=2)
    eng = ClutchEngine(sub, np.arange(16, dtype=np.uint64), 8, plan=plan)
    return eng, plan


def stale_recode_report(device=None) -> LintReport:
    """Encode a column under one plan, then declare a DIFFERENT one for
    it -- the state a ``recode_column`` leaves behind when its
    evict/reload rebuild is skipped: the banks still hold the old LUT
    planes while the session plans against the new representation."""
    from repro_torch.core.encoding import ColumnPlan

    eng, _ = _representation_engine(device)
    declared = ColumnPlan(n_bits=4, num_chunks=2)  # the recode never landed
    return LintReport(representation_diags([eng], [declared], group="g0"))


# --------------------------------------------------------------------- #
# The harness
# --------------------------------------------------------------------- #
def seeded_violations(device=None):
    """Yield ``(name, expected_code, report)`` for every seeded
    violation class -- stream-level, timeline-level, and device-level.
    Baseline sanity is the caller's job via :func:`baseline_reports`."""
    for name, (build, code, mutate) in STREAM_VIOLATIONS.items():
        stream = stream_of(build(device=device))
        yield name, code, lint_stream(mutate(stream))
    sched = ChannelScheduler(SYS_CFG)
    good = stream_of(record_good(device=device), "g0")
    plain = replace(stream_of(record_plain(device=device), "g1"),
                    footprint={0: {0: 2}})
    streams = [good, plain]
    tl = sched.schedule(streams)
    for name, (code, mutate) in TIMELINE_VIOLATIONS.items():
        report = lint_timeline(mutate(tl, streams), sys_cfg=SYS_CFG,
                               streams=streams)
        yield name, code, report
    yield ("clone-across-channels", "PL302",
           cross_channel_clone_report(device))
    yield "stale-recode-planes", "PL501", stale_recode_report(device)


def baseline_reports(device=None):
    """Lint reports of every UNMUTATED artifact the harness uses --
    all must be clean, or the seeded detections prove nothing."""
    out = {}
    for build in (record_good, record_plain, record_read_then_reuse,
                  record_write_then_rewrite):
        out[build.__name__] = lint_stream(stream_of(build(device=device)))
    good = stream_of(record_good(device=device), "g0")
    plain = stream_of(record_plain(device=device), "g1")
    tl = ChannelScheduler(SYS_CFG).schedule([good, plain])
    out["scheduled_timeline"] = lint_timeline(
        tl, sys_cfg=SYS_CFG, streams=[good, plain])
    eng, plan = _representation_engine(device)
    out["representation_match"] = LintReport(
        representation_diags([eng], [plan], group="g0"))
    return out


def self_test(device=None) -> dict:
    """Run the whole harness with its subarrays on ``device``; returns a
    summary dict.  Raises AssertionError on any miss."""
    misses = []
    baselines = baseline_reports(device)
    for name, rep in baselines.items():
        if rep.diagnostics:
            misses.append(f"baseline {name} not clean: {rep.summary()}")
    detected = {}
    for name, code, report in seeded_violations(device):
        detected[name] = sorted(report.codes())
        if code not in report.codes():
            misses.append(
                f"{name}: expected {code}, got {detected[name] or 'nothing'}")
    if misses:
        raise AssertionError("pudlint self-test failed:\n  "
                             + "\n  ".join(misses))
    return {"classes": len(detected),
            "distinct_codes": len({c for cs in detected.values()
                                   for c in cs}),
            "detected": detected}
