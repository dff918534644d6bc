"""Per-channel DRAM command-bus scheduler for recorded PuD streams.

The machine layer records each bank group's command stream
(:class:`~repro_torch.core.machine.CommandTrace`); the device layer
knows which banks, hence channels and ranks, each group owns.  This
module turns the two into a scheduled device :class:`Timeline`:

* one command bus per channel; a wave holds every channel its group
  spans from its first ACT to its last bank's completion, so groups on
  one channel serialize and groups on disjoint channels overlap;
* within a wave, ACTs to a rank's banks stagger by ``max(tFAW/4,
  tRRD_L)``: a wave lasts ``(ACTs_per_op * max_rank_banks - 1) * gap +
  op latency``; READ/WRITE waves last their bytes over the channel's
  share of the bandwidth; in-DRAM bulk waves move no bytes;
* waves of a segment chain; a segment waits for its ``after`` segments
  and ``after_host`` host events; host events run on ``host_lanes``
  lanes per host domain (a ``parallelism`` hint may gang a node over
  several), same-label events across streams being one node, and a node
  joining several domains running on :data:`SHARED_HOST`;
* the earliest feasible start issues next, ties going to host nodes,
  then host I/O, then the least recently served group.

:func:`rekey_stream` moves a stream into a device's channel namespace for
joint fleet scheduling; :func:`federate_timelines` merges independently
scheduled timelines for reporting.

The reference package's ``core/scheduler.py`` under the same names, float
for float.  :meth:`ChannelScheduler.schedule` makes the same choice at
every step as the reference's, which rescans every segment of every
stream per step; here each stream keeps the set of its segments that are
ready and still hold waves, updated when a segment finishes or a host
node ends, so a step costs the ready frontier instead of the whole
history (a 4,096-instance GBDT job on 16 groups schedules ~70,000
waves).  Left out: ``Timeline.verify``, the reference's static verifier
(pudlint), not yet ported.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

from .machine import CommandTrace, HostEvent, PuDOp, Segment

#: Footprint of a group: {channel: {rank: number of the group's banks}}.
Footprint = dict[int, dict[int, int]]

#: Host domain of nodes that join streams of several domains (a
#: cross-device reduction runs on the shared host, never on one
#: device's local host).
SHARED_HOST = -1


@dataclass(frozen=True)
class GroupStream:
    """One bank group's recorded stream plus its physical placement.

    ``active_elems`` is the number of SIMD lanes the engine actually
    uses (e.g. real records in a padded shard); ``None`` means every
    column of every bank computes useful data.  ``host`` is the host
    domain the stream's host events run on (per-device hosts give each
    device's streams its own domain; the default puts everything on
    domain 0 -- one shared host).

    ``rows`` / ``num_rows`` / ``arch`` / ``multi_row_act`` /
    ``from_reset`` are machine metadata for a static verifier (the
    reference's pudlint, not yet ported): the per-wave row operands, the
    recording subarray's geometry and capability, and whether the
    stream starts from subarray reset (a trimmed mid-life job stream
    does not, so uninit-read analysis is skipped on it).  They default
    to "unknown" and never affect scheduling.
    """

    label: str
    footprint: Footprint
    cols_per_bank: int
    ops: tuple[PuDOp, ...]            # one entry per wave, record order
    segs: tuple[int, ...]             # segment id per wave
    segments: tuple[Segment, ...]     # segment table (id -> label, deps)
    host_events: tuple[HostEvent, ...] = ()
    active_elems: int | None = None
    host: int = 0                     # host domain (see module docstring)
    rows: tuple = ()                  # row operands per wave (lint meta)
    num_rows: int | None = None       # recording subarray's row count
    arch: object | None = None        # PuDArch of the recording subarray
    multi_row_act: int | None = None  # PULSAR capability at record time
    from_reset: bool = True           # stream starts at subarray reset?

    @property
    def banks(self) -> int:
        return sum(sum(r.values()) for r in self.footprint.values())

    @property
    def channels(self) -> tuple[int, ...]:
        return tuple(sorted(self.footprint))

    @property
    def elems(self) -> int:
        """SIMD lanes doing useful work (<= banks * cols_per_bank)."""
        if self.active_elems is not None:
            return self.active_elems
        return self.banks * self.cols_per_bank

    @staticmethod
    def from_trace(label: str, trace: CommandTrace, footprint: Footprint,
                   cols_per_bank: int,
                   active_elems: int | None = None,
                   machine=None) -> "GroupStream":
        """``machine`` (the recording
        :class:`~repro_torch.core.machine.BankedSubarray`) attaches the lint
        metadata -- row operands, geometry, arch, PULSAR capability,
        and the trace's from-reset flag."""
        meta: dict = {}
        if machine is not None:
            meta = dict(
                rows=tuple(e.rows for e in trace.entries),
                num_rows=machine.num_rows,
                arch=machine.arch,
                multi_row_act=machine.multi_row_act,
                from_reset=getattr(trace, "from_reset", True),
            )
        return GroupStream(
            label=label, footprint=footprint, cols_per_bank=cols_per_bank,
            ops=tuple(e.op for e in trace.entries),
            segs=tuple(e.seg for e in trace.entries),
            segments=tuple(trace.segments),
            host_events=tuple(trace.host_events),
            active_elems=active_elems,
            **meta,
        )


@dataclass(frozen=True)
class ScheduledWave:
    group: str
    op: PuDOp
    seg: int
    seg_label: str
    start_ns: float
    end_ns: float
    channels: tuple[int, ...]
    banks: int
    io_bytes: float = 0.0            # nonzero only for READ/WRITE waves
    rows: tuple = ()                 # recorded row operands (lint meta)

    @property
    def duration_ns(self) -> float:
        return self.end_ns - self.start_ns


@dataclass(frozen=True)
class HostSpan:
    """One scheduled host node (a merged host event).

    ``host`` is the domain it ran on (:data:`SHARED_HOST` for
    cross-domain joins); ``lanes`` lists every lane it occupied -- more
    than one only for gang-scheduled nodes (``parallelism`` hint), in
    which case ``duration_ns`` is the divided wall-clock and
    ``busy_ns`` the conserved total lane-time."""

    label: str
    start_ns: float
    end_ns: float
    host: int = 0
    lanes: tuple[int, ...] = (0,)

    @property
    def duration_ns(self) -> float:
        return self.end_ns - self.start_ns

    @property
    def busy_ns(self) -> float:
        """Total lane-time: wall-clock times the lanes occupied."""
        return self.duration_ns * len(self.lanes)


@dataclass
class Timeline:
    """A scheduled device execution: every wave -- and every host-lane
    span -- with absolute times.  ``makespan_ns`` covers both, so a
    stream ending in a host merge (or stalled on a host barrier) is not
    under-reported."""

    waves: list[ScheduledWave]
    makespan_ns: float
    channel_busy_ns: dict[int, float]
    group_busy_ns: dict[str, float]       # sum of each group's durations
    group_span_ns: dict[str, tuple[float, float]]
    group_elems: dict[str, int] = field(default_factory=dict)  # SIMD width
    host_spans: list[HostSpan] = field(default_factory=list)

    def channel_utilization(self, channel: int) -> float:
        if self.makespan_ns <= 0:
            return 0.0
        return self.channel_busy_ns.get(channel, 0.0) / self.makespan_ns

    @property
    def host_lane_busy_ns(self) -> dict[tuple[int, int], float]:
        """Busy time per ``(host domain, lane)`` -- the per-lane view
        of the host side of the schedule."""
        return lane_busy_from_spans(self.host_spans)

    @property
    def host_utilization(self) -> float:
        """Busy fraction of the BUSIEST host lane over the makespan:
        ~1.0 means a host lane is the pipeline ceiling (adding merge
        lanes or per-device hosts is what would help), ~0 means the
        host is never the bottleneck."""
        lanes = self.host_lane_busy_ns
        if self.makespan_ns <= 0 or not lanes:
            return 0.0
        return max(lanes.values()) / self.makespan_ns

    @property
    def host_wall_ns(self) -> float:
        """Wall-clock time during which ANY host lane is active (union
        of host spans) -- the complement of the makespan's host-idle
        time.  Equals ``host_busy_ns`` when one serial lane exists."""
        total = 0.0
        cur_s = cur_e = None
        for s, e in sorted((h.start_ns, h.end_ns) for h in self.host_spans):
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    total += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            total += cur_e - cur_s
        return total

    @property
    def device_span_ns(self) -> float:
        """End of the last device wave -- DRAM time only.  Throughput
        metrics normalized to scheduled DRAM time use this; it still
        includes any host bubble *between* waves (a barrier delays the
        dependent wave's start)."""
        return max((w.end_ns for w in self.waves), default=0.0)

    @property
    def host_busy_ns(self) -> float:
        """Total busy lane-time across every host lane of every domain
        (a gang-scheduled node counts once per lane it occupied)."""
        return sum(h.busy_ns for h in self.host_spans)

    def segment_spans(self) -> dict[tuple[str, str], tuple[float, float]]:
        """(group label, segment label) -> (first start, last end), for
        labeled segments only -- how apps map pipeline waves back to
        scheduled time."""
        spans: dict[tuple[str, str], tuple[float, float]] = {}
        for w in self.waves:
            if not w.seg_label:
                continue
            key = (w.group, w.seg_label)
            if key in spans:
                s, e = spans[key]
                spans[key] = (min(s, w.start_ns), max(e, w.end_ns))
            else:
                spans[key] = (w.start_ns, w.end_ns)
        return spans

    @property
    def serial_bound_ns(self) -> float:
        """Serialized upper bound: every wave back-to-back on one bus,
        every host event after all of them."""
        return sum(self.group_busy_ns.values()) + self.host_busy_ns

    @property
    def overlap_bound_ns(self) -> float:
        """Perfect-overlap lower bound: the slowest group alone, or the
        busiest host lane if that dominates (with one serial lane that
        is the whole host workload)."""
        return max(max(self.group_busy_ns.values(), default=0.0),
                   max(self.host_lane_busy_ns.values(), default=0.0))


def lane_busy_from_spans(spans) -> dict[tuple[int, int], float]:
    """Busy time per ``(host domain, lane)`` over a span list."""
    busy: dict[tuple[int, int], float] = {}
    for h in spans:
        for lane in h.lanes:
            key = (h.host, lane)
            busy[key] = busy.get(key, 0.0) + h.duration_ns
    return busy


def rekey_stream(stream: GroupStream, device_index: int,
                 stride: int, host: int | None = None) -> GroupStream:
    """Move a stream's footprint into device ``device_index``'s channel
    namespace (channel ``c`` -> ``device_index * stride + c``) for
    joint fleet scheduling: devices' buses stay independent while the
    :class:`ChannelScheduler` host lanes join them.  ``stride`` must be
    >= every device's channel count (callers use
    ``max(d.channels for d in devices)``) so namespaces never collide.
    ``host`` additionally moves the stream into that host domain
    (per-device hosts pass the device index; ``None`` keeps the
    stream's domain -- one shared host for the whole fleet).
    """
    from dataclasses import replace

    out = replace(stream, footprint={
        device_index * stride + c: dict(ranks)
        for c, ranks in stream.footprint.items()})
    if host is not None:
        out = replace(out, host=host)
    return out


def federate_timelines(timelines: list[Timeline],
                       merge_ns: float = 0.0,
                       merge_label: str = "federate:merge") -> Timeline:
    """Merge independently scheduled per-device timelines into one
    federated device-fleet timeline -- the serving-layer view of a
    query that fanned out over several :class:`PuDDevice`s.

    Devices are independent machines: their waves keep their absolute
    times and their channels are re-keyed (device ``i``'s channel ``c``
    becomes ``i * stride + c``) so per-channel busy accounting never
    collides.  Host work is the one shared resource: host spans carrying
    the same label on several devices are ONE logical host step (a merge
    that joined every device's readouts -- each device's scheduler saw
    only its local half) and are unified into a single span starting
    when the LAST device's inputs were ready (max of the per-device
    starts) and running for the step's true duration (max of the
    per-device durations -- each device recorded the same measured
    wall-clock, so this is NOT the inter-device schedule skew, which is
    idle waiting, not host work).  ``merge_ns`` appends the serving
    layer's own
    cross-device merge as a final host node after everything else --
    the federation merge node -- extending the makespan by the time the
    front end spent combining per-device results.

    Limitation -- this is a *reporting* merge, not a re-schedule: each
    device's waves keep the times its own scheduler assigned, so a
    wave that locally waited only for its device's copy of a shared
    merge may predate the unified span when devices are skewed.  When
    one host truly serves every device (a cross-device barrier must
    delay every device's dependent waves), schedule the fleet JOINTLY
    instead: :func:`rekey_stream` every device's streams into one
    :class:`ChannelScheduler` pass -- the session/executor job path
    does exactly that.

    Single-element input returns the timeline unchanged (no re-keying),
    so callers can federate unconditionally.
    """
    from dataclasses import replace

    if len(timelines) == 1:
        # nothing to unify: keep the timeline (and its host domains --
        # a jointly scheduled fleet timeline may carry several) intact,
        # at most appending the serving layer's merge node
        tl = timelines[0]
        if merge_ns <= 0.0:
            return tl
        spans = list(tl.host_spans)
        spans.append(HostSpan(merge_label, tl.makespan_ns,
                              tl.makespan_ns + merge_ns,
                              host=SHARED_HOST))
        return Timeline(
            waves=list(tl.waves), makespan_ns=tl.makespan_ns + merge_ns,
            channel_busy_ns=dict(tl.channel_busy_ns),
            group_busy_ns=dict(tl.group_busy_ns),
            group_span_ns=dict(tl.group_span_ns),
            group_elems=dict(tl.group_elems), host_spans=spans)
    stride = 1 + max((c for tl in timelines
                      for c in tl.channel_busy_ns), default=0)
    # re-key host domains like channels: device i's local domain d
    # becomes i * dstride + d, so two devices' hosts never share a
    # lane key even when each timeline carries several domains
    dstride = 1 + max((h.host for tl in timelines for h in tl.host_spans
                       if h.host != SHARED_HOST), default=0)
    waves: list[ScheduledWave] = []
    channel_busy: dict[int, float] = {}
    group_busy: dict[str, float] = {}
    group_span: dict[str, tuple[float, float]] = {}
    group_elems: dict[str, int] = {}
    merged_hosts: dict[str, dict] = {}
    for di, tl in enumerate(timelines):
        for w in tl.waves:
            waves.append(replace(
                w, channels=tuple(di * stride + c for c in w.channels)))
        for c, busy in tl.channel_busy_ns.items():
            channel_busy[di * stride + c] = busy
        group_busy.update(tl.group_busy_ns)
        group_span.update(tl.group_span_ns)
        group_elems.update(tl.group_elems)
        for h in tl.host_spans:
            dom = di * dstride + h.host if h.host != SHARED_HOST \
                else SHARED_HOST
            acc = merged_hosts.setdefault(h.label, {
                "start": h.start_ns, "dur": -1.0,
                "hosts": set(), "lanes": h.lanes})
            acc["start"] = max(acc["start"], h.start_ns)
            # the unified span runs for the LONGEST contributor's
            # duration; take that contributor's lanes too, so busy_ns
            # is its conserved lane-time regardless of input order
            # (ties broken toward the wider gang)
            if (h.duration_ns, len(h.lanes)) > (acc["dur"],
                                                len(acc["lanes"])):
                acc["dur"] = h.duration_ns
                acc["lanes"] = h.lanes
            acc["hosts"].add(dom)
    host_spans = []
    for label, acc in merged_hosts.items():
        # a span unified across devices is a fleet-wide host step
        dom = acc["hosts"].pop() if len(acc["hosts"]) == 1 \
            else SHARED_HOST
        host_spans.append(HostSpan(
            label, acc["start"], acc["start"] + acc["dur"],
            host=dom, lanes=acc["lanes"]))
    host_spans.sort(key=lambda h: h.start_ns)
    makespan = max(
        max((w.end_ns for w in waves), default=0.0),
        max((h.end_ns for h in host_spans), default=0.0))
    if merge_ns > 0.0:
        host_spans.append(
            HostSpan(merge_label, makespan, makespan + merge_ns,
                     host=SHARED_HOST))
        makespan += merge_ns
    return Timeline(waves=waves, makespan_ns=makespan,
                    channel_busy_ns=channel_busy, group_busy_ns=group_busy,
                    group_span_ns=group_span, group_elems=group_elems,
                    host_spans=host_spans)


class DependencyCycleError(RuntimeError):
    """The segment / host-event dependency graph of the scheduled
    streams contains a cycle (or an unresolvable reference), so no
    ready wave or host node exists and scheduling cannot make progress."""


class ChannelScheduler:
    """Schedules recorded group streams onto a SystemConfig's channels
    (and their host events onto ``host_lanes`` merge lanes per host
    domain)."""

    def __init__(self, sys_cfg) -> None:
        self.sys = sys_cfg
        t = sys_cfg.timings
        self._act_gap = max(t.tFAW / 4.0, t.tRRD_L)
        # Per-channel share of the device's peak off-chip bandwidth.
        self._channel_bw = sys_cfg.bandwidth_gbps / sys_cfg.channels
        # Concurrent host merge lanes (k=1: the old serial host).
        self.host_lanes = max(1, int(getattr(sys_cfg, "host_lanes", 1)))

    # ------------------------------------------------------------------ #
    def wave_duration_ns(self, op: PuDOp, stream: GroupStream) -> float:
        """Duration of one broadcast wave of ``stream`` (see bus model)."""
        from . import cost

        if op in (PuDOp.READ, PuDOp.WRITE):
            per_ch = [sum(ranks.values()) * stream.cols_per_bank / 8
                      for ranks in stream.footprint.values()]
            return max(per_ch) / self._channel_bw
        acts = cost.ACTS_PER_OP[op]
        stagger = max(
            (acts * max(ranks.values()) - 1) * self._act_gap
            for ranks in stream.footprint.values()
        )
        return stagger + cost.op_latency(op, self.sys.timings)

    def io_bytes(self, op: PuDOp, stream: GroupStream) -> float:
        if op not in (PuDOp.READ, PuDOp.WRITE):
            return 0.0
        return stream.banks * stream.cols_per_bank / 8

    def host_duration_ns(self, measured: float | None,
                         bytes_in: float) -> float:
        """Host node duration: measured wall-clock when the app recorded
        one, else ``bytes_in`` streamed once through host memory at the
        system's PER-LANE ``host_mem_gbps`` merge rate (the merge is
        one pass over the readout bytes, bandwidth-bound like the CPU
        baseline kernels).  Deliberately NOT scaled by ``host_lanes``:
        one serial merge never runs faster because idle lanes exist, so
        a merge split across k lanes (per-shard events, or a
        ``parallelism`` gang) conserves total busy lane-time -- the
        bytes pay the per-lane rate wherever they land.  A host-side
        rate -- not any function of the DRAM channel topology -- so
        resizing the device's channels never changes modeled host-merge
        speed."""
        if measured is not None:
            return measured
        return bytes_in / self.sys.host_mem_gbps

    # ------------------------------------------------------------------ #
    def predict_makespan(self, streams: list[GroupStream],
                         by_segment: bool = False):
        """Admission-time makespan prediction for the serving layer.

        Prediction and scheduling are the SAME deterministic
        computation -- this entry point exists so serving code
        (deadline-aware batch formation in
        :mod:`repro_torch.serve.batcher`, config evaluation in
        :mod:`repro_torch.serve.autoscaler`) can ask "how long would these
        streams take under this ``SystemConfig``" without executing a
        single wave, and so a committed batch's timeline always
        matches its admission-time prediction exactly.

        Returns the predicted makespan in ns; with ``by_segment`` it
        returns ``(makespan_ns, spans)`` where ``spans`` maps ``(group
        label, segment label)`` to ``(start, end)`` -- the per-request
        completion times a batcher attributes deadline budgets
        against."""
        timeline = self.schedule(streams)
        if by_segment:
            return timeline.makespan_ns, timeline.segment_spans()
        return timeline.makespan_ns

    def schedule(self, streams: list[GroupStream]) -> Timeline:
        channel_free: dict[int, float] = {}
        scheduled: list[ScheduledWave] = []
        host_spans: list[HostSpan] = []
        group_busy = {s.label: 0.0 for s in streams}
        group_span: dict[str, tuple[float, float]] = {}
        group_last_served = {i: -1 for i in range(len(streams))}
        serve_counter = 0

        # Per (group, segment) wave queues in record order.
        queues: list[dict[int, deque]] = []
        for s in streams:
            q: dict[int, deque] = {}
            for w, sid in enumerate(s.segs):
                q.setdefault(sid, deque()).append(w)
            queues.append(q)
        # Per (group, seg): waves left, end time, and the end of the last
        # scheduled wave inside the segment.
        seg_left = [
            {sid: len(ws) for sid, ws in q.items()} for q in queues
        ]
        seg_end = [dict.fromkeys(q, 0.0) for q in queues]
        seg_prev_end = [dict.fromkeys(q, None) for q in queues]

        def expand_deps(gi: int, after, after_host):
            """Resolve deps to wave-bearing segments, transitively
            skipping segments that never emitted a wave -- but
            inheriting those segments' own host deps so a barrier on an
            empty segment still binds."""
            segs: list[int] = []
            hosts: list[int] = list(after_host)
            seen: set[int] = set()
            stack = list(after)
            table = streams[gi].segments
            while stack:
                d = stack.pop()
                if d in seen:
                    continue
                seen.add(d)
                if d in queues[gi]:
                    segs.append(d)
                else:
                    hosts.extend(table[d].after_host)
                    stack.extend(table[d].after)
            return tuple(segs), tuple(dict.fromkeys(hosts))

        # ---- merged host nodes (same label across groups == one) ----- #
        nodes: dict[str, dict] = {}
        node_key: list[dict[int, str]] = []
        for gi, s in enumerate(streams):
            node_key.append({h.hid: h.label or f"{s.label}#h{h.hid}"
                             for h in s.host_events})
        for gi, s in enumerate(streams):
            for h in s.host_events:
                key = node_key[gi][h.hid]
                n = nodes.setdefault(key, {
                    "label": h.label or key, "seg_deps": set(),
                    "host_deps": set(), "measured": None, "bytes": 0.0,
                    "par": 1, "domains": set()})
                segs, hosts = expand_deps(gi, h.after, h.after_host)
                n["seg_deps"] |= {(gi, d) for d in segs}
                n["host_deps"] |= {node_key[gi][x] for x in hosts}
                n["host_deps"].discard(key)
                if h.duration_ns is not None:
                    n["measured"] = max(n["measured"] or 0.0, h.duration_ns)
                n["bytes"] += h.bytes_in
                n["par"] = max(n["par"], h.parallelism)
                n["domains"].add(s.host)
        for n in nodes.values():
            # a node joining several host domains is a cross-device
            # step: it runs on the shared host, not any device's own
            n["dom"] = (next(iter(n["domains"]))
                        if len(n["domains"]) == 1 else SHARED_HOST)

        # Effective per-segment deps (wave-bearing segments + host keys).
        eff_after: list[dict[int, tuple[int, ...]]] = []
        eff_host: list[dict[int, tuple[str, ...]]] = []
        for gi, s in enumerate(streams):
            ea: dict[int, tuple[int, ...]] = {}
            eh: dict[int, tuple[str, ...]] = {}
            for sid in queues[gi]:
                segs, hosts = expand_deps(
                    gi, s.segments[sid].after, s.segments[sid].after_host)
                ea[sid] = segs
                eh[sid] = tuple(node_key[gi][x] for x in hosts)
            eff_after.append(ea)
            eff_host.append(eh)

        node_end: dict[str, float] = {}
        pending_nodes = set(nodes)
        # Per-domain host lanes: each domain (one shared host, or one
        # host per device, plus SHARED_HOST for cross-domain joins)
        # owns `host_lanes` lanes, free at the recorded times.
        lane_free: dict[int, list[float]] = {}

        def seg_dep_end(gi: int, sid: int) -> float:
            t = max((seg_end[gi][d] for d in eff_after[gi][sid]),
                    default=0.0)
            return max(t, max((node_end[k] for k in eff_host[gi][sid]),
                              default=0.0))

        def node_plan(key: str) -> tuple[float, float, tuple[int, ...]]:
            """(start, end, lanes) for a ready node: earliest-start
            list scheduling over its domain's lanes.  A node with a
            ``parallelism`` hint p may gang over m <= min(p, k) lanes
            (wall / m, busy conserved); of the feasible widths the one
            finishing EARLIEST wins."""
            n = nodes[key]
            dep = 0.0
            for gi, d in n["seg_deps"]:
                dep = max(dep, seg_end[gi][d])
            for k in n["host_deps"]:
                dep = max(dep, node_end[k])
            lanes = lane_free.setdefault(
                n["dom"], [0.0] * self.host_lanes)
            order = sorted(range(len(lanes)),
                           key=lambda i: (lanes[i], i))
            dur = self.host_duration_ns(n["measured"], n["bytes"])
            best = None
            for m in range(1, min(max(1, n["par"]), len(lanes)) + 1):
                start = max(dep, lanes[order[m - 1]])
                cand = (start + dur / m, start, m)
                if best is None or cand < best:
                    best = cand
            end, start, m = best
            return start, end, tuple(sorted(order[:m]))

        # Readiness by counting: every segment and node waits on a set of
        # segments (done when their last wave is scheduled) and host
        # nodes (done when scheduled); each done dependency releases its
        # dependents.  ``ready_segs[gi]`` holds the group's ready
        # segments that still have waves, ``ready_nodes`` the ready
        # pending host nodes -- exactly what the reference's per-step
        # scan finds ready.  Their candidates are cached and recomputed
        # only when an input changes: a ready node's plan depends on its
        # domain's lanes alone (its dependencies have ended), a group's
        # best wave on its ready segments, the bus of its channels and
        # its own last service.  The step then picks the least of the
        # same candidate tuples the reference compares.
        waiting: dict[tuple, int] = {}
        released_by: dict[tuple, list[tuple]] = {}
        ready_segs: list[set[int]] = [set() for _ in streams]
        ready_nodes: set[str] = set()
        new_nodes: list[str] = []
        dirty_groups: set[int] = set(range(len(streams)))
        chan_groups: dict[int, set[int]] = {}
        for gi, s in enumerate(streams):
            for c in s.channels:
                chan_groups.setdefault(c, set()).add(gi)
        sharing = [set().union(*(chan_groups[c] for c in s.channels))
                   | {gi} for gi, s in enumerate(streams)]

        def mark_ready(item: tuple) -> None:
            if item[0] == "seg":
                ready_segs[item[1]].add(item[2])
                dirty_groups.add(item[1])
            else:
                ready_nodes.add(item[1])
                new_nodes.append(item[1])

        def watch(item: tuple, deps: set) -> None:
            waiting[item] = len(deps)
            for d in deps:
                released_by.setdefault(d, []).append(item)
            if not deps:
                mark_ready(item)

        def release(dep: tuple) -> None:
            for item in released_by.get(dep, ()):
                waiting[item] -= 1
                if waiting[item] == 0:
                    mark_ready(item)

        for gi in range(len(streams)):
            for sid in queues[gi]:
                watch(("seg", gi, sid),
                      {("seg", gi, d) for d in eff_after[gi][sid]}
                      | {("node", k) for k in eff_host[gi][sid]})
        for key, n in nodes.items():
            watch(("node", key),
                  {("seg", gi, d) for gi, d in n["seg_deps"]}
                  | {("node", k) for k in n["host_deps"]})

        def group_candidate(gi: int):
            s = streams[gi]
            if not ready_segs[gi]:
                return None
            bus = max((channel_free.get(c, 0.0) for c in s.channels),
                      default=0.0)
            best = None
            for sid in ready_segs[gi]:
                w = queues[gi][sid][0]
                op = s.ops[w]
                prev = seg_prev_end[gi][sid]
                dep = seg_dep_end(gi, sid) if prev is None else prev
                start = max(dep, bus)
                is_io = op in (PuDOp.READ, PuDOp.WRITE)
                cand = (start, not is_io, group_last_served[gi], gi, sid)
                if best is None or cand < best[0]:
                    best = (cand, "wave", gi, sid, (w, op), start)
            return best

        plans: dict[str, tuple] = {}
        host_best = None
        replan = False
        group_best: list = [None] * len(streams)
        remaining = sum(len(s.ops) for s in streams)
        while remaining or pending_nodes:
            if replan:
                # the lanes of the last node's domain moved: replan it
                for key in ready_nodes:
                    if key not in plans or nodes[key]["dom"] == replan_dom:
                        plans[key] = node_plan(key)
                host_best = min(
                    ((p[0], -1, 0, -1, key), key) for key, p in plans.items()
                ) if plans else None
                replan = False
            else:
                for key in new_nodes:
                    plans[key] = node_plan(key)
                    cand = ((plans[key][0], -1, 0, -1, key), key)
                    if host_best is None or cand < host_best:
                        host_best = cand
            new_nodes.clear()
            for gi in dirty_groups:
                group_best[gi] = group_candidate(gi)
            dirty_groups.clear()
            best = None
            if host_best is not None:
                key = host_best[1]
                best = (host_best[0], "host", key, None, None, plans[key])
            for g in group_best:
                if g is not None and (best is None or g[0] < best[0]):
                    best = g
            if best is None:
                raise DependencyCycleError(
                    "no ready wave or host node: dependency cycle (or "
                    "unresolvable reference) in stream segments / host "
                    "events")
            if best[1] == "host":
                _, _, key, _, _, (start, end, node_lanes) = best
                dom = nodes[key]["dom"]
                host_spans.append(
                    HostSpan(nodes[key]["label"], start, end,
                             host=dom, lanes=node_lanes))
                node_end[key] = end
                for lane in node_lanes:
                    lane_free[dom][lane] = end
                pending_nodes.remove(key)
                ready_nodes.remove(key)
                del plans[key]
                replan, replan_dom = True, dom
                release(("node", key))
                continue
            _, _, gi, sid, (w, op), start = best
            s = streams[gi]
            dur = self.wave_duration_ns(op, s)
            end = start + dur
            scheduled.append(ScheduledWave(
                group=s.label, op=op, seg=sid,
                seg_label=s.segments[sid].label,
                start_ns=start, end_ns=end, channels=s.channels,
                banks=s.banks, io_bytes=self.io_bytes(op, s),
                rows=s.rows[w] if w < len(s.rows) else ()))
            for c in s.channels:
                channel_free[c] = end
            dirty_groups |= sharing[gi]
            queues[gi][sid].popleft()
            seg_left[gi][sid] -= 1
            seg_end[gi][sid] = max(seg_end[gi][sid], end)
            seg_prev_end[gi][sid] = end
            if seg_left[gi][sid] == 0:
                ready_segs[gi].discard(sid)
                release(("seg", gi, sid))
            group_busy[s.label] += dur
            lo, hi = group_span.get(s.label, (start, end))
            group_span[s.label] = (min(lo, start), max(hi, end))
            group_last_served[gi] = serve_counter
            serve_counter += 1
            remaining -= 1

        host_spans.sort(key=lambda h: h.start_ns)
        makespan = max(
            max((w.end_ns for w in scheduled), default=0.0),
            max((h.end_ns for h in host_spans), default=0.0))
        busy: dict[int, float] = {}
        for w in scheduled:
            for c in w.channels:
                busy[c] = busy.get(c, 0.0) + w.duration_ns
        return Timeline(waves=scheduled, makespan_ns=makespan,
                        channel_busy_ns=busy, group_busy_ns=group_busy,
                        group_span_ns=group_span,
                        group_elems={s.label: s.elems for s in streams},
                        host_spans=host_spans)
