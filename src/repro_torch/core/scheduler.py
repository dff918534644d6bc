"""Per-channel DRAM command-bus scheduler for recorded PuD streams: the
makespan the representation planner minimizes.

The reference package's ``core/scheduler.py`` under the same names, with
its order of operations kept, so a probe's makespan equals the
reference's float for float.  The bus model, in brief:

* one command bus per channel; a wave holds every channel its group
  spans from its first ACT to its last bank's completion, so groups on
  one channel serialize and groups on disjoint channels overlap;
* within a wave, ACTs to a rank's banks stagger by ``max(tFAW/4,
  tRRD_L)``: a wave lasts ``(ACTs_per_op * max_rank_banks - 1) * gap +
  op latency``; READ/WRITE waves last their bytes over the channel's
  share of the bandwidth;
* waves of a segment chain; a segment waits for its ``after`` segments
  and ``after_host`` host events; host events run on ``host_lanes``
  lanes per host domain, same-label events across streams being one
  node;
* the earliest feasible start issues next, ties going to host nodes,
  then host I/O, then the least recently served group.

Left out: ``Timeline.verify`` (the reference's static verifier, which
the port does not have), the timeline's derived views,
``rekey_stream``, ``federate_timelines`` and ``predict_makespan``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .machine import CommandTrace, HostEvent, PuDOp, Segment

#: Footprint of a group: {channel: {rank: number of the group's banks}}.
Footprint = dict[int, dict[int, int]]

#: Host domain of nodes that join streams of several domains.
SHARED_HOST = -1


@dataclass(frozen=True)
class GroupStream:
    """One bank group's recorded stream plus its physical placement.
    ``active_elems`` is the SIMD lanes doing useful work (``None``:
    every column of every bank); ``host`` the host domain its host
    events run on."""

    label: str
    footprint: Footprint
    cols_per_bank: int
    ops: tuple[PuDOp, ...]            # one entry per wave, record order
    segs: tuple[int, ...]             # segment id per wave
    segments: tuple[Segment, ...]     # segment table (id -> label, deps)
    host_events: tuple[HostEvent, ...] = ()
    active_elems: int | None = None
    host: int = 0

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
                   active_elems: int | None = None) -> "GroupStream":
        return GroupStream(
            label=label, footprint=footprint, cols_per_bank=cols_per_bank,
            ops=tuple(e.op for e in trace.entries),
            segs=tuple(e.seg for e in trace.entries),
            segments=tuple(trace.segments),
            host_events=tuple(trace.host_events),
            active_elems=active_elems,
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

    @property
    def duration_ns(self) -> float:
        return self.end_ns - self.start_ns


@dataclass(frozen=True)
class HostSpan:
    """One scheduled host node: the domain it ran on and every lane it
    occupied (more than one for a ganged node)."""

    label: str
    start_ns: float
    end_ns: float
    host: int = 0
    lanes: tuple[int, ...] = (0,)


@dataclass
class Timeline:
    """A scheduled execution: every wave and host span with absolute
    times; ``makespan_ns`` covers both."""

    waves: list[ScheduledWave]
    makespan_ns: float
    channel_busy_ns: dict[int, float]
    group_busy_ns: dict[str, float]       # sum of each group's durations
    group_span_ns: dict[str, tuple[float, float]]
    group_elems: dict[str, int] = field(default_factory=dict)  # SIMD width
    host_spans: list[HostSpan] = field(default_factory=list)


class DependencyCycleError(RuntimeError):
    """The segment / host-event dependency graph of the scheduled
    streams has a cycle (or an unresolvable reference), so no wave or
    host node is ever ready."""


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
        self.host_lanes = max(1, int(getattr(sys_cfg, "host_lanes", 1)))

    def wave_duration_ns(self, op: PuDOp, stream: GroupStream) -> float:
        """Duration of one broadcast wave of ``stream``."""
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
        """Host node duration: the measured wall-clock, else ``bytes_in``
        at the PER-LANE ``host_mem_gbps`` rate (one serial merge never
        speeds up because idle lanes exist)."""
        if measured is not None:
            return measured
        return bytes_in / self.sys.host_mem_gbps

    def schedule(self, streams: list[GroupStream]) -> Timeline:
        channel_free: dict[int, float] = {}
        scheduled: list[ScheduledWave] = []
        host_spans: list[HostSpan] = []
        group_busy = {s.label: 0.0 for s in streams}
        group_span: dict[str, tuple[float, float]] = {}
        group_last_served = {i: -1 for i in range(len(streams))}
        serve_counter = 0

        # Per (group, segment) wave queues in record order.
        queues: list[dict[int, list[int]]] = []
        for s in streams:
            q: dict[int, list[int]] = {}
            for w, sid in enumerate(s.segs):
                q.setdefault(sid, []).append(w)
            queues.append(q)
        # Dependency bookkeeping: per (group, seg): waves left, end time,
        # and the end of the last scheduled wave inside the segment.
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

        def seg_ready(gi: int, sid: int) -> bool:
            return (all(seg_left[gi][d] == 0 for d in eff_after[gi][sid])
                    and all(k in node_end for k in eff_host[gi][sid]))

        def seg_dep_end(gi: int, sid: int) -> float:
            t = max((seg_end[gi][d] for d in eff_after[gi][sid]),
                    default=0.0)
            return max(t, max((node_end[k] for k in eff_host[gi][sid]),
                              default=0.0))

        def node_ready(key: str) -> bool:
            n = nodes[key]
            return (all(seg_left[gi][d] == 0 for gi, d in n["seg_deps"])
                    and all(k in node_end for k in n["host_deps"]))

        def node_plan(key: str) -> tuple[float, float, tuple[int, ...]]:
            """(start, end, lanes) for a ready node: earliest-start
            list scheduling over its domain's lanes.  A node with a
            ``parallelism`` hint p may gang over m <= min(p, k) lanes
            (wall / m, busy conserved); of the feasible widths the one
            finishing EARLIEST wins (a wide gang that must wait for a
            busy lane can lose to a narrow one that starts now)."""
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

        remaining = sum(len(s.ops) for s in streams)
        while remaining or pending_nodes:
            best = None
            for key in pending_nodes:
                if not node_ready(key):
                    continue
                plan = node_plan(key)
                cand = (plan[0], -1, 0, -1, key)
                if best is None or cand < best[0]:
                    best = (cand, "host", key, None, None, plan)
            for gi, s in enumerate(streams):
                for sid, ws in queues[gi].items():
                    if not ws or not seg_ready(gi, sid):
                        continue
                    w = ws[0]
                    op = s.ops[w]
                    prev = seg_prev_end[gi][sid]
                    dep = seg_dep_end(gi, sid) if prev is None else prev
                    bus = max((channel_free.get(c, 0.0)
                               for c in s.channels), default=0.0)
                    start = max(dep, bus)
                    is_io = op in (PuDOp.READ, PuDOp.WRITE)
                    cand = (start, not is_io, group_last_served[gi], gi, sid)
                    if best is None or cand < best[0]:
                        best = (cand, "wave", gi, sid, (w, op), start)
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
                continue
            _, _, gi, sid, (w, op), start = best
            s = streams[gi]
            dur = self.wave_duration_ns(op, s)
            end = start + dur
            scheduled.append(ScheduledWave(
                group=s.label, op=op, seg=sid,
                seg_label=s.segments[sid].label,
                start_ns=start, end_ns=end, channels=s.channels,
                banks=s.banks, io_bytes=self.io_bytes(op, s)))
            for c in s.channels:
                channel_free[c] = end
            queues[gi][sid].pop(0)
            seg_left[gi][sid] -= 1
            seg_end[gi][sid] = max(seg_end[gi][sid], end)
            seg_prev_end[gi][sid] = end
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
