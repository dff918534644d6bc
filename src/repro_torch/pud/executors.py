"""Internal executors behind :class:`repro_torch.pud.PudSession`'s
machine backend.

* :class:`QueryBatchExecutor` -- a table record-sharded across devices,
  then across ``shards_per_device`` channel-spread bank groups per
  device; a query batch runs double-buffered (query N's readout and
  merge overlap query N+1's waves), and every merge joins ALL shards'
  bitmaps, so Q4/Q5 aggregates (and Q5's host-barrier phase-2 scalar)
  are over the global table.  Compounds merge their term bitmaps with
  Ambit waves in the banks (``merge="dram"``) or read every term out
  (``merge="host"``).
* :class:`GbdtBatchExecutor` -- forest replicas on every device
  (``groups_per_device`` each); a wave spreads its instances over all
  groups, and with ``replicate="rowclone"`` only each (device,
  channel)'s first replica is host-loaded, the rest cloned in-DRAM.

Every job is scheduled jointly across the fleet: device channels are
re-keyed into their own namespaces, merges are recorded as reduction
trees (per-shard leaves on the host's lanes, one root join), and with
``hosts="per-device"`` each device's leaves run on its own host.
Timelines are job-scoped: :meth:`_FederatedExecutor.schedule` trims each
stream to what the current job recorded.  ``fused_config`` is the
layout recipe the card's fused executors build from, so both backends
evaluate identical shapes.

Measured host merge times enter the modeled timelines.  On the card,
every readout (``host_read_row``) waits for the queued waves and copies
the row to the host before the merge's timer starts, so the timers hold
host work only, never the card's simulation of the waves.

The reference package's ``pud/executors.py`` under the same names.
"""

from __future__ import annotations

import math
import time
from dataclasses import replace

import numpy as np

# NOTE: repro_torch.apps imports stay lazy (inside methods): importing this
# module must not pull in the whole app layer -- sessions import it for
# planning long before any engine is built.

from repro_torch.core.scheduler import (
    ChannelScheduler,
    GroupStream,
    Timeline,
    federate_timelines,
    rekey_stream,
)


class _FederatedExecutor:
    """Shared device-fleet plumbing: joint fleet scheduling with
    job-scoped streams, and the (device, bank-group) placement list the
    planner frees.

    ``hosts`` selects the fleet's host model: ``"shared"`` (default)
    schedules every device's merges on ONE host's ``host_lanes`` lanes;
    ``"per-device"`` gives each device its own host (its shards' merge
    leaves run on that device's local lanes) with only cross-device
    reduction-tree joins on the shared host.  ``merge_tree`` controls
    the recorded host structure: ``True`` records one merge event per
    shard plus an explicit reduction-tree join (independent shard
    merges can spread across lanes; dependent waves wait on the tree
    root), ``False`` keeps the monolithic one-node-per-wave
    recording (with a ``parallelism`` hint so a multi-lane host can
    still gang it)."""

    def __init__(self, devices, hosts: str = "shared",
                 merge_tree: bool = True) -> None:
        devices = list(devices) if isinstance(devices, (list, tuple)) \
            else [devices]
        if not devices:
            raise ValueError("need at least one device")
        if hosts not in ("shared", "per-device"):
            raise ValueError(
                f"hosts must be 'shared' or 'per-device', got {hosts!r}")
        self.devices = devices
        self.hosts = hosts
        self.merge_tree = merge_tree
        #: [(device, BankedSubarray)] of every group this executor placed;
        #: the placement planner frees exactly these on evict/release.
        self.placements: list[tuple[object, object]] = []
        self._marks: list[tuple[int, int]] = []

    def _mark_job_start(self) -> None:
        """Watermark every engine's trace: the current job's streams
        are everything recorded after this point.  Batches record no
        dependencies on earlier batches' segments' *host events* (each
        run re-seeds its chains), so the trimmed streams are
        dependency-complete."""
        self._marks = [
            (len(e.sub.trace.entries), len(e.sub.trace.host_events))
            for e in self.engines]

    def _job_streams(self) -> list[GroupStream]:
        """One :class:`GroupStream` per engine, trimmed to the current
        job's waves/host events and re-keyed into its device's channel
        namespace (device ``i``'s channel ``c`` -> ``i * stride + c``).
        Before any job ran, streams are untrimmed (the full recorded
        history, LUT loads included)."""
        marks = self._marks or [(0, 0)] * len(self.engines)
        stride = max(d.channels for d in self.devices)
        per_dev = len(self.engines) // len(self.devices)
        out = []
        for i, (eng, (dev, sub), (e0, h0)) in enumerate(
                zip(self.engines, self.placements, marks)):
            tr = sub.trace
            group = next(g for g in dev.groups if g.sub is sub)
            kept = {h.hid for h in tr.host_events[h0:]}
            stream = GroupStream(
                label=eng.label,
                footprint=dev.footprint(group),
                cols_per_bank=sub.num_cols,
                ops=tuple(e.op for e in tr.entries[e0:]),
                segs=tuple(e.seg for e in tr.entries[e0:]),
                # keep the full segment table (trimmed waves reference
                # their sids), but drop barriers on pre-job host events
                # -- that work is already done by the time the job runs
                segments=tuple(
                    replace(s, after_host=tuple(
                        h for h in s.after_host if h in kept))
                    for s in tr.segments),
                host_events=tuple(
                    replace(h, after_host=tuple(
                        x for x in h.after_host if x in kept))
                    for h in tr.host_events[h0:]),
                active_elems=group.active_elems,
                # lint metadata: a trimmed mid-life stream is not
                # from-reset (its rows were loaded by earlier waves)
                rows=tuple(e.rows for e in tr.entries[e0:]),
                num_rows=sub.num_rows,
                arch=sub.arch,
                multi_row_act=sub.multi_row_act,
                from_reset=(e0 == 0 and h0 == 0 and tr.from_reset))
            di = i // per_dev
            out.append(rekey_stream(
                stream, di, stride,
                host=di if self.hosts == "per-device" else 0))
        return out

    def schedule(self, sys_cfg, merge_ns: float = 0.0) -> Timeline:
        """Jointly schedule the current job's streams across the whole
        fleet (serving-layer merge node appended when ``merge_ns`` >
        0)."""
        timeline = ChannelScheduler(sys_cfg).schedule(self._job_streams())
        if merge_ns > 0.0:
            timeline = federate_timelines([timeline], merge_ns=merge_ns)
        return timeline

    def last_stats(self, sys_cfg, timeline=None):
        """Project the last batch's waves + measured host merges into
        pipeline totals.  ``timeline`` reuses an existing (fleet)
        schedule; by default the job is (re)scheduled."""
        from repro_torch.apps.pipeline import stats_from_timeline

        if timeline is None:
            timeline = self.schedule(sys_cfg)
        return stats_from_timeline(
            timeline, [e.label for e in self.engines],
            self._last_tags, self._last_host.samples_ns)


class QueryBatchExecutor(_FederatedExecutor):
    """Q1-Q5 over a table record-sharded across a device fleet, with the
    async host/PuD query pipeline.

    The table is split record-wise into ``len(devices) *
    shards_per_device`` sub-tables; shard ``s`` lives on device
    ``s // shards_per_device`` in its own
    :class:`~repro_torch.apps.predicate.PudQueryEngine` bank group, placed
    round-robin over that device's channels.  :meth:`run` executes a
    batch of queries double-buffered: query N+1's WHERE streams are
    issued on every shard before query N's parked bitmaps are read back
    and merged host-side, so the host work overlaps PuD execution and
    shard readouts overlap other channels' compute in each device's bus
    scheduler.  Each wave's merge is recorded as a reduction TREE: one
    per-shard merge leaf gated on that shard's readout (independent
    leaves spread across the host's merge lanes) plus a root join
    under one label shared by every shard's trace (one node joining
    all leaves -- across devices too).  Q5's second phase takes its
    scalar from the first phase's root join over the GLOBAL bitmap (a
    host barrier): the dependent wave is created during that merge AND
    declares the ROOT via ``after_host``, so the scheduled timeline --
    not just the record order -- contains the pipeline bubble.

    Queries are tuples: ``("q1", fi, x0, x1)``, ``("q2"|"q3", fi, x0,
    x1, fj, y0, y1)``, ``("q4", fk, fi, x0, x1, fj, y0, y1)``,
    ``("q5", fl, fk, fi, x0, x1, fj, y0, y1)`` -- results match the
    ``reference_*`` functions element-for-element (sessions build them
    from :mod:`repro_torch.pud.queries` descriptions).
    """

    _uid = 0

    def __init__(self, table, arch, devices, shards_per_device: int = 2,
                 method: str = "clutch", num_chunks: int | None = None,
                 cols_per_bank: int = 65536, channels="auto",
                 hosts: str = "shared", merge_tree: bool = True,
                 plans=None) -> None:
        from repro_torch.apps.predicate import PudQueryEngine, Table

        super().__init__(devices, hosts=hosts, merge_tree=merge_tree)
        if shards_per_device < 1:
            raise ValueError("need at least one shard per device")
        QueryBatchExecutor._uid += 1
        self._tag = f"query.p{QueryBatchExecutor._uid}"
        self.table = table
        #: per-column ColumnPlans (heterogeneous representation) or None
        #: for the uniform default; every shard engine gets the same
        #: tuple, and the fused backend keys its compile cache on it.
        self.plans = tuple(plans) if plans is not None else None
        num_shards = len(self.devices) * shards_per_device
        n = table.num_records
        per = math.ceil(n / num_shards)
        self.bounds = [(s * per, min((s + 1) * per, n))
                       for s in range(num_shards)]
        self.engines = []
        for s, (lo, hi) in enumerate(self.bounds):
            dev = self.devices[s // shards_per_device]
            # "auto" spreads shards round-robin over the device's
            # channels (disjoint buses overlap in the scheduler); any
            # other value is a device placement policy passed through.
            ch = (s % shards_per_device) % dev.channels \
                if channels == "auto" else channels
            eng = PudQueryEngine(
                Table(table.n_bits, [f[lo:hi] for f in table.features]),
                arch, method, num_chunks=num_chunks, device=dev,
                channels=ch, plans=self.plans,
                label=f"{self._tag}.s{s}", cols_per_bank=cols_per_bank)
            self.engines.append(eng)
            self.placements.append((dev, eng.sub))
        self._batch = 0
        self._last_tags: list[list[str]] = []
        #: query index owning each pipeline wave of the LAST batch
        #: (parallel to ``last_stats().wave_done_ns``): a Q5 owns both
        #: its phase-1 wave and its host-barrier phase-2 wave, which is
        #: how the serving layer attributes per-request latency inside
        #: a batch whose waves do not map 1:1 onto requests.
        self.last_wave_owners: list[int] = []
        from repro_torch.apps.pipeline import HostTimer
        self._last_host = HostTimer()

    @property
    def num_shards(self) -> int:
        return len(self.bounds)

    def fused_config(self) -> dict:
        """Build recipe for the card's fused path
        (:class:`repro_torch.kernels.fused_session.FusedTableExec`): the same
        table, shard count and chunk plan this machine executor placed,
        so the two backends evaluate identical layouts."""
        chunks = getattr(self.engines[0], "num_chunks", None)
        if chunks is None:
            raise TypeError(
                "the fused backend supports the clutch method only "
                "(bit-serial tables have no chunk plan)")
        cfg = {"table": self.table, "num_shards": len(self.bounds),
               "num_chunks": chunks}
        if self.plans is not None:
            cfg["plans"] = self.plans
        return cfg

    # ------------------------------------------------------------------ #
    def run(self, queries: list[tuple]) -> list:
        """Run a batch of queries through the async pipeline; returns
        one result per query (bitmap for q1/q2, int for q3/q5, float
        for q4), identical to the serial reference path."""
        from collections import deque

        from repro_torch.apps.pipeline import HostTimer

        self._batch += 1
        base = f"{self._tag}.b{self._batch}"
        self._last_tags = []
        self.last_wave_owners = []
        self._last_host = HostTimer()
        self._mark_job_start()
        results: list = [None] * len(queries)
        work_ref: list = []  # lets Q5's merge enqueue its phase-2 wave
        work = deque(wv for qi, q in enumerate(queries)
                     for wv in self._make_waves(qi, q, results, work_ref))
        work_ref.append(work)

        engines = self.engines
        prev_c: list[int | None] = [None] * len(engines)
        prev_h: list[int | None] = [None] * len(engines)
        last_r_by_buf: list[dict[int, int]] = [dict() for _ in engines]
        pending = None
        w = 0

        def submit(wave) -> tuple:
            tag = f"{base}.w{w}"
            buf = w % 2
            c_segs = []
            for s, eng in enumerate(engines):
                after = None
                if prev_c[s] is not None:
                    after = (prev_c[s],)
                    if buf in last_r_by_buf[s]:
                        after += (last_r_by_buf[s][buf],)
                # host barrier: a Q5 phase-2 wave may not start before
                # the merge tree's ROOT produced its scalar bounds
                after_host = (wave["hids"][s],) if wave.get("hids") else ()
                eng.submit(wave["kind"], wave["params"], buf,
                           segment=f"{tag}:c", after=after,
                           after_host=after_host)
                prev_c[s] = eng.sub.trace.current_segment
                c_segs.append(prev_c[s])
            tags = [f"{tag}:c", f"{tag}:r", f"{tag}:h"]
            if self.merge_tree:
                tags += [f"{tag}:h.s{s}" for s in range(len(engines))]
            self._last_tags.append(tags)
            self.last_wave_owners.append(wave["qi"])
            return (wave, w, buf, c_segs)

        def collect(item) -> None:
            wave, wi, buf, c_segs = item
            tag = f"{base}.w{wi}"
            words = []
            hids = []
            leaf_hids: list[int] = []
            for s, eng in enumerate(engines):
                # the readout depends only on the compute segment that
                # parked this buffer, not on later waves
                last_r_by_buf[s][buf] = eng.sub.trace.begin_segment(
                    f"{tag}:r", after=(c_segs[s],))
                words.append(eng.read_parked(buf))
                tr = eng.sub.trace
                readout_bytes = eng.sub.num_banks * eng.sub.num_cols / 8
                if self.merge_tree:
                    # per-shard merge leaf: starts as soon as ITS
                    # readout lands, independent of the other shards
                    leaf = tr.add_host_event(
                        f"{tag}:h.s{s}", after=(last_r_by_buf[s][buf],),
                        bytes_in=readout_bytes)
                    # reduction-tree join: one shared label across every
                    # shard's trace (and every device's) == ONE root
                    # node gated on all the leaves; it consumes the
                    # leaves' merged bitmaps, so its fallback bytes are
                    # the shard's OUTPUT bits -- total bytes conserved
                    # across the tree, never multiplied by lane count
                    hids.append(tr.add_host_event(
                        f"{tag}:h", after=(), after_host=(leaf,),
                        bytes_in=(self.bounds[s][1]
                                  - self.bounds[s][0]) / 8))
                    leaf_hids.append(leaf)
                else:
                    # monolithic recording: one node per wave,
                    # chained after the previous wave's merge; the
                    # parallelism hint still lets a multi-lane host
                    # gang its internally-independent shard merges
                    hids.append(tr.add_host_event(
                        f"{tag}:h", after=(last_r_by_buf[s][buf],),
                        after_host=() if prev_h[s] is None
                        else (prev_h[s],),
                        bytes_in=readout_bytes,
                        parallelism=len(engines)))
                    prev_h[s] = hids[s]

            leaf_ns: list[float] = []

            def merge() -> None:
                bitmaps = []
                for eng, ws in zip(engines, words):
                    t0 = time.perf_counter()
                    bitmaps.append(eng.merge_words(ws))
                    leaf_ns.append((time.perf_counter() - t0) * 1e9)
                wave["merge"](np.concatenate(bitmaps))
            # the readouts above waited for the device and copied their
            # rows to the host (host_read_row): the timer sees host work
            # only, never the waves the device was still running
            self._last_host.measure(merge)
            merge_ns = self._last_host.samples_ns[-1]
            if self.merge_tree:
                # the join is everything the leaves didn't cover (the
                # concatenation + the query's aggregate)
                root_ns = max(merge_ns - sum(leaf_ns), 0.0)
                for s, eng in enumerate(engines):
                    eng.sub.trace.set_host_duration(
                        leaf_hids[s], leaf_ns[s])
                    eng.sub.trace.set_host_duration(hids[s], root_ns)
            else:
                for s, eng in enumerate(engines):
                    eng.sub.trace.set_host_duration(hids[s], merge_ns)
            # a dependent wave enqueued during this merge (Q5 phase 2)
            # is barred on this wave's root join event
            for queued in work_ref[0]:
                if queued.get("barrier") and "hids" not in queued:
                    queued["hids"] = list(hids)

        while work or pending is not None:
            if work:
                item = submit(work.popleft())
                w += 1
                if pending is not None:
                    collect(pending)
                pending = item
            else:
                collect(pending)
                pending = None
        return results

    # ------------------------------------------------------------------ #
    def _make_waves(self, qi: int, q: tuple, results: list,
                    work_ref: list) -> list[dict]:
        """Lower one query tuple into its pipeline wave(s).  Every query
        is a single wave except a ``merge="host"`` compound, which runs
        one wave PER TERM (each term's bitmap is read out and combined
        host-side -- the baseline traffic an in-DRAM merge avoids).
        Each wave carries its owning query index (``"qi"``) so
        :attr:`last_wave_owners` can attribute scheduled completion
        times back to individual requests."""
        waves = self._lower(qi, q, results, work_ref)
        for wv in waves:
            wv["qi"] = qi
        return waves

    def _lower(self, qi: int, q: tuple, results: list,
               work_ref: list) -> list[dict]:
        name, *p = q
        mx = (1 << self.table.n_bits) - 1

        if name == "q1":
            return [{"kind": "range", "params": tuple(p),
                     "merge": lambda bm: results.__setitem__(qi, bm)}]
        if name == "q2":
            return [{"kind": "and2", "params": tuple(p),
                     "merge": lambda bm: results.__setitem__(qi, bm)}]
        if name == "q3":
            return [{"kind": "or2", "params": tuple(p),
                     "merge": lambda bm: results.__setitem__(
                         qi, int(bm.sum()))}]
        if name == "compound":
            count, mode, ops, terms = p

            def finish(bm):
                results[qi] = int(bm.sum()) if count else bm
            if mode == "dram":
                # one wave: term bitmaps merged by Ambit AND/OR waves
                # in-bank; only the final parked bitmap is read out
                return [{"kind": "compound", "params": (ops, terms),
                         "merge": finish}]
            # host-merge baseline: one wave (and one full-bitmap
            # readout) per term, left-associative combine on the host
            partial: list = [None] * len(terms)
            waves = []
            for ti, term in enumerate(terms):
                kind = {"q1": "range", "q2": "and2", "q3": "or2"}[term[0]]

                def mrg(bm, ti=ti):
                    partial[ti] = bm
                    if ti == len(terms) - 1:
                        acc = partial[0]
                        for op, nxt in zip(ops, partial[1:]):
                            acc = (acc & nxt) if op == "and" else (acc | nxt)
                        finish(acc)
                waves.append({"kind": kind, "params": tuple(term[1:]),
                              "merge": mrg})
            return waves
        if name == "q4":
            fk, *rest = p

            def merge_q4(bm):
                vals = self.table.features[fk][bm]
                results[qi] = float(vals.mean()) if vals.size else 0.0
            return [{"kind": "and2", "params": tuple(rest),
                     "merge": merge_q4}]
        if name == "q5":
            fl, fk, *rest = p

            def merge_phase1(bm):
                vals = self.table.features[fk][bm]
                avg = int(vals.mean()) if vals.size else 0
                hi = min(2 * avg, mx)
                if avg >= hi:
                    results[qi] = 0
                    return
                # host barrier: the dependent wave exists only now, and
                # its segments will declare this merge via after_host
                work_ref[0].appendleft({
                    "kind": "range", "params": (fl, avg, hi),
                    "barrier": True, "qi": qi,
                    "merge": lambda bm2: results.__setitem__(
                        qi, int(bm2.sum())),
                })
            return [{"kind": "or2", "params": tuple(rest),
                     "merge": merge_phase1}]
        raise ValueError(f"unknown query {name!r}")


class GbdtBatchExecutor(_FederatedExecutor):
    """Async host/PuD GBDT inference across a device fleet.

    Every device gets ``groups_per_device``
    :class:`~repro_torch.apps.gbdt.GbdtPudEngine` forest replicas, placed
    round-robin over its channels; with ``replicate="rowclone"`` each
    channel's replicas after the first are cloned in-DRAM from the
    first (RowClone/MRACT waves, zero host bytes) instead of re-loaded
    from the host (``replicate="host"``).  A batch is split into waves of
    ``sum(group wave widths)`` instances spread over all groups of all
    devices; for each wave the executor issues every group's compute
    stream, *then* reads back and merges the previous wave's
    double-buffered result rows -- host readout/merge of wave N
    overlaps PuD execution of wave N+1, and the recorded segments
    declare exactly that dependency structure.

    :meth:`infer` returns predictions; :meth:`last_stats` replays the
    federated scheduled timeline into a ``PipelineStats`` for the batch
    that just ran.
    """

    _uid = 0

    def __init__(self, forest, arch, devices, groups_per_device: int = 2,
                 banks_per_group: int = 4,
                 num_chunks: int | None = None, channels="auto",
                 hosts: str = "shared", merge_tree: bool = True,
                 replicate: str = "rowclone", plan=None) -> None:
        from repro_torch.apps.gbdt import GbdtPudEngine
        from repro_torch.apps.pipeline import HostTimer

        super().__init__(devices, hosts=hosts, merge_tree=merge_tree)
        if groups_per_device < 1:
            raise ValueError("need at least one group per device")
        if replicate not in ("rowclone", "host"):
            raise ValueError(
                f"replicate must be 'rowclone' or 'host', got {replicate!r}")
        GbdtBatchExecutor._uid += 1
        self._tag = f"gbdt.p{GbdtBatchExecutor._uid}"
        self.forest = forest
        #: shared threshold ColumnPlan (adaptive representation) or None
        #: for the uniform default; replicated onto every group engine.
        self.plan = plan
        self.engines = []
        # first replica built on each (device, channel): the in-DRAM
        # clone source for later replicas on the same channel.  Clones
        # never cross channels (RowClone moves data bank-internally /
        # over a channel's shared internal bus), so clone sources are
        # keyed per channel and each channel's first replica host-loads.
        first_on: dict[tuple[int, object], object] = {}
        for gi in range(len(self.devices) * groups_per_device):
            dev = self.devices[gi // groups_per_device]
            ch = (gi % groups_per_device) % dev.channels \
                if channels == "auto" else channels
            # only single-channel placements (ints; "auto" resolves to
            # one) have a well-defined channel to clone within -- spread
            # or free placements fall back to host loads
            cloneable = replicate == "rowclone" and \
                isinstance(ch, (int, np.integer))
            src = first_on.get((id(dev), int(ch))) if cloneable else None
            eng = GbdtPudEngine(forest, arch, num_chunks=num_chunks,
                                num_banks=banks_per_group, device=dev,
                                channels=ch, plan=plan,
                                label=f"{self._tag}.g{gi}",
                                clone_source=src)
            if cloneable:
                first_on.setdefault((id(dev), int(ch)), eng)
            self.engines.append(eng)
            self.placements.append((dev, eng.sub))
        self.wave_width = sum(e.wave_width for e in self.engines)
        self._batch = 0
        self._last_tags: list[list[str]] = []
        self._last_host = HostTimer()

    def fused_config(self) -> dict:
        """Build recipe for the card's fused path
        (:class:`repro_torch.kernels.fused_session.FusedGbdtExec`)."""
        cfg = {"forest": self.forest,
               "num_chunks": self.engines[0].num_chunks}
        if self.plan is not None:
            cfg["plan"] = self.plan
        return cfg

    def infer(self, X: np.ndarray) -> np.ndarray:
        """Pipelined batch inference; functionally identical to the
        serial path (tested), differing only in recorded stream order
        and the resulting overlap accounting."""
        from repro_torch.apps.pipeline import HostTimer

        X = np.asarray(X)
        self._batch += 1
        base = f"{self._tag}.b{self._batch}"
        self._last_tags = []
        self._last_host = HostTimer()
        # mark before the empty-batch return: an empty job must report
        # an empty job-scoped timeline, not the previous job's
        self._mark_job_start()
        if X.shape[0] == 0:
            return np.empty((0,), np.float32)
        engines = self.engines
        # per-engine (compute, readout, merge-event) history
        prev_c = [None] * len(engines)
        prev_r = [None] * len(engines)
        prev_h = [None] * len(engines)
        pending: tuple[int, list[tuple[int, int]]] | None = None
        preds_out: list[np.ndarray] = []

        def collect(w: int,
                    widths: list[tuple[int, int, int | None]]) -> None:
            words = []
            hids = []
            leaf_hids: list[int | None] = []
            active = sum(1 for wd, _, _ in widths if wd)
            for g, (wd, buf, c_seg) in enumerate(widths):
                if wd == 0:
                    words.append(None)
                    hids.append(None)
                    leaf_hids.append(None)
                    continue
                tr = engines[g].sub.trace
                # the readout depends only on the compute segment that
                # filled this buffer, not on later waves
                prev_r[g] = tr.begin_segment(
                    f"{base}.w{w}:r", after=(c_seg,))
                words.append(engines[g]._read_wave(buf))
                readout_bytes = (engines[g].sub.num_banks *
                                 engines[g].sub.num_cols / 8)
                if self.merge_tree:
                    # per-group leaf gather: waits only on its own
                    # group's readout, so gathers spread across lanes
                    leaf_hids.append(tr.add_host_event(
                        f"{base}.w{w}:h.g{g}", after=(prev_r[g],),
                        bytes_in=readout_bytes))
                    # reduction-tree join assembling the wave's
                    # predictions (shared label == one root node over
                    # every participating group's gather); fallback
                    # bytes are the group's OUTPUT predictions
                    hids.append(tr.add_host_event(
                        f"{base}.w{w}:h", after=(),
                        after_host=(leaf_hids[g],), bytes_in=wd * 4.0))
                else:
                    # monolithic recording (parallelism hint keeps
                    # multi-lane hosts useful for legacy streams)
                    leaf_hids.append(None)
                    hids.append(tr.add_host_event(
                        f"{base}.w{w}:h", after=(prev_r[g],),
                        after_host=() if prev_h[g] is None
                        else (prev_h[g],),
                        bytes_in=readout_bytes, parallelism=active))
                    prev_h[g] = hids[g]

            leaf_ns: dict[int, float] = {}

            def merge() -> None:
                for g, (wd, _, _) in enumerate(widths):
                    if wd:
                        t0 = time.perf_counter()
                        preds_out.append(
                            engines[g]._merge_wave(words[g], wd)[1])
                        leaf_ns[g] = (time.perf_counter() - t0) * 1e9
            # the readouts above waited for the device and copied their
            # rows to the host (host_read_row): the timer sees host work
            # only, never the waves the device was still running
            self._last_host.measure(merge)
            merge_ns = self._last_host.samples_ns[-1]
            if self.merge_tree:
                root_ns = max(merge_ns - sum(leaf_ns.values()), 0.0)
                for g, hid in enumerate(hids):
                    if hid is not None:
                        tr = engines[g].sub.trace
                        tr.set_host_duration(leaf_hids[g], leaf_ns[g])
                        tr.set_host_duration(hid, root_ns)
            else:
                for g, hid in enumerate(hids):
                    if hid is not None:
                        engines[g].sub.trace.set_host_duration(
                            hid, merge_ns)

        n_waves = math.ceil(X.shape[0] / self.wave_width)
        off = 0
        for w in range(n_waves):
            Xw = X[off:off + self.wave_width]
            off += self.wave_width
            widths: list[tuple[int, int, int | None]] = []
            lo = 0
            buf = w % 2
            for g, eng in enumerate(engines):
                Xg = Xw[lo:lo + eng.wave_width]
                lo += eng.wave_width
                if Xg.shape[0] == 0:
                    widths.append((0, buf, None))
                    continue
                after = None
                if prev_c[g] is not None:
                    after = (prev_c[g],) + (
                        (prev_r[g],) if prev_r[g] is not None else ())
                prev_c[g] = eng.sub.trace.begin_segment(
                    f"{base}.w{w}:c", after=after)
                eng._compute_wave(Xg, buf)
                widths.append((Xg.shape[0], buf, prev_c[g]))
            tags = [f"{base}.w{w}:c", f"{base}.w{w}:r", f"{base}.w{w}:h"]
            if self.merge_tree:
                tags += [f"{base}.w{w}:h.g{g}"
                         for g in range(len(engines))]
            self._last_tags.append(tags)
            if pending is not None:
                collect(*pending)
            pending = (w, widths)
        if pending is not None:
            collect(*pending)
        return np.concatenate(preds_out).astype(np.float32)
