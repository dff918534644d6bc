"""PuD device hierarchy: channels x ranks x banks owning bank placement
and command-stream scheduling.

* :class:`PuDDevice` mirrors a :class:`~repro_torch.core.cost.
  SystemConfig`'s channel/rank/bank topology and hands out
  :class:`BankGroup` slices of it; banks are addressed ``(channel,
  rank, bank)`` row-major over the flat index.  ``alloc_banks`` places
  a group first-fit (``channels=None``), inside one channel, over a
  list of channels, or ``"spread"`` round-robin over all of them.
* Engines record command streams while they run; :meth:`PuDDevice.
  schedule` hands every placed group's stream and footprint to the
  per-channel bus scheduler, and :meth:`PuDDevice.cost_summary` prices
  the timeline, with the serialized and perfect-overlap bounds beside
  it.
* :meth:`PuDDevice.free_banks` returns a group's banks to a coalescing
  free map; :meth:`PuDDevice.defragment` slides groups toward the start
  of their channels, recording the move as RowClone waves (MRACT under
  the PULSAR capability) or, with ``rowclone=False``, as host READ /
  WRITE round trips.  Group state is kept per group, so it survives the
  move bit for bit.

The reference package's ``core/device.py`` under the same names.  The
one addition is ``device``: the torch device every group's bank state
is allocated on (the card unless the caller names another).
"""

from __future__ import annotations

import bisect

from dataclasses import dataclass

import numpy as np

from .machine import BankedSubarray, PuDArch, PuDOp
from .scheduler import ChannelScheduler, Footprint, GroupStream, Timeline


@dataclass(frozen=True)
class BankAddress:
    channel: int
    rank: int
    bank: int


@dataclass
class BankGroup:
    """A placed engine: which flat banks it owns and its machine state.
    ``active_elems`` is the SIMD width the engine actually uses (real
    records/nodes, not padded columns); ``None`` means all columns."""

    banks: tuple[int, ...]
    sub: BankedSubarray
    label: str = ""
    active_elems: int | None = None

    @property
    def first_bank(self) -> int:
        return self.banks[0]

    @property
    def num_banks(self) -> int:
        return self.sub.num_banks


class PuDDevice:
    """A whole PuD-enabled memory device (channels x ranks x banks)."""

    def __init__(
        self,
        arch: PuDArch,
        channels: int = 2,
        ranks_per_channel: int = 2,
        banks_per_rank: int = 16,
        num_rows: int = 1024,
        cols_per_bank: int = 65536,
        seed: int | None = 0,
        multi_row_act: int = 1,
        device=None,
    ) -> None:
        from repro_torch.kernels.common import resolve_device

        self.arch = arch
        #: torch device of every allocated group's bank state
        self.device = resolve_device(device)
        self.channels = channels
        self.ranks_per_channel = ranks_per_channel
        self.banks_per_rank = banks_per_rank
        self.num_rows = num_rows
        self.cols_per_bank = cols_per_bank
        self._seed = seed
        #: PULSAR multi-row-ACT span capability, threaded into every
        #: allocated group's :class:`BankedSubarray` (1 = off).
        self.multi_row_act = multi_row_act
        # Free map: sorted, non-overlapping, non-adjacent [start, length]
        # ranges (adjacent ranges are always coalesced on free).
        self._ranges: list[list[int]] = [[0, self.total_banks]]
        self.groups: list[BankGroup] = []

    @classmethod
    def from_system(cls, sys_cfg, arch: PuDArch,
                    num_rows: int = 1024, device=None) -> "PuDDevice":
        """Build a device matching a cost-model SystemConfig topology."""
        return cls(arch, channels=sys_cfg.channels,
                   ranks_per_channel=sys_cfg.ranks_per_channel,
                   banks_per_rank=sys_cfg.banks_per_rank,
                   num_rows=num_rows, cols_per_bank=sys_cfg.cols_per_bank,
                   multi_row_act=sys_cfg.multi_row_act, device=device)

    # ------------------------------------------------------------------ #
    @property
    def total_banks(self) -> int:
        return self.channels * self.ranks_per_channel * self.banks_per_rank

    @property
    def banks_free(self) -> int:
        return sum(length for _, length in self._ranges)

    @property
    def free_ranges(self) -> tuple[tuple[int, int], ...]:
        """The free map as sorted, coalesced ``(start, length)`` ranges."""
        return tuple((s, length) for s, length in self._ranges)

    @property
    def largest_free_run(self) -> int:
        """Largest contiguous allocatable run (0 when the device is
        full).  ``banks_free > largest_free_run`` means the free space
        is fragmented -- a :meth:`defragment` candidate."""
        return max((length for _, length in self._ranges), default=0)

    @property
    def parallel_cols(self) -> int:
        """Device SIMD width when every bank computes."""
        return self.total_banks * self.cols_per_bank

    @property
    def banks_per_channel(self) -> int:
        return self.ranks_per_channel * self.banks_per_rank

    def address(self, flat_bank: int) -> BankAddress:
        """(channel, rank, bank) of a flat bank index."""
        if not 0 <= flat_bank < self.total_banks:
            raise IndexError(flat_bank)
        per_ch = self.banks_per_channel
        return BankAddress(
            channel=flat_bank // per_ch,
            rank=(flat_bank % per_ch) // self.banks_per_rank,
            bank=flat_bank % self.banks_per_rank,
        )

    # ------------------------------------------------------------------ #
    # Placement
    # ------------------------------------------------------------------ #
    def _find_contiguous(self, n: int, lo: int, hi: int) -> list[int]:
        """First-fit run of ``n`` free banks inside [lo, hi); [] if none.
        Pure lookup -- the caller carves the run once the whole
        placement has resolved, so a multi-channel request that fails
        on a later channel leaks nothing."""
        for start, length in self._ranges:
            a, b = max(start, lo), min(start + length, hi)
            if b - a >= n:
                return list(range(a, a + n))
        return []

    def _carve(self, start: int, n: int) -> None:
        """Remove the run [start, start+n) from the free map (the run
        must lie inside one free range)."""
        for i, (s, length) in enumerate(self._ranges):
            if s <= start and start + n <= s + length:
                pieces = []
                if start > s:
                    pieces.append([s, start - s])
                if s + length > start + n:
                    pieces.append([start + n, s + length - (start + n)])
                self._ranges[i:i + 1] = pieces
                return
        raise AssertionError(
            f"carve of [{start}, {start + n}) misses the free map")

    def _insert_free(self, start: int, n: int) -> None:
        """Return the run [start, start+n) to the free map, coalescing
        with adjacent free ranges so fragmentation never accumulates
        from the free path itself."""
        i = bisect.bisect([s for s, _ in self._ranges], start)
        self._ranges.insert(i, [start, n])
        if i + 1 < len(self._ranges) and \
                start + n == self._ranges[i + 1][0]:
            self._ranges[i][1] += self._ranges[i + 1][1]
            del self._ranges[i + 1]
        if i > 0 and \
                self._ranges[i - 1][0] + self._ranges[i - 1][1] == start:
            self._ranges[i - 1][1] += self._ranges[i][1]
            del self._ranges[i]

    def _channel_free(self, c: int) -> int:
        per_ch = self.banks_per_channel
        lo, hi = c * per_ch, (c + 1) * per_ch
        return sum(max(0, min(s + length, hi) - max(s, lo))
                   for s, length in self._ranges)

    def _resolve_placement(self, n: int, channels) -> list[int]:
        per_ch = self.banks_per_channel
        if channels is None:
            picked = self._find_contiguous(n, 0, self.total_banks)
            if picked:
                return picked
            raise MemoryError(
                f"device bank budget exceeded: no contiguous run of {n} "
                f"banks free ({self.banks_free}/{self.total_banks} free)")
        if isinstance(channels, (int, np.integer)):
            channels = [int(channels)]
        if channels == "spread":
            channels = list(range(self.channels))
        channels = list(dict.fromkeys(channels))  # dedupe, keep order
        if any(not 0 <= c < self.channels for c in channels):
            raise IndexError(f"channel out of range: {channels}")
        # Balanced split over the requested channels, preferring emptier
        # ones for the remainder banks.
        base, rem = divmod(n, len(channels))
        order = sorted(channels, key=lambda c: -self._channel_free(c))
        want = {c: base for c in channels}
        for c in order[:rem]:
            want[c] += 1
        picked: list[int] = []
        for c in channels:
            if want[c] == 0:
                continue
            got = self._find_contiguous(want[c], c * per_ch,
                                        (c + 1) * per_ch)
            if not got:
                raise MemoryError(
                    f"channel {c} cannot place {want[c]} contiguous banks "
                    f"({self._channel_free(c)} free)")
            picked.extend(got)
        return picked

    @staticmethod
    def _runs(banks) -> list[tuple[int, int]]:
        """Maximal consecutive (start, length) runs of a bank set."""
        out: list[tuple[int, int]] = []
        for b in sorted(banks):
            if out and out[-1][0] + out[-1][1] == b:
                out[-1] = (out[-1][0], out[-1][1] + 1)
            else:
                out.append((b, 1))
        return out

    def alloc_banks(self, n: int, num_cols: int | None = None,
                    label: str = "", channels=None,
                    active_elems: int | None = None) -> BankedSubarray:
        """Allocate ``n`` banks as one broadcast group and return its
        machine state.  ``channels`` selects the placement policy (see
        module docstring); ``active_elems`` records how many SIMD lanes
        the engine will actually use (throughput accounting excludes
        padded columns).  Raises MemoryError when the requested
        placement does not fit (callers shard or queue waves above this
        layer)."""
        if n < 1:
            raise ValueError("need at least one bank")
        banks = self._resolve_placement(n, channels)
        sub = BankedSubarray(
            num_banks=n, num_rows=self.num_rows,
            num_cols=num_cols or self.cols_per_bank, arch=self.arch,
            seed=None if self._seed is None
            else self._seed + banks[0],
            multi_row_act=self.multi_row_act, device=self.device)
        group = BankGroup(banks=tuple(banks), sub=sub, label=label,
                          active_elems=active_elems)
        for start, length in self._runs(banks):
            self._carve(start, length)
        self.groups.append(group)
        return sub

    def free_banks(self, group: "BankGroup | BankedSubarray") -> None:
        """Release a placed group's banks back to the free map and prune
        it from placement/streams, so long-running serving can rotate
        tables/forests without building a new device.  Accepts the
        :class:`BankGroup` or the :class:`BankedSubarray` that
        ``alloc_banks`` returned.  The group's recorded stream stops
        being scheduled; its banks become allocatable immediately."""
        if isinstance(group, BankedSubarray):
            matches = [g for g in self.groups if g.sub is group]
        else:
            matches = [g for g in self.groups if g is group]
        if not matches:
            raise ValueError("group is not placed on this device")
        g = matches[0]
        for start, length in self._runs(g.banks):
            self._insert_free(start, length)
        self.groups.remove(g)

    # ------------------------------------------------------------------ #
    # Defragmentation
    # ------------------------------------------------------------------ #
    def defragment(self, rowclone: bool = True) -> int:
        """Compact placed groups toward the start of each channel,
        coalescing every channel's free space into one tail run.

        Each group's per-channel bank runs slide down (placement order
        preserved) without crossing channel boundaries, so the group's
        channel footprint -- which buses it occupies, hence which
        groups it serializes with -- is unchanged.  Group *state* is
        untouched (it lives in the group's own
        :class:`~repro_torch.core.machine.BankedSubarray`); the physical move
        is recorded in each relocated group's command stream in a
        dedicated ``defrag`` segment that subsequent (default-chained)
        segments depend on.  By default (``rowclone=True``) relocation
        is pure in-DRAM movement: one RowClone wave per occupied row
        (chunked into MRACT spans when the device has the PULSAR
        ``multi_row_act`` capability) -- no host lane, no off-chip
        bytes.  ``rowclone=False`` keeps the legacy host path (one READ
        + one WRITE per occupied row over the channel), the baseline
        the in-DRAM path is measured against.  Returns the number of
        banks moved.
        """
        per_ch = self.banks_per_channel
        new_banks = {id(g): list(g.banks) for g in self.groups}
        moved_groups: set[int] = set()
        moved = 0
        for c in range(self.channels):
            lo = c * per_ch
            items: list[tuple[int, list[int], BankGroup]] = []
            for g in self.groups:
                for start, length in self._runs(
                        b for b in g.banks if lo <= b < lo + per_ch):
                    items.append((start, list(range(start, start + length)),
                                  g))
            items.sort(key=lambda it: it[0])
            cursor = lo
            for start, run, g in items:
                if start != cursor:
                    remap = {old: cursor + k for k, old in enumerate(run)}
                    nb = new_banks[id(g)]
                    for j, b in enumerate(nb):
                        if b in remap:
                            nb[j] = remap[b]
                    moved += len(run)
                    moved_groups.add(id(g))
                cursor += len(run)
        for g in self.groups:
            if id(g) in moved_groups:
                g.banks = tuple(new_banks[id(g)])
                tr = g.sub.trace
                rows = max(1, g.sub._alloc_ptr)
                tr.begin_segment(f"defrag:{g.label or 'group'}")
                if rowclone:
                    # In-DRAM relocation: one clone wave per occupied
                    # row (MRACT-chunked), row indices unchanged.
                    g.sub.rowclone_rows(0, 0, rows)
                else:
                    # Legacy host baseline: round trip every row.
                    tr.emit_rows(PuDOp.READ, 0, rows)
                    tr.emit_rows(PuDOp.WRITE, 0, rows)
        used = sorted(b for g in self.groups for b in g.banks)
        self._ranges = []
        prev = 0
        for start, length in self._runs(used):
            if start > prev:
                self._ranges.append([prev, start - prev])
            prev = start + length
        if prev < self.total_banks:
            self._ranges.append([prev, self.total_banks - prev])
        return moved

    def footprint(self, group: BankGroup) -> Footprint:
        """{channel: {rank: bank count}} of a group's placement."""
        out: Footprint = {}
        for b in group.banks:
            a = self.address(b)
            out.setdefault(a.channel, {}).setdefault(a.rank, 0)
            out[a.channel][a.rank] += 1
        return out

    # ------------------------------------------------------------------ #
    # Scheduling + cost
    # ------------------------------------------------------------------ #
    def _group_label(self, i: int, g: BankGroup) -> str:
        base = g.label or "group"
        return f"{base}@{g.first_bank}" if any(
            j != i and (h.label or "group") == base
            for j, h in enumerate(self.groups)) else base

    def streams(self) -> list[GroupStream]:
        """Every placed group's recorded stream (waves + host events) +
        physical footprint + active SIMD width."""
        return [
            GroupStream.from_trace(self._group_label(i, g), g.sub.trace,
                                   self.footprint(g), g.sub.num_cols,
                                   active_elems=g.active_elems,
                                   machine=g.sub)
            for i, g in enumerate(self.groups)
        ]

    def schedule(self, sys_cfg) -> Timeline:
        """Run every group's recorded stream through the per-channel
        command-bus scheduler -> scheduled device timeline."""
        return ChannelScheduler(sys_cfg).schedule(self.streams())

    def cost_summary(self, sys_cfg) -> dict:
        """Device-level latency/energy from the scheduled timeline.

        ``time_scheduled_ns`` is the makespan of the per-channel bus
        schedule, host-lane spans included -- the primary number
        (``time_device_ns`` is the DRAM-only span).  ``time_serial_ns``
        (all groups back-to-back on one bus plus all host work) and
        ``time_overlap_ns`` (perfect overlap) remain as the bracketing
        bounds; per-group entries keep the standalone histogram cost
        (``cost.trace_cost``), with host I/O charged at the channel
        share the group actually spans so the histogram and timeline
        paths agree on bandwidth accounting.
        """
        from . import cost

        timeline = self.schedule(sys_cfg)
        kc = cost.timeline_cost(timeline, sys_cfg)
        per_group = []
        for i, g in enumerate(self.groups):
            label = self._group_label(i, g)
            tc = cost.trace_cost(g.sub.trace.counts(), sys_cfg,
                                 banks=g.num_banks,
                                 cols_per_bank=g.sub.num_cols,
                                 channels=len(self.footprint(g)),
                                 elems=g.active_elems)
            span = timeline.group_span_ns.get(label)
            per_group.append({
                "label": label,
                "banks": g.num_banks,
                "channels": sorted(self.footprint(g)),
                "pud_ops": g.sub.trace.pud_ops,
                "time_ns": tc.time_ns,
                "sched_busy_ns": timeline.group_busy_ns.get(label, 0.0),
                "sched_span_ns": span,
                "energy_nj": tc.energy_nj,
            })
        return {
            "groups": per_group,
            "banks_used": self.total_banks - self.banks_free,
            "time_scheduled_ns": timeline.makespan_ns,
            "time_device_ns": timeline.device_span_ns,
            "time_serial_ns": timeline.serial_bound_ns,
            "time_overlap_ns": timeline.overlap_bound_ns,
            "channel_busy_ns": timeline.channel_busy_ns,
            "host_busy_ns": timeline.host_busy_ns,
            "host_lane_busy_ns": timeline.host_lane_busy_ns,
            "host_utilization": timeline.host_utilization,
            "energy_nj": sum(g["energy_nj"] for g in per_group),
            "energy_scheduled_nj": kc.energy_nj,
        }
