"""Analytical DRAM command-level cost model (latency + energy).

Paper section 5: PuD time comes from the exact DRAM command sequence,
with bank-level parallelism bounded by the per-rank tRRD / tFAW windows;
CPU/GPU baselines are bandwidth-bound scans (BitWeaving-V reads
``n_bits`` per element).  Energy: each extra simultaneously activated
row adds 22 % of one activation; CPU/GPU energy is power times time;
off-chip transfers are charged per byte.

Two paths: :func:`trace_cost` (one group's op histogram, waves back to
back) and :func:`timeline_cost` (a scheduled device
:class:`~repro_torch.core.scheduler.Timeline`: makespan, per-wave
energy, host power per busy lane and idle power for the rest).  The
in-DRAM bulk waves (ROWCLONE/ROWINIT/MRACT, Ambit AND/OR) cost
activations and zero host bytes.

The reference package's ``core/cost.py`` under the same names, float for
float.  Its platforms model DRAM (``DESKTOP``: DDR4-2666; ``EDGE``;
``GPU_HBM2``: PuD projected into an A100's HBM2): every time they give
is a model of that DRAM, never a measurement of the card the port runs
on.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from .machine import PuDArch, PuDOp

# --------------------------------------------------------------------- #
# DRAM timing (DDR4-2666 19-19-19 unless noted); times in nanoseconds
# --------------------------------------------------------------------- #


@dataclass(frozen=True)
class DramTimings:
    tCK: float = 0.75
    tRCD: float = 14.25
    tRP: float = 14.25
    tRAS: float = 32.0
    tRRD_L: float = 4.9       # same bank group ACT->ACT
    tFAW: float = 30.0        # max 4 ACTs per rank per window

    # Derived PuD primitive latencies (per bank).  RowCopy is AAP
    # (ACT->ACT->PRE); TRA/APA are ACT(-PRE-ACT) with a final PRE.  All are
    # dominated by tRAS + tRP, consistent with DRAM-Bender-measured numbers.
    @property
    def t_rowcopy(self) -> float:
        return self.tRAS + self.tRP

    @property
    def t_tra(self) -> float:
        return self.tRAS + self.tRP

    @property
    def t_apa(self) -> float:
        return self.tRAS + self.tRP

    @property
    def t_frac(self) -> float:
        return self.tRP + 2 * self.tCK  # reduced-timing ACT/PRE pair


# ACT commands issued per PuD primitive (for the BLP/tFAW constraint).
# The in-DRAM bulk waves: ROWCLONE/ROWINIT are AAP pairs (RowClone FPM),
# MRACT is an AAP pair whose second ACT opens the whole span, AND/OR are
# control-row-init AAP + triple-row ACT.
ACTS_PER_OP = {
    PuDOp.ROWCOPY: 2,
    PuDOp.TRA: 1,
    PuDOp.APA: 2,
    PuDOp.FRAC: 1,
    PuDOp.NOT: 2,
    PuDOp.ROWCLONE: 2,
    PuDOp.ROWINIT: 2,
    PuDOp.MRACT: 2,
    PuDOp.AND: 2,
    PuDOp.OR: 2,
}


@dataclass(frozen=True)
class SystemConfig:
    """One evaluated platform (paper Tables 1, 2, 5)."""

    name: str
    bandwidth_gbps: float            # off-chip peak bandwidth (GB/s)
    channels: int                    # independent command/data channels
    ranks_per_channel: int
    banks_per_rank: int
    cols_per_bank: int               # row-buffer bits == PuD SIMD lanes
    host_power_w: float              # active host power during baseline run
    host_idle_power_w: float         # host power while PuD computes
    host_mem_gbps: float = 20.0      # PER-LANE host merge/memcpy rate
    host_lanes: int = 1              # concurrent host merge lanes (threads)
    e_act_nj: float = 2.1            # single-row activation+precharge energy
    e_io_pj_per_bit: float = 22.0    # off-chip transfer energy
    multi_act_overhead: float = 0.22 # +22%/extra row (paper, [197])
    multi_row_act: int = 1           # PULSAR MRACT span capability (1 = off)
    timings: DramTimings = DramTimings()

    @property
    def total_banks(self) -> int:
        return self.channels * self.ranks_per_channel * self.banks_per_rank

    @property
    def parallel_cols(self) -> int:
        """PuD SIMD width: all banks compute concurrently."""
        return self.total_banks * self.cols_per_bank


# Paper Table 1: desktop, 64 GB DDR4-2666, dual channel, 2 DIMMs/ch,
# 2 ranks/DIMM.  The paper's stated parallelism is 64K cols x 16 banks x
# 2 DIMMs x 2 channels (one PuD rank per DIMM); we follow that accounting.
DESKTOP = SystemConfig(
    name="desktop-ddr4-2666",
    bandwidth_gbps=42.6,
    channels=2,
    ranks_per_channel=2,      # one PuD-enabled rank per DIMM, 2 DIMMs/ch
    banks_per_rank=16,
    cols_per_bank=65536,
    host_power_w=80.0,        # i7-9700K package power under scan load (RAPL)
    host_idle_power_w=15.0,
)

# Paper Table 2: edge, 4 GB DDR4-2400 single channel single rank, ARM A53.
EDGE = SystemConfig(
    name="edge-ddr4-2400",
    bandwidth_gbps=19.2,
    channels=1,
    ranks_per_channel=1,
    banks_per_rank=16,
    cols_per_bank=65536,
    host_power_w=3.5,
    host_idle_power_w=0.8,
    timings=DramTimings(tCK=0.833, tRCD=14.16, tRP=14.16, tRAS=32.0,
                        tRRD_L=4.9, tFAW=30.0),
)

# Paper Table 5: A100 with 5 HBM2 stacks; PuD projected into HBM2 with
# per-stack parallelism 2KB-row x 16 banks x 8 channels (paper §6.2).
GPU_HBM2 = SystemConfig(
    name="gpu-a100-hbm2",
    bandwidth_gbps=1555.0,
    channels=5 * 8,
    ranks_per_channel=1,
    banks_per_rank=16,
    cols_per_bank=2048 * 8,   # 2 KB row buffer -> 16384 bit-columns
    host_power_w=250.0,
    host_idle_power_w=60.0,
)

SYSTEMS = {s.name: s for s in (DESKTOP, EDGE, GPU_HBM2)}


# --------------------------------------------------------------------- #
# PuD sequence latency with bank-level parallelism
# --------------------------------------------------------------------- #

def op_latency(op: PuDOp, t: DramTimings) -> float:
    return {
        PuDOp.ROWCOPY: t.t_rowcopy,
        PuDOp.TRA: t.t_tra,
        PuDOp.APA: t.t_apa,
        PuDOp.FRAC: t.t_frac,
        PuDOp.NOT: t.t_rowcopy,
        PuDOp.ROWCLONE: t.t_rowcopy,
        PuDOp.ROWINIT: t.t_rowcopy,
        PuDOp.MRACT: t.t_rowcopy,
        PuDOp.AND: t.t_apa,
        PuDOp.OR: t.t_apa,
    }[op]


def wave_time(op: PuDOp, sys: SystemConfig, banks: int | None = None
              ) -> float:
    """Time (ns) to apply one broadcast PuD primitive across ``banks``
    concurrently active banks (default: every bank of a rank).

    Within a channel, ACTs to a rank's banks are staggered by the per-rank
    tFAW window (4 ACTs / tFAW) and tRRD; channels/ranks are independent,
    so only the banks sharing a rank (at most ``banks_per_rank``) bound
    the stagger.  The wave completes when the last bank's op finishes:
    stagger of the final ACT + per-bank op latency.  Consecutive PuD ops
    are data-dependent, so a sequence serializes waves.
    """
    t = sys.timings
    acts = ACTS_PER_OP[op]
    banks = sys.banks_per_rank if banks is None \
        else min(banks, sys.banks_per_rank)
    # Per rank: ACT issue rate limited by max(tFAW/4, tRRD_L).
    act_gap = max(t.tFAW / 4.0, t.tRRD_L)
    total_acts_per_rank = acts * banks
    stagger = (total_acts_per_rank - 1) * act_gap
    # Ranks within a channel share only the command bus (1 cmd / tCK),
    # which is never the binding constraint here -> ranks ~parallel.
    return stagger + op_latency(op, t)


def sequence_time_ns(op_counts: dict[str, int], sys: SystemConfig,
                     banks: int | None = None) -> float:
    """Makespan (ns) of a dependent PuD op sequence across ``banks``
    active banks (default: all)."""
    total = 0.0
    for name, count in op_counts.items():
        op = PuDOp(name)
        if op in (PuDOp.READ, PuDOp.WRITE):
            continue  # host traffic is charged separately (transfer_time)
        total += count * wave_time(op, sys, banks)
    return total


#: Simultaneously opened rows in each primitive's multi-row ACT.
#: MRACT is absent: its row count is the configured ``multi_row_act``
#: span (``wave_energy_nj`` special-cases it).
ROWS_PER_ACT = {
    PuDOp.ROWCOPY: 1,  # two single-row ACTs
    PuDOp.TRA: 3,      # one triple-row ACT
    PuDOp.APA: 4,      # one quad-row ACT (second ACT of the APA pair)
    PuDOp.FRAC: 1,
    PuDOp.NOT: 1,
    PuDOp.ROWCLONE: 1,  # AAP pair of single-row ACTs
    PuDOp.ROWINIT: 1,
    PuDOp.AND: 3,       # triple-row ACT (second ACT of the sequence)
    PuDOp.OR: 3,
}


def wave_energy_nj(op: PuDOp, banks: int, sys: SystemConfig) -> float:
    """Energy (nJ) of ONE broadcast wave of ``op`` across ``banks``
    concurrently active banks (paper model: +22% activation energy per
    extra simultaneously opened row; extra ACTs are single-row).
    An MRACT wave's second ACT opens the configured ``multi_row_act``
    span simultaneously, paying the per-extra-row overhead for every
    row of the span."""
    if op in (PuDOp.READ, PuDOp.WRITE):
        return 0.0  # off-chip transfer energy is charged per byte
    k = sys.multi_row_act if op is PuDOp.MRACT else ROWS_PER_ACT[op]
    e_act = sys.e_act_nj * (1.0 + sys.multi_act_overhead * (k - 1))
    extra = ACTS_PER_OP[op] - 1
    return banks * (e_act + extra * sys.e_act_nj)


def sequence_energy_nj(op_counts: dict[str, int], sys: SystemConfig,
                       banks: int | None = None) -> float:
    """Energy (nJ) of a PuD op sequence across ``banks`` active banks
    (default: every bank of the system)."""
    active = sys.total_banks if banks is None else banks
    return sum(count * wave_energy_nj(PuDOp(name), active, sys)
               for name, count in op_counts.items())


def transfer_time_ns(n_bytes: float, sys: SystemConfig) -> float:
    return n_bytes / sys.bandwidth_gbps  # GB/s == bytes/ns

def transfer_energy_nj(n_bytes: float, sys: SystemConfig) -> float:
    return n_bytes * 8 * sys.e_io_pj_per_bit * 1e-3


def trace_cost(op_counts: dict[str, int], sys: SystemConfig, *,
               banks: int, cols_per_bank: int,
               include_host_io: bool = True,
               channels: int | None = None,
               elems: int | None = None) -> "KernelCost":
    """Cost of a *measured* machine trace: the op histogram of a
    :class:`~repro_torch.core.machine.CommandTrace` from a ``banks``-wide
    :class:`~repro_torch.core.machine.BankedSubarray` (one trace entry == one
    broadcast wave across the group).

    PuD waves go through the BLP model parameterized by the group's
    actual bank count; READ/WRITE entries become off-chip transfers of
    one row per bank each, charged at the bandwidth of the ``channels``
    the group actually spans (``channels * bandwidth / sys.channels``,
    the same per-channel share the bus scheduler uses -- a
    single-channel group does NOT get the whole device's pins).
    ``channels=None`` keeps the historical whole-device assumption for
    callers that model an unplaced group.  ``elems`` overrides the SIMD
    width when the engine uses fewer lanes than ``banks *
    cols_per_bank`` (padded shards).
    """
    t = sequence_time_ns(op_counts, sys, banks)
    e = sequence_energy_nj(op_counts, sys, banks)
    if include_host_io:
        io_rows = op_counts.get("read", 0) + op_counts.get("write", 0)
        io_bytes = io_rows * banks * cols_per_bank / 8
        share = 1.0 if channels is None \
            else min(channels, sys.channels) / sys.channels
        t += transfer_time_ns(io_bytes, sys) / share
        e += transfer_energy_nj(io_bytes, sys)
    e += sys.host_idle_power_w * t
    return KernelCost(time_ns=t, energy_nj=e,
                      elems=banks * cols_per_bank if elems is None
                      else elems)


def timeline_cost(timeline, sys: SystemConfig) -> "KernelCost":
    """Device-level cost of a *scheduled* timeline
    (:class:`~repro_torch.core.scheduler.Timeline`).

    Latency is the makespan -- channel contention between co-resident
    groups, overlap across disjoint channels, and host-barrier bubbles
    (scheduled host-lane spans) are all already in the placement, and
    host row I/O was charged at per-channel bandwidth by the scheduler.
    Energy sums every scheduled wave (activation energy for compute
    waves, per-byte transfer energy for I/O waves) plus host power
    split by what the host is actually doing: active power is charged
    **per busy lane** -- ``host_power_w`` times the total busy
    lane-time (``Timeline.host_busy_ns``, which sums every lane a gang-
    scheduled node occupied), so two merges overlapping on two lanes
    cost twice the power of one -- and idle power covers only the part
    of the makespan where NO lane is active
    (``makespan - Timeline.host_wall_ns``).  With ``host_lanes=1`` the
    busy lane-time and the busy wall-clock coincide, reproducing the
    single-lane accounting exactly.  ``elems`` is the total SIMD width
    that computed useful lanes: each group counted once via the
    timeline's per-group tallies (padded columns excluded).
    """
    from .machine import PuDOp as _Op

    e = 0.0
    for w in timeline.waves:
        if w.op in (_Op.READ, _Op.WRITE):
            e += transfer_energy_nj(w.io_bytes, sys)
        else:
            e += wave_energy_nj(w.op, w.banks, sys)
    e += sys.host_power_w * timeline.host_busy_ns
    host_wall = min(timeline.host_wall_ns, timeline.makespan_ns)
    e += sys.host_idle_power_w * (timeline.makespan_ns - host_wall)
    return KernelCost(time_ns=timeline.makespan_ns, energy_nj=e,
                      elems=sum(timeline.group_elems.values()))


# --------------------------------------------------------------------- #
# Comparison-kernel throughput/energy (paper Figures 10 & 11)
# --------------------------------------------------------------------- #

from .bitserial import bitserial_op_count, paper_bitserial_op_count  # noqa: E402
from .clutch import clutch_op_count  # noqa: E402


def _pud_counts(method: str, n_bits: int, chunks: int, arch: PuDArch,
                paper_accounting: bool = False) -> dict[str, int]:
    """Op-type histogram for one vector-scalar comparison."""
    if method == "clutch":
        if chunks == 1:
            return {"rowcopy": 1}
        merges = chunks - 1
        if arch is PuDArch.MODIFIED:
            return {"rowcopy": 1 + 2 * merges, "tra": merges}
        return {"rowcopy": 1 + 2 * merges, "frac": merges, "apa": merges}
    if method == "bitserial":
        n = n_bits
        if paper_accounting:
            # ~4n (M) / ~6n (U): n staging + 3n (copy,copy,TRA) or
            # n staging + n neutral-copies + 5n-ish; modeled per paper text.
            if arch is PuDArch.MODIFIED:
                return {"rowcopy": 3 * n, "tra": n}
            return {"rowcopy": 4 * n, "frac": n, "apa": n}
        if arch is PuDArch.MODIFIED:
            return {"rowcopy": 2 * n + n + 1, "tra": n}
        return {"rowcopy": 2 * n + n + 1, "frac": n, "apa": n}
    raise ValueError(method)


@dataclass
class KernelCost:
    time_ns: float
    energy_nj: float
    elems: int

    @property
    def throughput_geps(self) -> float:
        """Giga-elements compared per second."""
        return self.elems / self.time_ns

    @property
    def elems_per_uj(self) -> float:
        return self.elems / (self.energy_nj * 1e-3)


def pud_compare_cost(
    method: str,
    n_bits: int,
    arch: PuDArch,
    sys: SystemConfig,
    chunks: int = 1,
    include_readout: bool = True,
    paper_accounting: bool = False,
) -> KernelCost:
    counts = _pud_counts(method, n_bits, chunks, arch, paper_accounting)
    t = sequence_time_ns(counts, sys)
    e = sequence_energy_nj(counts, sys)
    elems = sys.parallel_cols
    if include_readout:
        out_bytes = elems / 8  # 1-bit-per-element bitmap
        t += transfer_time_ns(out_bytes, sys)
        e += transfer_energy_nj(out_bytes, sys)
    # host idles during PuD execution (paper: single-thread idle power);
    # W * ns == nJ, so this is dimensionally direct.
    e += sys.host_idle_power_w * t
    return KernelCost(time_ns=t, energy_nj=e, elems=elems)


def cpu_scan_cost(n_bits: int, n_elems: int, sys: SystemConfig) -> KernelCost:
    """BitWeaving-V: bandwidth-bound, reads exactly n_bits/elem and writes
    a 1-bit/elem bitmap."""
    rd_bytes = n_elems * n_bits / 8
    wr_bytes = n_elems / 8
    t = transfer_time_ns(rd_bytes + wr_bytes, sys)
    e = sys.host_power_w * t + transfer_energy_nj(rd_bytes + wr_bytes, sys)
    return KernelCost(time_ns=t, energy_nj=e, elems=n_elems)


def cpu_tree_cost(n_bits: int, n_elems: int, sys: SystemConfig,
                  irregular_factor: float = 2.6) -> KernelCost:
    """Search-tree predicate index: irregular accesses defeat prefetching;
    modeled as the scan cost inflated by a constant factor (paper reports
    CPU(tree) consistently slower than CPU(scan))."""
    base = cpu_scan_cost(max(n_bits, 32), n_elems, sys)
    return KernelCost(base.time_ns * irregular_factor,
                      base.energy_nj * irregular_factor, n_elems)


def gpu_scan_cost(n_bits: int, n_elems: int, sys: SystemConfig) -> KernelCost:
    return cpu_scan_cost(n_bits, n_elems, sys)


def conversion_cost_ns(n_elems: int, n_bits: int, chunks: int,
                       sys: SystemConfig, complement: bool = False) -> float:
    """One-time binary -> chunked-temporal-coding conversion: the host
    streams the binary data in and writes LUT bit-plane rows back."""
    from .encoding import make_plan

    plan = make_plan(n_bits, chunks)
    rows = plan.rows_required * (2 if complement else 1)
    subarrays = math.ceil(n_elems / sys.cols_per_bank)
    read_bytes = n_elems * n_bits / 8
    write_bytes = rows * subarrays * sys.cols_per_bank / 8
    return transfer_time_ns(read_bytes + write_bytes, sys)
