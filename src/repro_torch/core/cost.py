"""DRAM command timings and platforms: what the planner's probes are
priced in.

The pricing part of the reference package's ``core/cost.py`` under the
same names (paper section 5): per-primitive latencies derived from the
DRAM timings, the activations each primitive issues (for the per-rank
tRRD / tFAW stagger), and the evaluated platforms.
:class:`repro_torch.core.scheduler.ChannelScheduler` turns these into a
scheduled makespan.  The energy, host-transfer and CPU/GPU baseline
costs are not ported.
"""

from __future__ import annotations

from dataclasses import dataclass

from .machine import PuDOp


@dataclass(frozen=True)
class DramTimings:
    """DDR4-2666 19-19-19 unless noted; nanoseconds."""

    tCK: float = 0.75
    tRCD: float = 14.25
    tRP: float = 14.25
    tRAS: float = 32.0
    tRRD_L: float = 4.9       # same bank group ACT->ACT
    tFAW: float = 30.0        # max 4 ACTs per rank per window

    # RowCopy is AAP (ACT->ACT->PRE); TRA/APA are ACT(-PRE-ACT) with a
    # final PRE: all dominated by tRAS + tRP
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
    """One evaluated platform (paper Tables 1, 2, 5).  Frozen, hence
    hashable: it keys the planner's probe cache."""

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
# one PuD-enabled rank per DIMM.
DESKTOP = SystemConfig(
    name="desktop-ddr4-2666",
    bandwidth_gbps=42.6,
    channels=2,
    ranks_per_channel=2,
    banks_per_rank=16,
    cols_per_bank=65536,
    host_power_w=80.0,
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
# per-stack parallelism 2KB-row x 16 banks x 8 channels.
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
    """Time (ns) of one broadcast primitive across ``banks`` concurrently
    active banks (default: every bank of a rank): the per-rank ACT
    stagger, ``max(tFAW/4, tRRD_L)`` a step, plus the op's latency."""
    t = sys.timings
    acts = ACTS_PER_OP[op]
    banks = sys.banks_per_rank if banks is None \
        else min(banks, sys.banks_per_rank)
    act_gap = max(t.tFAW / 4.0, t.tRRD_L)
    total_acts_per_rank = acts * banks
    stagger = (total_acts_per_rank - 1) * act_gap
    return stagger + op_latency(op, t)
