"""Hand-written Hopper kernels of the port and their plain versions.

Each wrapper launches its CUDA kernel for a CUDA tensor (building the
library on first use) and runs its plain PyTorch version
(:mod:`repro_torch.kernels.ref`) for a CPU tensor; it counts the
kernel's launches in its ``launches`` attribute, and nowhere else.
"""

from __future__ import annotations

from .bitserial_cmp import bitserial_cmp
from .clutch_merge import clutch_merge, clutch_merge_banked
from .fused_query import (
    fused_compound_banked,
    fused_predicate_banked,
    fused_range_count,
    gbdt_leafbits_banked,
    gbdt_leafbits_sum,
)
from .leaf_gather import leaf_gather
from .minp_mask import minp_mask
from .rmsnorm import rmsnorm
from .selective_scan import selective_scan
from .temporal_encode import temporal_encode

#: every kernel wrapper, by name
KERNELS = {
    "temporal_encode": temporal_encode,
    "fused_predicate_banked": fused_predicate_banked,
    "fused_compound_banked": fused_compound_banked,
    "gbdt_leafbits_banked": gbdt_leafbits_banked,
    "gbdt_leafbits_sum": gbdt_leafbits_sum,
    "clutch_merge": clutch_merge,
    "clutch_merge_banked": clutch_merge_banked,
    "fused_range_count": fused_range_count,
    "bitserial_cmp": bitserial_cmp,
    "leaf_gather": leaf_gather,
    "minp_mask": minp_mask,
    "selective_scan": selective_scan,
    "rmsnorm": rmsnorm,
}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}
