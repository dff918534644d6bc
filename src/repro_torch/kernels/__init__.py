"""Hand-written Hopper kernels of the port and their plain versions.

Each wrapper launches its CUDA kernel for a CUDA tensor (building the
library on first use) and runs its plain PyTorch version
(:mod:`repro_torch.kernels.ref`) for a CPU tensor; it counts the
kernel's launches in its ``launches`` attribute, and nowhere else.
"""

from __future__ import annotations

from .fused_query import (
    fused_compound_banked,
    fused_predicate_banked,
    gbdt_leafbits_banked,
)
from .temporal_encode import temporal_encode

#: every kernel wrapper, by name
KERNELS = {
    "temporal_encode": temporal_encode,
    "fused_predicate_banked": fused_predicate_banked,
    "fused_compound_banked": fused_compound_banked,
    "gbdt_leafbits_banked": gbdt_leafbits_banked,
}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}
