"""Model-FLOP accounting, and the card's peaks to set it against.

Counterpart of the reference package's ``launch/roofline.py`` for one
card: the model FLOPs of a train or decode step.  The reference's
roofline terms come from its compiled artifacts and mesh, which the
port does not have, so they are not ported.

Hardware model: NVIDIA H100 SXM5 80 GB at 700 W, from NVIDIA's H100
data sheet: 989 TFLOP/s dense bf16 on the tensor cores (1,979 with
sparsity), 3.35 TB/s HBM3.
"""

from __future__ import annotations

PEAK_FLOPS = 989e12       # dense bf16 FLOP/s
HBM_BW = 3.35e12          # bytes/s


def model_flops_train(n_params_active: float, tokens: float) -> float:
    """6·N·D for a train step (fwd 2ND + bwd 4ND)."""
    return 6.0 * n_params_active * tokens


def model_flops_decode(n_params_active: float, tokens: float) -> float:
    return 2.0 * n_params_active * tokens
