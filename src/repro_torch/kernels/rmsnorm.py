"""RMS normalisation: wrapper of the CUDA kernel.

Replaces no TPU kernel: the reference package leaves its norm to XLA
(``src/repro/models/layers.py :: rmsnorm``).  The kernel
(``csrc/rmsnorm.cu``) computes the port's norm, ``x * rsqrt(mean(x^2) +
eps) * (1 + scale)`` in float32 rounded once to x's dtype, in one launch
where the plain version :func:`repro_torch.kernels.ref.rmsnorm_ref`
makes ten; a tensor off the card takes the plain version.  The kernel
has no backward: where a gradient is wanted, it is the plain version's,
recomputed from the inputs in the backward pass
(:func:`~repro_torch.kernels.common.with_plain_grad`).
"""

from __future__ import annotations

import torch

from . import _build
from .common import with_plain_grad
from .ref import rmsnorm_ref

_DTYPES = (torch.float32, torch.bfloat16)
_MAX_BLOCKS = 2 ** 31 - 1


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float
            ) -> torch.Tensor:
    """x: [..., d], or [..., G, d] with scale [G, d] (each of a row's G
    groups of d normed over its own d, with its own scale row); scale:
    [d] or [G, d].  Returns y of x's shape and dtype, contiguous."""
    d = x.shape[-1]
    groups = scale.numel() // d if d else 1
    if scale.shape not in ((d,), (groups, d)) or (
            groups > 1 and (x.dim() < 2 or x.shape[-2] != groups)):
        raise ValueError(f"scale {tuple(scale.shape)} does not fit x "
                         f"{tuple(x.shape)}")
    if not x.is_cuda:
        return rmsnorm_ref(x, scale, eps)
    return with_plain_grad(_launch, rmsnorm_ref, x, scale, eps)


def _launch(x: torch.Tensor, scale: torch.Tensor, eps: float
            ) -> torch.Tensor:
    d = x.shape[-1]
    groups = scale.numel() // d if d else 1
    if x.dtype not in _DTYPES or scale.device != x.device:
        raise ValueError(f"x must be float32 or bfloat16 on scale's device, "
                         f"got {x.dtype} on {x.device}, scale on "
                         f"{scale.device}")
    lead = x.shape[:-2] if groups > 1 else x.shape[:-1]
    rows = x.reshape(-1, groups, d)
    if rows.stride(-1) != 1 or (groups > 1 and rows.stride(-2) != d):
        rows = rows.contiguous()
    tokens = rows.shape[0]
    if -(-tokens * groups // 8) > _MAX_BLOCKS:
        raise ValueError(f"{tokens * groups} rows: too many for one launch")
    if scale.dtype not in _DTYPES:
        scale = scale.float()
    scale = scale.contiguous()
    y = torch.empty(rows.shape, dtype=x.dtype, device=x.device)
    lib = _build.load("rmsnorm")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.rmsnorm_launch(rows.data_ptr(), scale.data_ptr(), y.data_ptr(),
                             tokens, rows.stride(0) if tokens > 1 else 0,
                             groups, d, float(eps),
                             int(x.dtype == torch.bfloat16),
                             int(scale.dtype == torch.bfloat16), stream)
    _build.check(lib, err, "rmsnorm")
    rmsnorm.launches += 1
    return y.view(*lead, *((groups,) if groups > 1 else ()), d)


rmsnorm.launches = 0
