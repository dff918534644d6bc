"""Min-p logit mask of the serving sampler: wrapper of the CUDA kernel.

Replaces the TPU kernel ``src/repro/kernels/minp_mask.py :: minp_mask``:
keep each logit whose order-preserving uint32 image is at least its row's
threshold's, and write -1e30 elsewhere.  The TPU kernel compares with the
Clutch chunk recurrence; for any chunking whose widths sum to 32 that is
one unsigned compare, which the kernel (``csrc/minp_mask.cu``) evaluates
in one streaming pass over a persistent grid, bound by the 2 * B * V * 4
bytes it reads and writes.  A CPU tensor takes the plain version
:func:`repro_torch.kernels.ref.minp_mask_ref`, which keeps the
recurrence; the two are bit-equal, -0.0 and NaN included.
"""

from __future__ import annotations

import torch

from . import _build
from .common import WORD_BITS, on_card
from .ref import MINP_FILL, minp_mask_ref

#: the most chunks a chunking may have (checked here; the kernel's one
#: compare does not read the chunking)
MAX_CHUNKS = 8
_MAX_DIM = 2 ** 31 - 1       # B and V are C ints in the kernel


def _check_chunks(chunks: tuple[int, ...]) -> None:
    if (not 1 <= len(chunks) <= MAX_CHUNKS or any(k < 1 for k in chunks)
            or sum(chunks) != WORD_BITS):
        raise ValueError(f"chunks must be 1-{MAX_CHUNKS} positive widths "
                         f"summing to {WORD_BITS}, got {chunks}")


def minp_mask(logits: torch.Tensor, tau: torch.Tensor,
              chunks: tuple[int, ...] = (8, 8, 8, 8)) -> torch.Tensor:
    """logits: [B, V] float32; tau: [B] float32.  Returns [B, V] float32:
    a logit where ``m(logit) >= m(tau_b)`` (see
    :func:`~repro_torch.kernels.common.float_to_monotonic_u32`), -1e30
    (``MINP_FILL``) elsewhere.  ``chunks`` are the comparison's chunk
    widths, LSB chunk first; they must sum to 32, and then every
    chunking gives the same result."""
    if logits.dim() != 2 or logits.dtype != torch.float32:
        raise ValueError(f"logits must be a 2-D float32 tensor, got "
                         f"{logits.dim()}-D {logits.dtype}")
    b, v = logits.shape
    if tau.shape != (b,) or tau.dtype != torch.float32:
        raise ValueError(f"tau must be a float32 tensor of shape ({b},), "
                         f"got {tuple(tau.shape)} {tau.dtype}")
    chunks = tuple(int(k) for k in chunks)
    _check_chunks(chunks)
    if not on_card(logits, tau):
        return minp_mask_ref(logits, tau, chunks)
    if max(b, v) > _MAX_DIM:
        raise ValueError(f"[{b}, {v}] logits; the kernel takes at most "
                         f"{_MAX_DIM} rows and columns")
    logits, tau = logits.contiguous(), tau.contiguous()
    if logits.data_ptr() % 16:
        logits = logits.clone()          # float4 rows need a 16-byte base
    out = torch.empty_like(logits)
    lib = _build.load("minp_mask")
    stream = torch.cuda.current_stream(logits.device).cuda_stream
    err = lib.minp_mask_launch(logits.data_ptr(), tau.data_ptr(), b, v,
                               MINP_FILL, out.data_ptr(), stream)
    _build.check(lib, err, "minp_mask")
    minp_mask.launches += 1
    return out


minp_mask.launches = 0
