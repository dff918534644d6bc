"""Temporal-coding LUT planes for one chunk: wrapper of the CUDA kernel.

Replaces the TPU kernel ``src/repro/kernels/temporal_encode.py ::
temporal_encode``.  The kernel (``csrc/temporal_encode.cu``) computes
each output word with one warp ballot; it is bound by the bytes it
writes (``(2^k - 1) * W * 4``).  A CPU tensor takes the plain version
:func:`repro_torch.kernels.ref.temporal_encode_ref`.
"""

from __future__ import annotations

import torch

from . import _build
from .common import WORD_BITS, on_card
from .ref import temporal_encode_ref

MAX_K = 16      # grid.y of the kernel covers (2^16 - 1) / 16 plane blocks


def temporal_encode(vals: torch.Tensor, k: int) -> torch.Tensor:
    """vals: [W, 32] int32 chunk values in ``[0, 2^k)`` -> ``[2^k - 1,
    W]`` int32 words, bit ``i`` of word ``[r, w]`` == ``r < vals[w, i]``.
    (The TPU kernel returned rows padded to its block; those rows are
    all zero and the caller sliced them off, so none are made here.)"""
    if vals.dim() != 2 or vals.shape[1] != WORD_BITS:
        raise ValueError(f"vals must be [W, 32], got {tuple(vals.shape)}")
    if vals.dtype != torch.int32:
        raise TypeError(f"vals must be int32, got {vals.dtype}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"chunk width {k} outside [1, {MAX_K}]")
    if not on_card(vals):
        return temporal_encode_ref(vals.reshape(-1), k)
    vals = vals.contiguous()
    w, r = vals.shape[0], (1 << k) - 1
    out = torch.empty((r, w), dtype=torch.int32, device=vals.device)
    lib = _build.load("temporal_encode")
    stream = torch.cuda.current_stream(vals.device).cuda_stream
    err = lib.temporal_encode_launch(vals.data_ptr(), w, r, out.data_ptr(),
                                     stream)
    _build.check(lib, err, "temporal_encode")
    temporal_encode.launches += 1
    return out


temporal_encode.launches = 0
