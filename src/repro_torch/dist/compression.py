"""Gradient compression for bandwidth-starved data parallelism.

Counterpart of the reference package's ``dist/compression.py``, bit for
bit: symmetric per-tensor int8, ``q = round(g / scale)`` (half to even,
as ``jnp.round``) clipped to +-127, with ``scale = max|g| / 127`` in
float32; an all-zero tensor has scale 0 and quantizes to zeros.
"""

from __future__ import annotations

import torch

INT8_MAX = 127.0


def quantize(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """float tensor -> (int8 tensor, float32 0-d scale)."""
    g = g.float()
    amax = torch.max(torch.abs(g))
    # a tensor divisor: on the card a Python one becomes a reciprocal
    scale = amax / torch.tensor(INT8_MAX, device=g.device)
    safe = torch.where(scale > 0, scale, 1.0)
    q = torch.clamp(torch.round(g / safe), -INT8_MAX, INT8_MAX)
    return q.to(torch.int8), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale
