"""Modality frontends -- stubs, as in the reference package.

Counterpart of the reference's ``models/frontends.py``.  ``[vlm]`` /
``[audio]`` architectures specify the transformer backbone only; the
model takes *precomputed* patch/frame embeddings (``{"embeds"}``,
``{"enc_embeds"}``).  These helpers draw synthetic embeddings for smoke
runs and give the logical input shapes of one cell.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.kernels.common import resolve_device

from .layers import cdtype, weak_scalar


def synthetic_embeds(cfg: ModelConfig, b: int, s: int,
                     generator: torch.Generator, device=None
                     ) -> torch.Tensor:
    """Stand-in for vision-tower patch embeddings / audio conv features:
    normal draws times 0.02 in the compute dtype, [b, s, d_model], drawn
    from ``generator`` on its own device and placed on ``device`` (the
    card unless another is named).  The distribution is the reference's;
    the numbers are not (its keys are not torch's generators)."""
    device = resolve_device(device)
    x = torch.randn((b, s, cfg.d_model), generator=generator,
                    dtype=cdtype(cfg), device=generator.device)
    return (x * weak_scalar(x, 0.02)).to(device)


def batch_shapes(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Logical input shapes (shape, dtype name) for one cell."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        if cfg.enc_dec:
            # audio: encoder frames + decoder tokens
            return {"enc_embeds": ((b, s, cfg.d_model), cfg.compute_dtype),
                    "tokens": ((b, s), "int32"),
                    "labels": ((b, s), "int32")}
        if cfg.frontend == "vision_stub":
            return {"embeds": ((b, s, cfg.d_model), cfg.compute_dtype),
                    "labels": ((b, s), "int32")}
        return {"tokens": ((b, s), "int32"), "labels": ((b, s), "int32")}
    if shape.kind == "prefill":
        if cfg.enc_dec:
            return {"enc_embeds": ((b, s, cfg.d_model), cfg.compute_dtype),
                    "tokens": ((b, 8), "int32")}
        if cfg.frontend == "vision_stub":
            return {"embeds": ((b, s, cfg.d_model), cfg.compute_dtype)}
        return {"tokens": ((b, s), "int32")}
    # decode: one new token against a cache of seq_len
    return {"tokens": ((b, 1), "int32")}
