"""--arch id -> ModelConfig registry (the 10 assigned architectures)."""

from . import (
    gemma2_27b,
    granite_moe_3b,
    jamba_52b,
    llava_next_34b,
    minitron_8b,
    mixtral_8x7b,
    nemotron4_340b,
    qwen25_32b,
    rwkv6_3b,
    whisper_base,
)
from .base import SHAPES, ModelConfig, ShapeConfig  # noqa: F401

ARCHS: dict[str, ModelConfig] = {
    "rwkv6-3b": rwkv6_3b.CONFIG,
    "llava-next-34b": llava_next_34b.CONFIG,
    "granite-moe-3b-a800m": granite_moe_3b.CONFIG,
    "mixtral-8x7b": mixtral_8x7b.CONFIG,
    "gemma2-27b": gemma2_27b.CONFIG,
    "qwen2.5-32b": qwen25_32b.CONFIG,
    "minitron-8b": minitron_8b.CONFIG,
    "nemotron-4-340b": nemotron4_340b.CONFIG,
    "whisper-base": whisper_base.CONFIG,
    "jamba-v0.1-52b": jamba_52b.CONFIG,
}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch]


def cells() -> list[tuple[str, str]]:
    """All assigned (arch x shape) cells; pure full-attention archs skip
    ``long_500k``."""
    out = []
    for arch, cfg in ARCHS.items():
        for shape in SHAPES.values():
            if shape.name == "long_500k" and not cfg.long_context_ok:
                continue  # pure full-attention: documented skip
            out.append((arch, shape.name))
    return out
