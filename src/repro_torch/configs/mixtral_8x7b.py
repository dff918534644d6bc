"""mixtral-8x7b -- 8 experts top-2 MoE with sliding-window attention.
[arXiv:2401.04088; hf]  32L d_model=4096 32H (GQA kv=8) d_ff=14336."""

from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab=32000,
    block_pattern=("local",),    # SWA on every layer
    window=4096,
    mlp="silu_glu",
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=14336),
    long_context_ok=True,        # KV bounded by the 4096 window
)
