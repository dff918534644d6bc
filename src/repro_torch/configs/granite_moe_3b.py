"""granite-moe-3b-a800m -- 40 experts top-8 MoE.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
32L d_model=1536 24H (GQA kv=8) d_ff=512/expert vocab=49155."""

from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_head=64,
    d_ff=512,
    vocab=49155,
    block_pattern=("attn",),
    mlp="silu_glu",
    moe=MoEConfig(num_experts=40, top_k=8, d_ff_expert=512),
)
