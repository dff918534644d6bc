"""jamba-v0.1-52b -- Mamba+attention 1:7 interleave with MoE (16e top-2).
[arXiv:2403.19887; hf]  32L d_model=4096 32H (GQA kv=8) d_ff=14336.

Period of 8 layers: attention at in-period index 3 (1:7 attn:mamba), MoE
MLP on every other layer (indices 1,3,5,7), matching Jamba's e=16 top-2
every-second-layer placement."""

from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab=65536,
    block_pattern=("mamba", "mamba", "mamba", "attn",
                   "mamba", "mamba", "mamba", "mamba"),
    mlp="silu_glu",
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=14336,
                  moe_layers=(1, 3, 5, 7)),
    ssm_d_state=16,
    ssm_expand=2,
    long_context_ok=True,
)
