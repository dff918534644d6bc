"""qwen2.5-32b -- GQA with QKV bias.  [hf:Qwen/Qwen2.5-0.5B; hf]
64L d_model=5120 40H (GQA kv=8) d_ff=27648 vocab=152064."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_head=128,
    d_ff=27648,
    vocab=152064,
    block_pattern=("attn",),
    qkv_bias=True,
    mlp="silu_glu",
    rope_theta=1e6,
)
