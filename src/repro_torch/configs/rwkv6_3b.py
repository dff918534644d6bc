"""rwkv6-3b -- Finch: attention-free, data-dependent decay linear attention.
[arXiv:2404.05892; hf]  32L d_model=2560 d_ff=8960 vocab=65536."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    num_layers=32,
    d_model=2560,
    n_heads=40,              # 2560 / 64 per-head
    n_kv_heads=40,
    d_head=64,
    d_ff=8960,
    vocab=65536,
    block_pattern=("rwkv",),
    mlp="rwkv_ffn",          # RWKV channel-mix (relu^2 gated variant)
    rwkv_head_dim=64,
    long_context_ok=True,    # O(1)-state decode
)
