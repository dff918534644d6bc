"""minitron-8b -- pruned Nemotron-4 (squared-ReLU MLP).
[arXiv:2407.14679; hf]  32L d_model=4096 32H (GQA kv=8) d_ff=16384."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=16384,
    vocab=256000,
    block_pattern=("attn",),
    mlp="relu2",
)
