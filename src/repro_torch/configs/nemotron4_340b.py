"""nemotron-4-340b -- GQA, squared-ReLU.  [arXiv:2402.16819; unverified]
96L d_model=18432 96H (GQA kv=8) d_ff=73728 vocab=256000."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    num_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    d_head=192,
    d_ff=73728,
    vocab=256000,
    block_pattern=("attn",),
    mlp="relu2",
    rope_theta=10000.0,
    opt_dtype="bfloat16",   # ZeRO-sharded optimizer moments in bf16
)
