"""gemma2-27b -- local+global alternating attention, logit softcaps.
[arXiv:2408.00118; hf]  46L d_model=4608 32H (GQA kv=16) d_ff=36864."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    num_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    d_head=128,
    d_ff=36864,
    vocab=256000,
    block_pattern=("local", "global"),
    window=4096,
    attn_softcap=50.0,
    logit_softcap=30.0,
    mlp="geglu",
    tie_embeddings=True,
    long_context_ok=True,   # local layers bounded; global layers decode with
                            # sequence-sharded KV (SP flash-decode)
)
