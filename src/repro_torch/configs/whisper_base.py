"""whisper-base -- encoder-decoder, conv frontend (STUB: input_specs()
provides precomputed frame embeddings).  [arXiv:2212.04356; unverified]
6L enc + 6L dec, d_model=512 8H d_ff=2048 vocab=51865."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    num_layers=6,            # decoder layers; encoder in enc_layers
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_head=64,
    d_ff=2048,
    vocab=51865,
    block_pattern=("attn",),
    mlp="gelu",
    frontend="audio_stub",
    enc_dec=True,
    enc_layers=6,
)
