"""Model/arch configuration schema, copied from the reference package.

Every assigned architecture is one frozen ``ModelConfig`` in its own file
under ``repro_torch/configs``; ``repro_torch.configs.registry`` maps
``--arch`` ids to them.  ``reduced()`` returns the same family at
smoke-test scale.  The configs are pure data, equal field for field to the
reference's, so one arch id names the same model in both packages; the
fields and values marked "port only" express models the reference
cannot (a configuration outside the registry sets them) and hold their
defaults in every registry entry.  The port reads a field only it has
with ``getattr`` and its default, as the tests hand the port the
reference's config objects.

Layer structure is expressed as a repeating *period*: ``block_pattern`` is
the tuple of block kinds inside one period (e.g. gemma2 ``("local",
"global")``, jamba ``("mamba",)*3 + ("attn",) + ("mamba",)*4``); the model
stacks parameters per period and loops over periods.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

BLOCK_KINDS = ("attn", "local", "global", "mamba", "rwkv")


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    # which in-period block indices use MoE MLPs (None => all)
    moe_layers: tuple[int, ...] | None = None
    # expert-queue capacity = tokens*top_k/num_experts * this factor;
    # capacity_factor == num_experts is the exact no-drop setting.
    # None (port only): no capacity, each expert's products run over
    # the rows routed to it, none dropped and none padded
    capacity_factor: float | None = 1.25
    # (port only) True: softmax over the top_k logits (Mixtral's gate);
    # False: softmax over every expert, its top_k probabilities kept as
    # they are (Jamba's)
    renormalize: bool = True


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    block_pattern: tuple[str, ...] = ("attn",)
    window: int | None = None       # sliding-window size for "local"/SWA
    attn_softcap: float | None = None
    logit_softcap: float | None = None
    qkv_bias: bool = False
    mlp: str = "silu_glu"           # silu_glu | gelu | relu2 | geglu
    moe: MoEConfig | None = None
    # ssm hyper-params (mamba blocks)
    ssm_d_state: int = 16
    ssm_d_conv: int = 4
    ssm_expand: int = 2
    # (port only) RMSNorms with learnt scales on the mamba mixer's dt,
    # B and C (Jamba's dt_layernorm, b_layernorm, c_layernorm)
    ssm_dt_bc_norm: bool = False
    rwkv_head_dim: int = 64
    frontend: str | None = None     # vision_stub | audio_stub
    enc_dec: bool = False
    enc_layers: int = 0
    # None (port only): no positional encoding, attention sees positions
    # through its causal mask alone (Jamba)
    rope_theta: float | None = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # distribution / numerics knobs (overridable per arch)
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    opt_dtype: str = "float32"
    remat: bool = True
    # perf-iteration flags of the reference; baseline = False/None
    moe_dp_sharding: bool = False   # constrain MoE dispatch buffer to DP
    attn_q_chunk: int | None = None # chunk attention over query blocks
    attn_shard_heads: bool = False  # head-sharded scores (GQA expanded)
    attn_scores_bf16: bool = False  # bf16 score matmul (no-softcap archs)
    sp_decode: bool = False         # sequence-parallel flash-decode (500k)
    rwkv_chunk: int | None = None   # chunked-parallel RWKV time-mix (GLA)
    # sub-quadratic decode support: can this arch decode at 500k context?
    # (attention-free, hybrid, or bounded-KV sliding window / alternating)
    long_context_ok: bool = False

    # ------------------------------------------------------------------ #
    @property
    def num_periods(self) -> int:
        assert self.num_layers % len(self.block_pattern) == 0, self.name
        return self.num_layers // len(self.block_pattern)

    @property
    def d_inner_ssm(self) -> int:
        return self.ssm_expand * self.d_model

    def reduced(self) -> "ModelConfig":
        """Same family, smoke scale: tiny widths, <=2 periods, few experts,
        tiny vocab.  Keeps block_pattern (and thus the code paths)."""
        pat = self.block_pattern
        moe = None
        if self.moe is not None:
            moe = replace(self.moe, num_experts=min(4, self.moe.num_experts),
                          top_k=min(2, self.moe.top_k), d_ff_expert=64)
        return replace(
            self,
            num_layers=len(pat) * min(2, self.num_periods),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(2, self.n_kv_heads),
            d_head=16,
            d_ff=128,
            vocab=512,
            window=min(self.window, 16) if self.window else None,
            moe=moe,
            enc_layers=min(self.enc_layers, 2),
            rwkv_head_dim=16,
            ssm_d_state=8,
            param_dtype="float32",
            compute_dtype="float32",
        )


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode

    def reduced(self) -> "ShapeConfig":
        return ShapeConfig(self.name, min(self.seq_len, 64),
                           min(self.global_batch, 2), self.kind)


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
