"""The one-card parts of the reference's dry-run: the "opt" variant of a
config, and the parameter accounting of a model.

Counterpart of the reference package's ``launch/dryrun.py``, which
AOT-lowers and compiles every (arch x shape x mesh) cell on placeholder
devices of a production mesh.  That lowering, the mesh, the component
compiles and ``input_sds`` have no meaning for the port's one card and
are not ported; what is ported computes on a config alone:

  apply_variant     -- the perf knobs of the "opt" variant
  abstract_params   -- the parameter tree on the meta device (shapes and
                       dtypes; no weights allocated)
  count_params      -- parameters of a tree
  active_params     -- the same, with an MoE's experts counted top_k of
                       num_experts
  microbatches_for  -- microbatches a train cell takes per data shard
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.lm import init_params
from repro_torch.train.tree import flatten

OPT_NOTES = {
    "moe_dp": "MoE dispatch buffer constrained to P(None, data, model)",
    "tp_serve": "serving params TP-only (no FSDP all-gathers at inference)",
    "bigmicro": "4x tokens per microbatch (fewer FSDP gather waves)",
}


def abstract_params(cfg: ModelConfig) -> dict:
    """The parameter tree of ``cfg`` on the meta device."""
    return init_params(cfg, torch.Generator(), torch.device("meta"))


def count_params(tree) -> float:
    return float(sum(leaf.numel() for leaf in flatten(tree).values()))


def active_params(cfg: ModelConfig, tree) -> float:
    """MoE: count only top_k of num_experts expert params as active (a
    leaf whose path has a key containing ``moe`` and one containing
    ``w_in``, ``w_gate`` or ``w_out``)."""
    total = count_params(tree)
    if cfg.moe is None:
        return total
    expert = 0
    for path, leaf in flatten(tree).items():
        keys = path.split("/")
        if any("moe" in k for k in keys) and any(
                w in k for k in keys for w in ("w_in", "w_gate", "w_out")):
            expert += leaf.numel()
    frac = cfg.moe.top_k / cfg.moe.num_experts
    return total - expert * (1.0 - frac)


def microbatches_for(cfg: ModelConfig, shape: ShapeConfig, dp_total: int
                     ) -> int:
    if shape.kind != "train":
        return 1
    per_dev = max(shape.global_batch // dp_total, 1)
    target_tokens = 4096 if cfg.d_model >= 10000 else 8192
    mb_per_dev = max(1, target_tokens // shape.seq_len)
    return max(1, per_dev // mb_per_dev)


def apply_variant(cfg: ModelConfig, variant: str,
                  shape: ShapeConfig | None = None) -> ModelConfig:
    """``cfg`` under ``variant``: itself unless it is ``"opt"``, the
    reference's perf knobs.  Their gates are the reference's, set for
    its mesh (heads >= its 16-way model axis; ``sp_decode`` only in the
    B = 1 ``long_500k`` cell)."""
    if variant != "opt":
        return cfg
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe_dp_sharding=True)
    cfg = dataclasses.replace(
        cfg,
        attn_q_chunk=2048,
        attn_shard_heads=(cfg.n_heads >= 16),
        attn_scores_bf16=(cfg.attn_softcap is None),
        rwkv_chunk=64 if "rwkv" in cfg.block_pattern else None,
    )
    if shape is not None and shape.name == "long_500k":
        cfg = dataclasses.replace(cfg, sp_decode=True)
    return cfg
