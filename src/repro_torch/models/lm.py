"""Model composition for decoder LMs of the block kinds ``attn``,
``local`` and ``global``, with period-stacked parameters.

Counterpart of the reference package's ``models/lm.py``.  The public
functions keep its layouts, so a test compares trees leaf by leaf:
parameters and caches are nested dicts of tensors whose per-block leaves
carry a leading period axis (``[num_periods, ...]``; caches
``[num_periods, B, S, KV*dh]``).  The reference's ``lax.scan`` over
periods is a Python loop over period indices here, and there is no jit.

Public surface:
  init_params                       -- params, from a torch.Generator
  forward_logits                    -- full-sequence logits
  prefill                           -- forward + KV cache construction
  init_cache / decode_step          -- one-token decode (cache in place)

Not ported yet (``ROADMAP.md`` Queue 1, the modules still missing): the
``mamba`` and ``rwkv`` blocks, MoE layers, the ``frontend`` stubs and the
encoder-decoder; they raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.common import resolve_device

from . import layers as L

Params = dict[str, Any]
ATTN_KINDS = ("attn", "local", "global")


def _window_for(cfg: ModelConfig, kind: str) -> int | None:
    return cfg.window if kind == "local" else None


def _check_supported(cfg: ModelConfig) -> None:
    for kind in cfg.block_pattern:
        if kind not in ATTN_KINDS:
            raise L.not_ported(f"the {kind!r} block")
    if cfg.moe is not None:
        raise L.not_ported("layers.moe (mixtral, granite, jamba)")
    if cfg.enc_dec:
        raise L.not_ported("the encoder-decoder (whisper)")
    if cfg.frontend is not None:
        raise L.not_ported("models/frontends.py (llava)")


def _check_inputs(batch: Params) -> None:
    if "embeds" in batch:
        raise L.not_ported("models/frontends.py (llava)")


def _period(tree: Params, i: int) -> Params:
    """Period ``i``'s slice of a period-stacked tree (views, no copy)."""
    return {k: _period(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _stack(trees: list[Params]) -> Params:
    return {k: _stack([t[k] for t in trees]) if isinstance(v, dict)
            else torch.stack([t[k] for t in trees])
            for k, v in trees[0].items()}


# ------------------------------------------------------------------ #
# Init
# ------------------------------------------------------------------ #

def _block_init(cfg: ModelConfig, gen: torch.Generator,
                device: torch.device) -> Params:
    """One block's parameters for every period at once ([P, ...])."""
    lead = (cfg.num_periods,)
    return {"norm1": L.rmsnorm_init(cfg, device, lead),
            "attn": L.attn_init(cfg, gen, device, lead),
            "norm2": L.rmsnorm_init(cfg, device, lead),
            "mlp": L.mlp_init(cfg, gen, device, lead)}


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> Params:
    """Parameters with the reference's init scheme and scales (normal
    draws times 1/sqrt(fan-in), embeddings times 0.02, norm scales ones,
    biases zeros), drawn from ``generator`` on its own device and placed
    on ``device`` (the card unless another is named).  The numbers differ
    from the reference's: its keys are not torch's generators."""
    _check_supported(cfg)
    device = resolve_device(device)
    return {
        "embed": L.embed_init(cfg, generator, device),
        "final_norm": L.rmsnorm_init(cfg, device),
        "periods": {f"block{i}": _block_init(cfg, generator, device)
                    for i in range(len(cfg.block_pattern))},
    }


# ------------------------------------------------------------------ #
# Full-sequence forward
# ------------------------------------------------------------------ #

def _apply_block(cfg: ModelConfig, kind: str, p: Params, x: torch.Tensor,
                 positions: torch.Tensor) -> torch.Tensor:
    h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
    x = x + L.attention(cfg, p["attn"], h, positions,
                        window=_window_for(cfg, kind))
    h2 = L.rmsnorm(p["norm2"], x, cfg.norm_eps)
    return x + L.mlp(cfg, p["mlp"], h2)


def forward_logits(cfg: ModelConfig, params: Params, batch: Params
                   ) -> torch.Tensor:
    """batch: {"tokens": [B, S] integer}.  Returns logits [B, S, V_pad]
    float32."""
    _check_supported(cfg)
    _check_inputs(batch)
    x = L.embed(cfg, params["embed"], batch["tokens"])
    positions = torch.arange(x.shape[1], device=x.device)
    for i in range(cfg.num_periods):
        pp = _period(params["periods"], i)
        for j, kind in enumerate(cfg.block_pattern):
            x = _apply_block(cfg, kind, pp[f"block{j}"], x, positions)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return L.lm_head(cfg, params["embed"], x)


# ------------------------------------------------------------------ #
# Serving: cache init, prefill, decode
# ------------------------------------------------------------------ #

def _block_cache(cfg: ModelConfig, kind: str, b: int, s_max: int,
                 device: torch.device) -> Params:
    dt = L.cdtype(cfg)
    kvd = cfg.n_kv_heads * cfg.d_head
    p = cfg.num_periods
    s = min(s_max, cfg.window or s_max) if kind == "local" else s_max
    cache = {"k": torch.zeros((p, b, s, kvd), dtype=dt, device=device),
             "v": torch.zeros((p, b, s, kvd), dtype=dt, device=device)}
    if kind == "local":
        cache["kpos"] = torch.full((p, s), -(1 << 30), dtype=torch.int32,
                                   device=device)
    return cache


def init_cache(cfg: ModelConfig, b: int, s_max: int, device=None) -> Params:
    """Zeroed decode cache for ``b`` sequences of ``s_max`` positions;
    sliding-window blocks hold ``min(s_max, window)`` rolling slots with
    their absolute positions in ``kpos`` (-2^30 = empty)."""
    _check_supported(cfg)
    device = resolve_device(device)
    return {f"block{i}": _block_cache(cfg, kind, b, s_max, device)
            for i, kind in enumerate(cfg.block_pattern)}


def decode_step(cfg: ModelConfig, params: Params, cache: Params,
                tokens: torch.Tensor, pos: int
                ) -> tuple[torch.Tensor, Params]:
    """tokens: [B, 1] integer; pos: the position every row decodes at.
    Returns (logits [B, 1, V_pad] float32, cache).  The reference returns
    a new cache; this writes the step's K/V rows (and rolling positions)
    into ``cache`` in place and returns it."""
    _check_supported(cfg)
    pos = int(pos)
    x = L.embed(cfg, params["embed"], tokens)
    for i in range(cfg.num_periods):
        pp = _period(params["periods"], i)
        for j, kind in enumerate(cfg.block_pattern):
            p, c = pp[f"block{j}"], cache[f"block{j}"]
            h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
            y, _, _, _ = L.attention_decode(
                cfg, p["attn"], h, c["k"][i], c["v"][i], pos,
                window=_window_for(cfg, kind),
                kpos=c["kpos"][i] if "kpos" in c else None)
            x = x + y
            h2 = L.rmsnorm(p["norm2"], x, cfg.norm_eps)
            x = x + L.mlp(cfg, p["mlp"], h2)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return L.lm_head(cfg, params["embed"], x), cache


def prefill(cfg: ModelConfig, params: Params, batch: Params,
            max_len: int | None = None) -> tuple[torch.Tensor, Params]:
    """Run the full prompt, building the decode cache (sized for
    ``max_len`` total positions; defaults to the prompt length).  Returns
    (last-position logits [B, 1, V_pad], cache).  Sliding-window blocks
    roll the last ``min(window, max_len)`` positions into their bounded
    buffer at slot ``pos % cache_len``."""
    _check_supported(cfg)
    _check_inputs(batch)
    x = L.embed(cfg, params["embed"], batch["tokens"])
    b, s = batch["tokens"].shape
    dev = x.device
    positions = torch.arange(s, device=dev)
    total = max_len or s
    caches = []
    for i in range(cfg.num_periods):
        pp = _period(params["periods"], i)
        pcache = {}
        for j, kind in enumerate(cfg.block_pattern):
            p = pp[f"block{j}"]
            h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
            win = _window_for(cfg, kind)
            kc, vc = L.project_kv(cfg, p["attn"], h, positions)
            # the same K/V the reference projects a second time inside
            # attention: the values are equal, the work is done once
            out = L.attention(cfg, p["attn"], h, positions, k=kc, v=vc,
                              window=win)
            if win is not None:
                clen = min(win, total)
                kept = torch.arange(max(0, s - clen), s, device=dev)
                slots = kept % clen
                kz = kc.new_zeros((b, clen, kc.shape[2]))
                vz = vc.new_zeros((b, clen, vc.shape[2]))
                kz[:, slots], vz[:, slots] = kc[:, kept], vc[:, kept]
                kpos = torch.full((clen,), -(1 << 30), dtype=torch.int32,
                                  device=dev)
                kpos[slots] = kept.to(torch.int32)
                pcache[f"block{j}"] = {"k": kz, "v": vz, "kpos": kpos}
            else:
                if total > s:
                    kc = torch.nn.functional.pad(kc, (0, 0, 0, total - s))
                    vc = torch.nn.functional.pad(vc, (0, 0, 0, total - s))
                pcache[f"block{j}"] = {"k": kc, "v": vc}
            x = x + out
            h2 = L.rmsnorm(p["norm2"], x, cfg.norm_eps)
            x = x + L.mlp(cfg, p["mlp"], h2)
        caches.append(pcache)
    x = L.rmsnorm(params["final_norm"], x[:, -1:], cfg.norm_eps)
    return L.lm_head(cfg, params["embed"], x), _stack(caches)
