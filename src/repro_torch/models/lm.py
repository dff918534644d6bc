"""Model composition: decoder LMs (dense / MoE / SSM / hybrid) and the
whisper-style encoder-decoder, with period-stacked parameters.

Counterpart of the reference package's ``models/lm.py``.  The public
functions keep its layouts, so a test compares trees leaf by leaf:
parameters and caches are nested dicts of tensors whose per-block leaves
carry a leading period axis (``[num_periods, ...]``; caches
``[num_periods, B, ...]``).  The reference's ``lax.scan`` over periods
is a Python loop over period indices here, and there is no jit.  Where
``cfg.remat`` is set and grad is enabled, each period of the forward
runs under ``torch.utils.checkpoint`` (the reference's
``jax.checkpoint`` of its scan body): its activations are recomputed in
the backward, and the numbers stay the same.

Public surface:
  init_params                       -- params, from a torch.Generator
  forward_logits                    -- full-sequence logits (tokens or
                                       embeds, + enc_embeds for enc-dec)
  forward_loss                      -- training loss, through autograd
  prefill                           -- forward + KV/state cache construction
  init_cache / decode_step          -- one-token decode (cache in place)
"""

from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.common import resolve_device

from . import layers as L
from . import ssm as S

Params = dict[str, Any]
ATTN_KINDS = ("attn", "local", "global")


def _window_for(cfg: ModelConfig, kind: str) -> int | None:
    return cfg.window if kind == "local" else None


def _is_moe_layer(cfg: ModelConfig, idx: int) -> bool:
    if cfg.moe is None:
        return False
    return cfg.moe.moe_layers is None or idx in cfg.moe.moe_layers


def _period(tree: Params, i: int) -> Params:
    """Period ``i``'s slice of a period-stacked tree (views, no copy)."""
    return {k: _period(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _unbind(tree: Params, n: int) -> list[Params]:
    """The ``n`` period slices of a period-stacked tree, one ``unbind``
    a leaf: its backward stacks the slices' gradients once, where ``n``
    indexings would each write a zero-filled gradient of the whole
    leaf."""
    out: list[Params] = [{} for _ in range(n)]
    for k, v in tree.items():
        parts = _unbind(v, n) if isinstance(v, dict) else torch.unbind(v)
        for o, part in zip(out, parts):
            o[k] = part
    return out


def _stack(trees: list[Params]) -> Params:
    return {k: _stack([t[k] for t in trees]) if isinstance(v, dict)
            else torch.stack([t[k] for t in trees])
            for k, v in trees[0].items()}


# ------------------------------------------------------------------ #
# Init
# ------------------------------------------------------------------ #

def _block_init(cfg: ModelConfig, kind: str, idx: int, gen: torch.Generator,
                device: torch.device, lead: tuple[int, ...],
                with_cross: bool = False) -> Params:
    """One block's parameters for every period at once (``lead`` =
    (periods,))."""
    p: Params = {"norm1": L.rmsnorm_init(cfg, device, lead)}
    if kind in ATTN_KINDS:
        p["attn"] = L.attn_init(cfg, gen, device, lead)
    elif kind == "mamba":
        p["mamba"] = S.mamba_init(cfg, gen, device, lead)
    elif kind == "rwkv":
        p["rwkv"] = S.rwkv_init(cfg, gen, device, lead)
    else:
        raise ValueError(kind)
    if with_cross:
        p["norm_x"] = L.rmsnorm_init(cfg, device, lead)
        p["cross"] = L.attn_init(cfg, gen, device, lead)
    p["norm2"] = L.rmsnorm_init(cfg, device, lead)
    if kind == "rwkv":
        p["ffn"] = S.rwkv_ffn_init(cfg, gen, device, lead)
    elif _is_moe_layer(cfg, idx):
        p["moe"] = L.moe_init(cfg, gen, device, lead)
    else:
        p["mlp"] = L.mlp_init(cfg, gen, device, lead)
    return p


def _stack_periods(cfg: ModelConfig, gen: torch.Generator,
                   device: torch.device, num_periods: int,
                   with_cross: bool = False) -> Params:
    return {f"block{i}": _block_init(cfg, kind, i, gen, device,
                                     (num_periods,), with_cross)
            for i, kind in enumerate(cfg.block_pattern)}


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> Params:
    """Parameters with the reference's init scheme and scales (normal
    draws times 1/sqrt(fan-in), embeddings times 0.02, the reference's
    constants elsewhere), drawn from ``generator`` on its own device and
    placed on ``device`` (the card unless another is named).  The
    numbers differ from the reference's: its keys are not torch's
    generators."""
    device = resolve_device(device)
    params: Params = {
        "embed": L.embed_init(cfg, generator, device),
        "final_norm": L.rmsnorm_init(cfg, device),
        "periods": _stack_periods(cfg, generator, device, cfg.num_periods,
                                  with_cross=cfg.enc_dec),
    }
    if cfg.enc_dec:
        params["enc_periods"] = _stack_periods(cfg, generator, device,
                                               cfg.enc_layers)
        params["enc_final_norm"] = L.rmsnorm_init(cfg, device)
    return params


# ------------------------------------------------------------------ #
# Block pieces shared by the forward, prefill and decode
# ------------------------------------------------------------------ #

def _cross(cfg: ModelConfig, p: Params, x: torch.Tensor,
           positions: torch.Tensor, ckv: Params | None) -> torch.Tensor:
    """The decoder block's cross-attention over the encoder's K/V."""
    if ckv is None or "cross" not in p:
        return x
    hx = L.rmsnorm(p["norm_x"], x, cfg.norm_eps)
    return x + L.attention(cfg, p["cross"], hx, positions, k=ckv["k"],
                           v=ckv["v"], cross=True)


def _ffn(cfg: ModelConfig, kind: str, p: Params, x: torch.Tensor,
         x_last: torch.Tensor | None = None
         ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """norm2 and the MLP, MoE or RWKV channel mix, with the residual.
    Returns (x, the channel mix's new last row; None for the others)."""
    h2 = L.rmsnorm(p["norm2"], x, cfg.norm_eps)
    if kind == "rwkv":
        y2, xl = S.rwkv_channel_mix(cfg, p["ffn"], h2, x_last=x_last)
        return x + y2, xl
    if "moe" in p:
        return x + L.moe(cfg, p["moe"], h2), None
    return x + L.mlp(cfg, p["mlp"], h2), None


# ------------------------------------------------------------------ #
# Full-sequence forward
# ------------------------------------------------------------------ #

def _apply_block(cfg: ModelConfig, kind: str, p: Params, x: torch.Tensor,
                 positions: torch.Tensor, enc_out: Params | None = None,
                 causal: bool = True) -> torch.Tensor:
    h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
    if kind in ATTN_KINDS:
        if causal:
            y = L.attention(cfg, p["attn"], h, positions,
                            window=_window_for(cfg, kind))
        else:  # bidirectional (encoder): no mask, no window
            y = L.attention(cfg, p["attn"], h, positions, cross=True)
    elif kind == "mamba":
        y, _, _ = S.mamba_block(cfg, p["mamba"], h)
    elif kind == "rwkv":
        y, _, _ = S.rwkv_time_mix(cfg, p["rwkv"], h)
    x = _cross(cfg, p, x + y, positions, enc_out)
    return _ffn(cfg, kind, p, x)[0]


def _sinusoid(s: int, d: int, dtype: torch.dtype,
              device: torch.device) -> torch.Tensor:
    pos = torch.arange(s, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None]
    ang = pos / (10000.0 ** (2 * dim / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1).to(dtype)


def _encode(cfg: ModelConfig, params: Params, embeds: torch.Tensor
            ) -> torch.Tensor:
    """Whisper-style encoder over precomputed frame embeddings
    (bidirectional attention; sinusoidal absolute positions)."""
    x = embeds + _sinusoid(embeds.shape[1], embeds.shape[2], embeds.dtype,
                           embeds.device)[None]
    positions = torch.arange(x.shape[1], device=x.device)

    def body(x, pp):
        return _apply_block(cfg, "attn", pp["block0"], x, positions,
                            causal=False)

    x = _scan_periods(cfg, body, x, _unbind(params["enc_periods"],
                                            cfg.enc_layers))
    return L.rmsnorm(params["enc_final_norm"], x, cfg.norm_eps)


def _cross_kv(cfg: ModelConfig, params: Params, enc_x: torch.Tensor
              ) -> Params:
    """Per-decoder-period cross K/V [P, B, Se, KV*dh] (flat layout) of
    the encoder output."""
    p = params["periods"]["block0"]["cross"]
    return {name: torch.stack([enc_x @ w[i].to(enc_x.dtype)
                               for i in range(cfg.num_periods)])
            for name, w in (("k", p["wk"]), ("v", p["wv"]))}


def _scan_periods(cfg: ModelConfig, body, x: torch.Tensor,
                  args: list) -> torch.Tensor:
    """``x = body(x, *a)`` for each period's ``a`` in ``args`` (a tree,
    or a tuple of them); each period rematerialised where ``cfg.remat``
    is set and grad is enabled."""
    remat = cfg.remat and torch.is_grad_enabled()
    for a in args:
        a = a if isinstance(a, tuple) else (a,)
        x = (checkpoint(body, x, *a, use_reentrant=False) if remat
             else body(x, *a))
    return x


def _inputs(cfg: ModelConfig, params: Params, batch: Params
            ) -> tuple[torch.Tensor, Params | None]:
    """The decoder's input activations and, for an encoder-decoder, the
    cross K/V of its encoded ``enc_embeds``."""
    if "embeds" in batch:
        x = batch["embeds"].to(L.cdtype(cfg))
    else:
        x = L.embed(cfg, params["embed"], batch["tokens"])
    cross = None
    if cfg.enc_dec:
        enc_x = _encode(cfg, params, batch["enc_embeds"].to(x.dtype))
        cross = _cross_kv(cfg, params, enc_x)
    return x, cross


def forward_logits(cfg: ModelConfig, params: Params, batch: Params
                   ) -> torch.Tensor:
    """batch: {"tokens": [B, S] integer} or {"embeds": [B, S, D]} (+
    {"enc_embeds": [B, Se, D]} for enc-dec).  Returns logits
    [B, S, V_pad] float32."""
    x, cross = _inputs(cfg, params, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    n = cfg.num_periods

    def body(x, pp, ckv=None):
        for j, kind in enumerate(cfg.block_pattern):
            x = _apply_block(cfg, kind, pp[f"block{j}"], x, positions,
                             enc_out=ckv)
        return x

    args = _unbind(params["periods"], n)
    if cross is not None:
        args = list(zip(args, _unbind(cross, n)))
    x = _scan_periods(cfg, body, x, args)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return L.lm_head(cfg, params["embed"], x)


def forward_loss(cfg: ModelConfig, params: Params, batch: Params
                 ) -> torch.Tensor:
    """Mean next-token cross-entropy over ``forward_logits`` (the padded
    vocab, as the reference).  labels: [B, S] integer, < 0 = pad: those
    positions are left out of the sum and of the count."""
    logits = forward_logits(cfg, params, batch)       # [B, S, V] f32
    labels = batch["labels"].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    nll = (logz - gold) * mask
    return nll.sum() / mask.sum().clamp(min=1.0)


# ------------------------------------------------------------------ #
# Serving: cache init, prefill, decode
# ------------------------------------------------------------------ #

def _block_cache(cfg: ModelConfig, kind: str, b: int, s_max: int,
                 device: torch.device) -> Params:
    dt = L.cdtype(cfg)
    p = cfg.num_periods

    def zeros(*shape, dtype=dt):
        return torch.zeros((p,) + shape, dtype=dtype, device=device)

    if kind == "mamba":
        return {"ssm": zeros(b, cfg.d_inner_ssm, cfg.ssm_d_state,
                             dtype=torch.float32),
                "conv": zeros(b, cfg.ssm_d_conv - 1, cfg.d_inner_ssm)}
    if kind == "rwkv":
        hd = cfg.rwkv_head_dim
        return {"state": zeros(b, cfg.d_model // hd, hd, hd,
                               dtype=torch.float32),
                "x_tm": zeros(b, cfg.d_model), "x_cm": zeros(b, cfg.d_model)}
    if kind not in ATTN_KINDS:
        raise ValueError(kind)
    kvd = cfg.n_kv_heads * cfg.d_head
    s = min(s_max, cfg.window or s_max) if kind == "local" else s_max
    cache = {"k": zeros(b, s, kvd), "v": zeros(b, s, kvd)}
    if kind == "local":
        cache["kpos"] = torch.full((p, s), -(1 << 30), dtype=torch.int32,
                                   device=device)
    return cache


def init_cache(cfg: ModelConfig, b: int, s_max: int, device=None) -> Params:
    """Zeroed decode cache for ``b`` sequences of ``s_max`` positions;
    sliding-window blocks hold ``min(s_max, window)`` rolling slots with
    their absolute positions in ``kpos`` (-2^30 = empty); mamba blocks
    their float32 ``ssm`` state and ``conv`` window, rwkv blocks their
    float32 ``state`` and last rows ``x_tm`` / ``x_cm``."""
    device = resolve_device(device)
    return {f"block{i}": _block_cache(cfg, kind, b, s_max, device)
            for i, kind in enumerate(cfg.block_pattern)}


def decode_step(cfg: ModelConfig, params: Params, cache: Params,
                tokens: torch.Tensor, pos: int, cross: Params | None = None
                ) -> tuple[torch.Tensor, Params]:
    """tokens: [B, 1] integer; pos: the position every row decodes at;
    cross: an encoder-decoder's cross K/V (:func:`_cross_kv`).  Returns
    (logits [B, 1, V_pad] float32, cache).  The reference returns a new
    cache; this writes the step's K/V rows (and rolling positions) and
    the new SSM/RWKV states into ``cache`` in place and returns it."""
    pos = int(pos)
    x = L.embed(cfg, params["embed"], tokens)
    posv = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    for i in range(cfg.num_periods):
        pp = _period(params["periods"], i)
        ckv = _period(cross, i) if cross is not None else None
        for j, kind in enumerate(cfg.block_pattern):
            p, c = pp[f"block{j}"], _period(cache[f"block{j}"], i)
            h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
            if kind in ATTN_KINDS:
                y, _, _, _ = L.attention_decode(
                    cfg, p["attn"], h, c["k"], c["v"], pos,
                    window=_window_for(cfg, kind), kpos=c.get("kpos"))
            elif kind == "mamba":
                y, ssm, conv = S.mamba_block(cfg, p["mamba"], h,
                                             ssm_state=c["ssm"],
                                             conv_state=c["conv"])
                c["ssm"].copy_(ssm)
                c["conv"].copy_(conv)
            elif kind == "rwkv":
                y, st, xl = S.rwkv_time_mix(cfg, p["rwkv"], h,
                                            state=c["state"],
                                            x_last=c["x_tm"])
                c["state"].copy_(st)
                c["x_tm"].copy_(xl)
            x = _cross(cfg, p, x + y, posv, ckv)
            x, xl2 = _ffn(cfg, kind, p, x, x_last=c.get("x_cm"))
            if xl2 is not None:
                c["x_cm"].copy_(xl2)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return L.lm_head(cfg, params["embed"], x), cache


def prefill(cfg: ModelConfig, params: Params, batch: Params,
            max_len: int | None = None) -> tuple[torch.Tensor, Params]:
    """Run the full prompt (``batch`` as for :func:`forward_logits`),
    building the decode cache (sized for ``max_len`` total positions;
    defaults to the prompt length).  Returns (last-position logits
    [B, 1, V_pad], cache).  Sliding-window blocks roll the last
    ``min(window, max_len)`` positions into their bounded buffer at slot
    ``pos % cache_len``; SSM/RWKV states are the recurrences' final
    states.  An encoder-decoder's cross K/V are not part of the cache:
    :func:`decode_step` takes them as ``cross``."""
    x, cross = _inputs(cfg, params, batch)
    b, s = x.shape[0], x.shape[1]
    dev = x.device
    positions = torch.arange(s, device=dev)
    total = max_len or s
    caches = []
    for i in range(cfg.num_periods):
        pp = _period(params["periods"], i)
        ckv = _period(cross, i) if cross is not None else None
        pcache = {}
        for j, kind in enumerate(cfg.block_pattern):
            p = pp[f"block{j}"]
            h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
            if kind in ATTN_KINDS:
                win = _window_for(cfg, kind)
                kc, vc = L.project_kv(cfg, p["attn"], h, positions)
                # the same K/V the reference projects a second time
                # inside attention: the values are equal, the work is
                # done once
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
                    pc = {"k": kz, "v": vz, "kpos": kpos}
                else:
                    if total > s:
                        kc = torch.nn.functional.pad(kc, (0, 0, 0, total - s))
                        vc = torch.nn.functional.pad(vc, (0, 0, 0, total - s))
                    pc = {"k": kc, "v": vc}
            elif kind == "mamba":
                out, ssm, conv = S.mamba_block(cfg, p["mamba"], h)
                pc = {"ssm": ssm, "conv": conv}
            elif kind == "rwkv":
                out, st, xl = S.rwkv_time_mix(cfg, p["rwkv"], h)
                pc = {"state": st, "x_tm": xl}
            x = _cross(cfg, p, x + out, positions, ckv)
            x, xl2 = _ffn(cfg, kind, p, x)
            if xl2 is not None:
                pc["x_cm"] = xl2
            pcache[f"block{j}"] = pc
        caches.append(pcache)
    x = L.rmsnorm(params["final_norm"], x[:, -1:], cfg.norm_eps)
    return L.lm_head(cfg, params["embed"], x), _stack(caches)
