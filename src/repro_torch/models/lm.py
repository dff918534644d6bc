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
  init_params / param_specs         -- params, from a torch.Generator, and
                                       the matching partition-spec tree
  forward_logits                    -- full-sequence logits (tokens or
                                       embeds, + enc_embeds for enc-dec)
  forward_loss                      -- training loss, through autograd
  prefill                           -- forward + KV/state cache construction
  init_cache / decode_step          -- one-token decode (cache in place)
  cache_specs                       -- the partition-spec tree of a cache

On a mesh the same functions run over DTensor parameters and batches
(:mod:`repro_torch.train.train_step`), under
``torch.distributed.tensor.experimental.implicit_replication`` so the
plain tensors they make (positions, masks, RoPE tables) join as
replicated.
"""

from __future__ import annotations

import contextlib
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import (
    DP_AXES,
    P,
    constrain,
    gather_dp,
    is_dtensor,
)
from repro_torch.kernels.common import resolve_device
from repro_torch.tracing import span

from . import layers as L
from . import ssm as S

Params = dict[str, Any]
ATTN_KINDS = ("attn", "local", "global")
#: the residual stream [B, S, D] on a mesh, at every block's input and
#: its norm2: the batch over the data-parallel axes, the rest replicated.
#: DTensor otherwise carries whatever layout an operand had (the
#: embedding table's d_model on "data", a sequence split) from block to
#: block.
BATCH_SPEC = P(DP_AXES, None, None)
#: logits [B, S, V] on a mesh: the batch over the data-parallel axes,
#: the vocab over "model" (the loss reduces over it in place)
LOGITS_SPEC = P(DP_AXES, None, "model")
#: the tracing spans of :func:`prefill` and :func:`period_decode`: a
#: block's attention or mamba mixer, and an MoE FFN (under a profiler
#: only, :func:`repro_torch.tracing.span`)
SPANS = {"attn": "lm.attn", "local": "lm.attn", "global": "lm.attn",
         "mamba": "lm.mamba", "moe": "lm.moe"}


def _span(key: str | None):
    name = SPANS.get(key)
    return span(name) if name else contextlib.nullcontext()


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


def _block_specs(cfg: ModelConfig, kind: str, idx: int,
                 with_cross: bool = False) -> Params:
    p: Params = {"norm1": L.rmsnorm_specs(cfg)}
    if kind in ATTN_KINDS:
        p["attn"] = L.attn_specs(cfg)
    elif kind == "mamba":
        p["mamba"] = S.mamba_specs(cfg)
    elif kind == "rwkv":
        p["rwkv"] = S.rwkv_specs(cfg)
    if with_cross:
        p["norm_x"] = L.rmsnorm_specs(cfg)
        p["cross"] = L.attn_specs(cfg)
    p["norm2"] = L.rmsnorm_specs(cfg)
    if kind == "rwkv":
        p["ffn"] = S.rwkv_ffn_specs(cfg)
    elif _is_moe_layer(cfg, idx):
        p["moe"] = L.moe_specs(cfg)
    else:
        p["mlp"] = L.mlp_specs(cfg)
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


def _add_period_dim(tree: Params) -> Params:
    return {k: _add_period_dim(v) if isinstance(v, dict)
            else P(*((None,) + tuple(v))) for k, v in tree.items()}


def param_specs(cfg: ModelConfig) -> Params:
    """The partition-spec tree matching :func:`init_params`: the
    reference's, with the period axis of every stacked leaf replicated."""
    period = {f"block{i}": _block_specs(cfg, kind, i, with_cross=cfg.enc_dec)
              for i, kind in enumerate(cfg.block_pattern)}
    specs: Params = {
        "embed": L.embed_specs(cfg),
        "final_norm": L.rmsnorm_specs(cfg),
        "periods": _add_period_dim(period),
    }
    if cfg.enc_dec:
        enc = {"block0": _block_specs(cfg, "attn", 0)}
        specs["enc_periods"] = _add_period_dim(enc)
        specs["enc_final_norm"] = L.rmsnorm_specs(cfg)
    return specs


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
    x = constrain(x, BATCH_SPEC)
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
    x = constrain(x, BATCH_SPEC)
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


def period_fn(cfg: ModelConfig, pparams: Params, x: torch.Tensor,
              positions: torch.Tensor, enc_out: Params | None = None
              ) -> torch.Tensor:
    """One period of blocks over the full sequence (the forward's body;
    the dry run also counts it alone)."""
    pparams = gather_dp(pparams)
    for j, kind in enumerate(cfg.block_pattern):
        x = _apply_block(cfg, kind, pparams[f"block{j}"], x, positions,
                         enc_out=enc_out)
    return x


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
        return _apply_block(cfg, "attn", gather_dp(pp["block0"]), x,
                            positions, causal=False)

    x = _scan_periods(cfg, body, x, _unbind(params["enc_periods"],
                                            cfg.enc_layers))
    return L.rmsnorm(params["enc_final_norm"], x, cfg.norm_eps)


def _cross_kv(cfg: ModelConfig, params: Params, enc_x: torch.Tensor
              ) -> Params:
    """Per-decoder-period cross K/V [P, B, Se, KV*dh] (flat layout) of
    the encoder output."""
    p = gather_dp(params["periods"]["block0"]["cross"])
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


def _embed(cfg: ModelConfig, params: Params, tokens: torch.Tensor
           ) -> torch.Tensor:
    return constrain(L.embed(cfg, gather_dp(params["embed"]), tokens),
                     BATCH_SPEC)


def _head(cfg: ModelConfig, params: Params, x: torch.Tensor
          ) -> torch.Tensor:
    """The final norm and the LM head; on a mesh the logits keep the
    vocab over "model" (:data:`LOGITS_SPEC`)."""
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return constrain(L.lm_head(cfg, gather_dp(params["embed"]), x),
                     LOGITS_SPEC)


def _inputs(cfg: ModelConfig, params: Params, batch: Params
            ) -> tuple[torch.Tensor, Params | None]:
    """The decoder's input activations and, for an encoder-decoder, the
    cross K/V of its encoded ``enc_embeds``."""
    if "embeds" in batch:
        x = batch["embeds"].to(L.cdtype(cfg))
    else:
        x = _embed(cfg, params, batch["tokens"])
    cross = None
    if cfg.enc_dec:
        enc = constrain(batch["enc_embeds"].to(x.dtype), BATCH_SPEC)
        enc_x = _encode(cfg, params, enc)
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
        return period_fn(cfg, pp, x, positions, enc_out=ckv)

    args = _unbind(params["periods"], n)
    if cross is not None:
        args = list(zip(args, _unbind(cross, n)))
    x = _scan_periods(cfg, body, x, args)
    return _head(cfg, params, x)


def logsumexp(logits: torch.Tensor) -> torch.Tensor:
    """``torch.logsumexp`` over the last axis.  On a DTensor it is
    spelled out -- max, exp, sum, log -- so each reduction runs over the
    vocab where it is sharded and joins the ranks' partial results,
    rather than DTensor moving the vocab whole onto each rank (and the
    sequence over "model" in its place)."""
    if not is_dtensor(logits):
        return torch.logsumexp(logits, dim=-1)
    m = logits.detach().amax(-1, keepdim=True)
    return (logits - m).exp().sum(-1).log() + m[..., 0]


def gold_logits(logits: torch.Tensor, labels: torch.Tensor
                ) -> torch.Tensor:
    """``logits[..., labels]`` along the last axis (labels >= 0).  On a
    DTensor, the one nonzero term of a sum over the vocab, which stays
    sharded (DTensor has no gather along a sharded axis); x + 0 + ... +
    0 is x exactly."""
    if not is_dtensor(logits):
        return logits.gather(-1, labels[..., None])[..., 0]
    vocab = torch.arange(logits.shape[-1], device=labels.device)
    return torch.where(vocab == labels[..., None], logits, 0.0).sum(-1)


def forward_loss(cfg: ModelConfig, params: Params, batch: Params
                 ) -> torch.Tensor:
    """Mean next-token cross-entropy over ``forward_logits`` (the padded
    vocab, as the reference).  labels: [B, S] integer, < 0 = pad: those
    positions are left out of the sum and of the count."""
    logits = forward_logits(cfg, params, batch)       # [B, S, V] f32
    labels = batch["labels"].long()
    logz = logsumexp(logits)
    gold = gold_logits(logits, labels.clamp(min=0))
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


def cache_specs(cfg: ModelConfig) -> Params:
    """The partition-spec tree matching :func:`init_cache`: batch on
    "data", heads / channels on "model" (the reference's; "model" on a
    head dimension that does not divide is split unevenly by
    ``constrain(..., allow_uneven=True)`` and dropped by ``fit``)."""
    def spec_for(kind):
        if kind == "local":
            return {"k": P(None, "data", None, "model"),
                    "v": P(None, "data", None, "model"),
                    "kpos": P(None, None)}
        if kind in ("attn", "global"):
            if cfg.sp_decode:
                # sequence-parallel decode: cache S over every axis
                return {"k": P(None, None, ("data", "model"), None),
                        "v": P(None, None, ("data", "model"), None)}
            return {"k": P(None, "data", None, "model"),
                    "v": P(None, "data", None, "model")}
        if kind == "mamba":
            return {"ssm": P(None, "data", "model", None),
                    "conv": P(None, "data", None, "model")}
        if kind == "rwkv":
            return {"state": P(None, "data", "model", None, None),
                    "x_tm": P(None, "data", None),
                    "x_cm": P(None, "data", None)}
    return {f"block{i}": spec_for(kind)
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
    x = _embed(cfg, params, tokens)
    posv = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    for i in range(cfg.num_periods):
        x = period_decode(cfg, _period(params["periods"], i),
                          _period(cache, i), x, pos,
                          _period(cross, i) if cross is not None else None,
                          posv)
    return _head(cfg, params, x), cache


def period_decode(cfg: ModelConfig, pparams: Params, pcache: Params,
                  x: torch.Tensor, pos: int, ckv: Params | None = None,
                  posv: torch.Tensor | None = None) -> torch.Tensor:
    """One period of :func:`decode_step`: ``x`` [B, 1, D] through its
    blocks at ``pos``, the period's cache slices written in place
    (``posv``: ``pos`` as a tensor, made here when not given)."""
    if posv is None:
        posv = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    pparams = gather_dp(pparams)
    for j, kind in enumerate(cfg.block_pattern):
        p, c = pparams[f"block{j}"], pcache[f"block{j}"]
        x = constrain(x, BATCH_SPEC)
        h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
        with _span(kind):
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
        with _span("moe" if "moe" in p else None):
            x, xl2 = _ffn(cfg, kind, p, x, x_last=c.get("x_cm"))
        if xl2 is not None:
            c["x_cm"].copy_(xl2)
    return x


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
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)
    total = max_len or s
    caches = []
    for i in range(cfg.num_periods):
        pp = gather_dp(_period(params["periods"], i))
        ckv = _period(cross, i) if cross is not None else None
        pcache = {}
        for j, kind in enumerate(cfg.block_pattern):
            p = pp[f"block{j}"]
            x = constrain(x, BATCH_SPEC)
            h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
            with _span(kind):
                out, pc = _prefill_mixer(cfg, kind, p, h, positions, total)
            x = _cross(cfg, p, x + out, positions, ckv)
            with _span("moe" if "moe" in p else None):
                x, xl2 = _ffn(cfg, kind, p, x)
            if xl2 is not None:
                pc["x_cm"] = xl2
            pcache[f"block{j}"] = pc
        caches.append(pcache)
    return _head(cfg, params, x[:, -1:]), _stack(caches)


def _prefill_mixer(cfg: ModelConfig, kind: str, p: Params, h: torch.Tensor,
                   positions: torch.Tensor, total: int
                   ) -> tuple[torch.Tensor, Params]:
    """One block's mixer over the prompt in :func:`prefill`: (its
    output, the block's cache built for ``total`` positions)."""
    b, s, dev = h.shape[0], h.shape[1], h.device
    if kind == "mamba":
        out, ssm, conv = S.mamba_block(cfg, p["mamba"], h)
        return out, {"ssm": ssm, "conv": conv}
    if kind == "rwkv":
        out, st, xl = S.rwkv_time_mix(cfg, p["rwkv"], h)
        return out, {"state": st, "x_tm": xl}
    win = _window_for(cfg, kind)
    kc, vc = L.project_kv(cfg, p["attn"], h, positions)
    # the same K/V the reference projects a second time inside
    # attention: the values are equal, the work is done once
    out = L.attention(cfg, p["attn"], h, positions, k=kc, v=vc, window=win)
    if win is None:
        if total > s:
            kc = torch.nn.functional.pad(kc, (0, 0, 0, total - s))
            vc = torch.nn.functional.pad(vc, (0, 0, 0, total - s))
        return out, {"k": kc, "v": vc}
    clen = min(win, total)
    kept = torch.arange(max(0, s - clen), s, device=dev)
    slots = kept % clen
    kz = kc.new_zeros((b, clen, kc.shape[2]))
    vz = vc.new_zeros((b, clen, vc.shape[2]))
    kz[:, slots], vz[:, slots] = kc[:, kept], vc[:, kept]
    kpos = torch.full((clen,), -(1 << 30), dtype=torch.int32, device=dev)
    kpos[slots] = kept.to(torch.int32)
    return out, {"k": kz, "v": vz, "kpos": kpos}
