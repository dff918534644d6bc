"""Transformer building blocks: norms, RoPE, GQA attention (sliding
window / softcap / bias variants, cross and bidirectional), the MLP
variants and capacity-based MoE.

Counterpart of the reference package's ``models/layers.py``, in plain
tensor functions over explicit parameter dicts, with the same layouts:

  * attention weights are stored fused-2D ([D, H*dh] etc.); head reshapes
    happen inside the computation.
  * the vocab is padded to a multiple of 128 (:func:`padded_vocab`);
    :func:`lm_head` masks the padding logits to ``NEG_INF``.
  * KV caches are stored flat, [B, S, KV*dh].
  * attention is einsum-based in the compute dtype with a float32 softmax,
    as the reference leaves it to XLA outside any kernel.

Casts sit where the reference's sit: the score einsum runs in the
compute dtype and is divided by sqrt(dh) before the float32 cast; RoPE's
float32 cos/sin promote a bf16 input before the cast back.  A Python
float that meets a bf16 tensor is first rounded to bf16, as JAX rounds a
weakly typed scalar (:func:`weak_scalar`).  Every
``*_init`` draws from an explicit ``torch.Generator`` with the
reference's scales (on the meta device, shapes and dtypes only).

Every ``*_init`` has a matching ``*_specs``: the reference's
partition-spec tree of the same shape ("model" the tensor-parallel
axis, "data" the FSDP one; :mod:`repro_torch.dist.sharding`).

The reference's perf knobs (the "opt" variant of its dry-run) compute
as there: ``attn_q_chunk`` runs attention over query blocks, each
reading keys up to its causal (and window) horizon;
``attn_shard_heads`` on a mesh expands the GQA K/V to every head and
shards the scores ``P("data", "model")`` over (batch, heads) (off a
mesh the grouped product computes the same);
``moe_dp_sharding`` constrains the MoE dispatch buffer to
``P(None, "data", "model")``; ``sp_decode`` decodes through
:func:`repro_torch.dist.sp_decode.sp_flash_decode`.  The constraints
redistribute a DTensor under :func:`repro_torch.dist.sharding.use_mesh`
and are the identity otherwise.
"""

from __future__ import annotations

import functools
import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import (
    P,
    batch_spec,
    constrain,
    fit,
    full,
    head_spec,
    is_dtensor,
    known_axes,
    mesh_of,
    run_local,
    split_dim,
)

Params = dict[str, Any]

NEG_INF = -2.0e38
VOCAB_ALIGN = 128


def padded_vocab(cfg: ModelConfig) -> int:
    return (cfg.vocab + VOCAB_ALIGN - 1) // VOCAB_ALIGN * VOCAB_ALIGN


def cdtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def pdtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def _normal(shape, scale: float, cfg: ModelConfig, gen: torch.Generator,
            device: torch.device, lead: tuple[int, ...] = (),
            dtype: torch.dtype | None = None) -> torch.Tensor:
    """Standard normal draws in ``dtype`` (the parameter dtype unless
    named), times ``scale`` in that dtype (as the reference scales its
    draws).  ``lead`` prefixes the shape, so a period-stacked leaf is
    drawn in one piece."""
    if device.type == "meta":
        return torch.empty(lead + tuple(shape), dtype=dtype or pdtype(cfg),
                           device=device)
    x = torch.randn(lead + tuple(shape), generator=gen,
                    dtype=dtype or pdtype(cfg), device=gen.device)
    return x.mul_(scale).to(device)


# ----------------------------- norms ---------------------------------- #

def rmsnorm_init(cfg: ModelConfig, device: torch.device,
                 lead: tuple[int, ...] = ()) -> Params:
    return {"scale": torch.ones(lead + (cfg.d_model,), dtype=pdtype(cfg),
                                device=device)}


def rmsnorm_specs(cfg: ModelConfig) -> Params:
    return {"scale": P(None)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    x32 = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return (x32 * (1.0 + p["scale"].float())).to(dt)


# ----------------------------- RoPE ----------------------------------- #

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x: [..., S, n, d_head]; positions: [S]."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].float() * freqs                 # [S, half]
    cos, sin = torch.cos(ang), torch.sin(ang)
    while cos.dim() < x.dim() - 1:
        cos, sin = cos[None], sin[None]
    cos, sin = cos[..., None, :], sin[..., None, :]            # head axis
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


# --------------------------- attention -------------------------------- #

def attn_init(cfg: ModelConfig, gen: torch.Generator, device: torch.device,
              lead: tuple[int, ...] = ()) -> Params:
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    s = 1.0 / math.sqrt(d)
    p = {
        "wq": _normal((d, h * dh), s, cfg, gen, device, lead),
        "wk": _normal((d, kv * dh), s, cfg, gen, device, lead),
        "wv": _normal((d, kv * dh), s, cfg, gen, device, lead),
        "wo": _normal((h * dh, d), 1.0 / math.sqrt(h * dh), cfg, gen,
                      device, lead),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", h * dh), ("bk", kv * dh), ("bv", kv * dh)):
            p[name] = torch.zeros(lead + (n,), dtype=pdtype(cfg),
                                  device=device)
    return p


def attn_specs(cfg: ModelConfig) -> Params:
    p = {
        "wq": P("data", "model"),
        "wk": P("data", "model"),
        "wv": P("data", "model"),
        "wo": P("model", "data"),
    }
    if cfg.qkv_bias:
        p["bq"] = P("model")
        p["bk"] = P("model")
        p["bv"] = P("model")
    return p


@functools.lru_cache(maxsize=None)
def _constant(value: float, dtype: torch.dtype,
              device: torch.device) -> torch.Tensor:
    return torch.tensor(value, dtype=dtype, device=device)


def weak_scalar(x: torch.Tensor, value: float) -> torch.Tensor:
    """``value`` as a 0-d tensor of ``x``'s dtype and device, for an op
    that JAX writes as ``x <op> python_float``: JAX rounds the weakly
    typed scalar to the array's dtype first (``bf16 / math.sqrt(128)``
    divides by 11.3125), where PyTorch would apply the full float in
    float32 opmath -- and on the card turn a division by a host scalar
    into a product with its reciprocal.  In float32 nothing changes.
    (Cached for plain tensors; a subclass's -- a DTensor, a fake tensor
    -- is made anew, since its mode may not outlive the call.)"""
    if type(x) is not torch.Tensor:
        return torch.tensor(float(value), dtype=x.dtype, device=x.device)
    return _constant(float(value), x.dtype, x.device)


def scale_scores(scores: torch.Tensor, dh: int) -> torch.Tensor:
    """Attention scores divided by sqrt(dh) in their own dtype."""
    return scores / weak_scalar(scores, math.sqrt(dh))


def _softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return x
    return torch.tanh(x / cap) * cap


def _attn_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
               window: int | None) -> torch.Tensor:
    m = k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        m &= k_pos[None, :] > (q_pos[:, None] - window)
    return m


def project_kv(cfg: ModelConfig, p: Params, x: torch.Tensor,
               positions: torch.Tensor | None, rope_keys: bool = True
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """K/V projections in flat cache layout [B, S, KV*dh], RoPE applied
    to the keys unless ``rope_keys`` is False."""
    kv, dh = cfg.n_kv_heads, cfg.d_head
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if "bk" in p:
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    if rope_keys:
        kh = split_dim(k, -1, (kv, dh))
        k = rope(kh, positions, cfg.rope_theta).reshape(k.shape)
    return k, v


def _attend(cfg: ModelConfig, q: torch.Tensor, k_flat: torch.Tensor,
            v_flat: torch.Tensor, mask: torch.Tensor | None
            ) -> torch.Tensor:
    """q: [B, Sq, H, dh]; k/v: [B, Sk, KV*dh]; mask: broadcastable to
    [B, KV, G, Sq, Sk].  Returns [B, Sq, H*dh].  Query head ``h`` reads
    KV head ``h // G`` (the reshape to [B, Sq, KV, G, dh]).  DTensor
    operands go through :func:`_attend_sharded`."""
    if any(is_dtensor(t) for t in (q, k_flat, v_flat)):
        return _attend_sharded(cfg, q, k_flat, v_flat, mask)
    kv, dh = cfg.n_kv_heads, q.shape[-1]
    return _attend_heads(cfg, q, split_dim(k_flat, -1, (kv, dh)),
                         split_dim(v_flat, -1, (kv, dh)), mask)


def _attend_heads(cfg: ModelConfig, q: torch.Tensor, kh: torch.Tensor,
                  vh: torch.Tensor, mask: torch.Tensor | None
                  ) -> torch.Tensor:
    """:func:`_attend` on K/V split into heads, [B, Sk, KV, dh] (KV
    read from ``kh``: a rank's heads on a mesh, where K/V expanded to
    every head make G = 1)."""
    b, sq, h, dh = q.shape
    kv = kh.shape[2]
    g = h // kv
    scores = torch.einsum("bskgh,btkh->bkgst", q.reshape(b, sq, kv, g, dh),
                          kh)
    scores = scale_scores(scores, dh)
    if not (cfg.attn_scores_bf16 and cfg.attn_softcap is None):
        scores = scores.float()
    scores = _softcap(scores, cfg.attn_softcap)
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", w, vh)
    return out.reshape(b, sq, h * dh)


def _attend_sharded(cfg: ModelConfig, q: torch.Tensor, k_flat: torch.Tensor,
                    v_flat: torch.Tensor, mask: torch.Tensor | None
                    ) -> torch.Tensor:
    """:func:`_attend` of DTensors, tensor-parallel over heads: q, K and
    V are laid out ``P(("pod", "data"), None, "model", None)`` (the
    batch over the data-parallel axes, the heads over "model", each
    dropped where it does not divide) and every rank attends its own
    heads of its own sequences, with plain autograd on its pieces
    (:func:`~repro_torch.dist.sharding.run_local`).  The heads are the
    KV heads, so each rank's query heads read its own KV heads; under
    ``attn_shard_heads`` K/V are first expanded to every query head, and
    the heads sharded are the query heads, as the reference constrains
    its scores."""
    mesh = mesh_of(q, k_flat, v_flat)
    b, sq, h, dh = q.shape
    kv = cfg.n_kv_heads
    kh, vh = (split_dim(t, -1, (kv, dh)) for t in (k_flat, v_flat))
    if cfg.attn_shard_heads:
        kh, vh = (_heads_replicated(t).repeat_interleave(h // kv, dim=2)
                  for t in (kh, vh))
    spec = head_spec(mesh, (b, 1, kh.shape[2], dh), 2)
    return run_local(functools.partial(_attend_heads, cfg),
                     (q, kh, vh, full(mask) if mask is not None else None),
                     (spec, spec, spec, None), (P(spec[0], None, spec[2]),))


def _heads_replicated(t: torch.Tensor) -> torch.Tensor:
    """A [B, S, heads, dh] tensor with its head dimension unsharded."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate, Shard

    pl = [Replicate() if isinstance(q, Shard) and q.dim == 2 else q
          for q in t.placements]
    return t.redistribute(t.device_mesh, pl)


def attention(cfg: ModelConfig, p: Params, x: torch.Tensor,
              q_pos: torch.Tensor, k: torch.Tensor | None = None,
              v: torch.Tensor | None = None,
              window: int | None = None,
              cross: bool = False) -> torch.Tensor:
    """Full (training/prefill) attention.  x: [B, S, D].  If ``k``/``v``
    are given, they are flat [B, Sk, KV*dh] projections already computed
    (:func:`project_kv` of ``x``, or an encoder's cross K/V); otherwise
    self-attention projects them from x.  ``cross=True`` => no mask, no
    RoPE (cross-attention, and the bidirectional encoder).  With
    ``attn_q_chunk`` (and S > chunk, not cross) the queries go in blocks
    ``[i, hi)``, each against the keys ``[k_lo, hi)`` of its causal and
    window horizon."""
    h, dh = cfg.n_heads, cfg.d_head
    q = x @ p["wq"].to(x.dtype)
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
    q = split_dim(q, -1, (h, dh))
    if not cross:
        q = rope(q, q_pos, cfg.rope_theta)
    if k is None:
        k, v = project_kv(cfg, p, x, q_pos, rope_keys=not cross)
    s_q, chunk = q.shape[1], cfg.attn_q_chunk
    if chunk and s_q > chunk and not cross:
        outs = []
        for i in range(0, s_q, chunk):
            hi = min(i + chunk, s_q)
            # the block's first query is i: it needs keys > i - window
            k_lo = 0 if window is None else max(0, i - window + 1)
            mask = _attn_mask(q_pos[i:hi], q_pos[k_lo:hi],
                              window)[None, None, None]
            outs.append(_attend(cfg, q[:, i:hi], k[:, k_lo:hi],
                                v[:, k_lo:hi], mask))
        out = torch.cat(outs, dim=1)
    else:
        mask = None if cross else _attn_mask(q_pos, q_pos,
                                             window)[None, None, None]
        out = _attend(cfg, q, k, v, mask)
    return out @ p["wo"].to(x.dtype)


def project_qkv_decode(cfg: ModelConfig, p: Params, x: torch.Tensor,
                       pos: int):
    """Decode-step projections: q [B,1,H,dh] and flat k/v [B,1,KV*dh],
    RoPE applied at ``pos``."""
    h, dh = cfg.n_heads, cfg.d_head
    posv = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q = x @ p["wq"].to(x.dtype)
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
    q = rope(split_dim(q, -1, (h, dh)), posv, cfg.rope_theta)
    k1, v1 = project_kv(cfg, p, x, posv)
    return q, k1, v1


def attention_decode(cfg: ModelConfig, p: Params, x: torch.Tensor,
                     cache_k: torch.Tensor, cache_v: torch.Tensor,
                     pos: int, window: int | None = None,
                     kpos: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor | None]:
    """One-token decode.  x: [B, 1, D]; cache_[kv]: [B, S, KV*dh] (flat
    layout); pos: the position; kpos: [S] absolute position per rolling
    slot (sliding-window only).  Returns (out, cache_k, cache_v, kpos).

    Unlike the reference, which returns updated copies, this writes the
    new K/V row (and ``kpos``) into the given tensors in place.  The slot
    is clamped into the cache as ``dynamic_update_slice`` clamps it.
    With ``sp_decode`` a full-attention block decodes through
    :func:`repro_torch.dist.sp_decode.sp_flash_decode`."""
    s_max = cache_k.shape[1]
    q, k1, v1 = project_qkv_decode(cfg, p, x, pos)
    if cfg.sp_decode and window is None:
        from repro_torch.dist.sp_decode import sp_flash_decode

        out, cache_k, cache_v = sp_flash_decode(cfg, q, cache_k, cache_v,
                                                k1, v1, pos)
        return out @ p["wo"].to(x.dtype), cache_k, cache_v, kpos
    slot = pos % s_max if window is not None else min(max(pos, 0),
                                                      s_max - 1)
    cache_k[:, slot] = k1[:, 0]
    cache_v[:, slot] = v1[:, 0]
    if window is not None:
        if kpos is None:
            raise ValueError("a sliding-window block needs kpos")
        kpos[slot] = pos
        valid = (kpos <= pos) & (kpos > pos - window)
    else:
        valid = torch.arange(s_max, device=x.device) <= pos
    mask = valid[None, None, None, None, :]
    out = _attend(cfg, q, cache_k, cache_v, mask)
    return out @ p["wo"].to(x.dtype), cache_k, cache_v, kpos


# ------------------------------ MLPs ---------------------------------- #

def mlp_init(cfg: ModelConfig, gen: torch.Generator, device: torch.device,
             lead: tuple[int, ...] = ()) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    p = {
        "w_in": _normal((d, f), s_in, cfg, gen, device, lead),
        "w_out": _normal((f, d), s_out, cfg, gen, device, lead),
    }
    if cfg.mlp in ("silu_glu", "geglu"):
        p["w_gate"] = _normal((d, f), s_in, cfg, gen, device, lead)
    return p


def mlp_specs(cfg: ModelConfig) -> Params:
    p = {"w_in": P("data", "model"), "w_out": P("model", "data")}
    if cfg.mlp in ("silu_glu", "geglu"):
        p["w_gate"] = P("data", "model")
    return p


def mlp(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    h = x @ p["w_in"].to(x.dtype)
    if cfg.mlp == "silu_glu":
        h = F.silu(x @ p["w_gate"].to(x.dtype)) * h
    elif cfg.mlp == "geglu":
        h = F.gelu(x @ p["w_gate"].to(x.dtype), approximate="tanh") * h
    elif cfg.mlp == "gelu":
        h = F.gelu(h, approximate="tanh")
    elif cfg.mlp == "relu2":
        h = torch.square(torch.relu(h))      # squared-ReLU (nemotron)
    else:
        raise ValueError(cfg.mlp)
    return h @ p["w_out"].to(x.dtype)


# ------------------------------ MoE ----------------------------------- #

def moe_init(cfg: ModelConfig, gen: torch.Generator, device: torch.device,
             lead: tuple[int, ...] = ()) -> Params:
    e, d, f = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff_expert
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    return {
        "router": _normal((d, e), s_in, cfg, gen, device, lead,
                          dtype=torch.float32),
        "w_in": _normal((e, d, f), s_in, cfg, gen, device, lead),
        "w_gate": _normal((e, d, f), s_in, cfg, gen, device, lead),
        "w_out": _normal((e, f, d), s_out, cfg, gen, device, lead),
    }


def moe_specs(cfg: ModelConfig) -> Params:
    # experts unsharded (8/16/40 don't divide the 16-way model axis);
    # TP inside each expert's d_ff, FSDP on d_model
    return {
        "router": P(None, None),
        "w_in": P(None, "data", "model"),
        "w_gate": P(None, "data", "model"),
        "w_out": P(None, "model", "data"),
    }


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest values of each row and their indices, as
    ``jax.lax.top_k`` gives them: among equal values the lower index
    first (``torch.topk`` orders ties otherwise)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_dispatch(cfg: ModelConfig, router: torch.Tensor, xf: torch.Tensor,
                 capacity_factor: float):
    """The routing of :func:`moe` for tokens ``xf`` [N, D]: (gates
    [N, K] float32, each assignment's expert ``flat_e`` [N*K], its slot
    in that expert's queue, ``keep`` = slot < cap, cap).  Slots go first
    come, first served: a stable sort by expert id ranks the N*K
    assignments in token order."""
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    n = xf.shape[0]
    logits = xf.float() @ router                               # [N, E]
    gate_vals, gate_idx = top_k(logits, k)                     # [N, K]
    gates = torch.softmax(gate_vals, dim=-1)
    cap = max(min(int(math.ceil(n * k / e * capacity_factor)), n * k), 8)
    flat_e = gate_idx.reshape(-1)                              # [N*K]
    nk = flat_e.shape[0]
    order = torch.argsort(flat_e, stable=True)
    counts = torch.zeros(e, dtype=torch.int64, device=xf.device
                         ).scatter_add_(0, flat_e, torch.ones_like(flat_e))
    offsets = torch.cumsum(counts, 0) - counts
    ranks_sorted = torch.arange(nk, device=xf.device) - offsets[flat_e[order]]
    slot = torch.empty_like(ranks_sorted).scatter_(0, order, ranks_sorted)
    return gates, flat_e, slot, slot < cap, cap


def _replicated_like(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t`` (the same on every rank) as a replicated DTensor on
    ``like``'s mesh when ``like`` is a DTensor; else ``t``."""
    from torch.distributed.tensor import DTensor, Replicate

    if not is_dtensor(like):
        return t
    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def moe(cfg: ModelConfig, p: Params, x: torch.Tensor,
        capacity_factor: float | None = None) -> torch.Tensor:
    """Top-k routing with a fixed expert capacity (GShard-style, token
    dropping), with the reference's static shapes: every expert runs
    over its ``cap`` slots, empty ones zero.  A token whose slot is past
    ``cap`` gets nothing from that expert.

    On a DTensor ``x`` the routing, the dispatch into the buffer and the
    combine run on the whole token axis, the same on every rank (one
    all-gather of ``x`` and one of the experts' output), so ``cap`` and
    the first-come slot order are the whole batch's, as under the
    reference's GSPMD: a shard-local dispatch would drop other tokens.
    The expert products run on the distributed weights; under
    ``moe_dp_sharding`` the buffer is constrained to
    ``P(None, "data", "model")`` first."""
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    if capacity_factor is None:
        capacity_factor = cfg.moe.capacity_factor
    b, s, d = x.shape
    n = b * s
    xf = full(x).reshape(n, d)
    gates, flat_e, slot, keep, cap = moe_dispatch(
        cfg, full(p["router"]), xf, capacity_factor)
    # the kept (expert, slot) pairs are distinct: each row is assigned
    # once, and every dropped assignment lands in one extra row, cut off
    dest = torch.where(keep, flat_e * cap + slot, e * cap)
    buf = xf.new_zeros((e * cap + 1, d))
    buf[dest] = xf.repeat_interleave(k, 0)
    buf = _replicated_like(buf[:-1].view(e, cap, d), x)
    if cfg.moe_dp_sharding:
        buf = constrain(buf, P(None, "data", "model"))
    hin = torch.einsum("ecd,edf->ecf", buf, p["w_in"].to(x.dtype))
    hg = torch.einsum("ecd,edf->ecf", buf, p["w_gate"].to(x.dtype))
    h = F.silu(hg) * hin
    out = full(torch.einsum("ecf,efd->ecd", h, p["w_out"].to(x.dtype)))
    tok_out = out[flat_e, torch.where(keep, slot, 0)]          # [N*K, D]
    tok_out = torch.where(keep[:, None], tok_out, 0)
    tok_out = tok_out.reshape(n, k, d) * gates[..., None].to(x.dtype)
    y = tok_out.sum(dim=1).reshape(b, s, d)
    if not is_dtensor(x):
        return y
    # back to x's sharding (its pieces of the whole result: no collective)
    from torch.distributed.tensor import Replicate

    pl = [Replicate() if q.is_partial() else q for q in x.placements]
    return _replicated_like(y, x).redistribute(x.device_mesh, pl)


# --------------------------- embeddings -------------------------------- #

def embed_init(cfg: ModelConfig, gen: torch.Generator,
               device: torch.device) -> Params:
    vp = padded_vocab(cfg)
    p = {"tok": _normal((vp, cfg.d_model), 0.02, cfg, gen, device)}
    if not cfg.tie_embeddings:
        p["head"] = _normal((cfg.d_model, vp), 1.0 / math.sqrt(cfg.d_model),
                            cfg, gen, device)
    return p


def embed_specs(cfg: ModelConfig) -> Params:
    p = {"tok": P("model", "data")}
    if not cfg.tie_embeddings:
        p["head"] = P("data", "model")
    return p


def _lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens.long()]


def embed(cfg: ModelConfig, p: Params, tokens: torch.Tensor
          ) -> torch.Tensor:
    """The token embeddings.  On a mesh each rank looks up its own
    sequences in the whole table (gathered), its gradient summed over
    the batch's ranks."""
    table = p["tok"].to(cdtype(cfg))
    mesh = mesh_of(table, tokens)
    if mesh is None:
        x = _lookup(table, tokens)
    else:
        dp = batch_spec(mesh, tuple(tokens.shape))[0]
        x = run_local(_lookup, (table, tokens), (P(None, None), P(dp, None)),
                      (P(dp, None, None),))
    if cfg.tie_embeddings:
        x = x * weak_scalar(x, math.sqrt(cfg.d_model))   # gemma-style
    return x


def _head_product(x: torch.Tensor, w: torch.Tensor, tied: bool
                  ) -> torch.Tensor:
    if tied:
        return torch.einsum("bsd,vd->bsv", x, w)
    return torch.einsum("bsd,dv->bsv", x, w)


def lm_head(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """Logits [B, S, V_pad] float32.  On a mesh the product is
    column-parallel: each rank its sequences against its "model" slice of
    the vocab (DTensor's einsum would gather the whole vocab onto every
    rank and repeat the product there)."""
    tied = cfg.tie_embeddings
    w = (p["tok"] if tied else p["head"]).to(x.dtype)
    mesh = mesh_of(x, w)
    if mesh is None:
        logits = _head_product(x, w, tied)
    else:
        vdim = 0 if tied else 1
        wspec = fit(known_axes(P("model", None) if tied
                               else P(None, "model"), mesh),
                    tuple(w.shape), mesh)
        dp = batch_spec(mesh, tuple(x.shape))[0]
        logits = run_local(
            functools.partial(_head_product, tied=tied), (x, w),
            (P(dp, None, None), wspec), (P(dp, None, wspec[vdim]),))
    logits = _softcap(logits.float(), cfg.logit_softcap)
    # mask the vocab-padding logits (Megatron-style padded vocab)
    vp = logits.shape[-1]
    if vp != cfg.vocab:
        pad = torch.arange(vp, device=x.device) >= cfg.vocab
        logits = torch.where(pad, NEG_INF, logits)
    return logits
