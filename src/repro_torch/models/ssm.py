"""State-space / linear-attention blocks: RWKV-6 ("Finch") and Mamba.

Counterpart of the reference package's ``models/ssm.py``: the same
parameter trees, dtypes and recurrences.  The reference's ``lax.scan``
over time steps is a Python loop over them here, one step at a time in
float32, as the scan carries its state.

RWKV-6 time-mix (per head, d = head dim):
    state_t = diag(w_t) state_{t-1} + k_t^T v_t          [d, d]
    y_t     = r_t (diag(u) k_t^T v_t + state_{t-1})
with data-dependent decay w_t = exp(-exp(lora_w(x_t))).

Mamba (S6): h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t;  y = C_t h + D x.
"""

from __future__ import annotations

import functools
import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

from repro_torch.dist.sharding import (
    DP_AXES,
    P,
    constrain,
    head_spec,
    merge_dims,
    mesh_of,
    run_local,
    split_dim,
)

from .layers import _normal, pdtype
from .loops import repeat

Params = dict[str, Any]


def _full(lead: tuple[int, ...], shape, value: float, dtype: torch.dtype,
          device: torch.device) -> torch.Tensor:
    return torch.full(lead + tuple(shape), value, dtype=dtype, device=device)


# ------------------------------- RWKV-6 -------------------------------- #

def rwkv_init(cfg: ModelConfig, gen: torch.Generator, device: torch.device,
              lead: tuple[int, ...] = ()) -> Params:
    d, hd = cfg.d_model, cfg.rwkv_head_dim
    h = d // hd
    s = 1.0 / math.sqrt(d)
    lora = 64
    dt = pdtype(cfg)
    p = {"mu": _full(lead, (5, d), 0.5, dt, device)}  # r, k, v, w, g shifts
    for name in ("w_r", "w_k", "w_v", "w_g", "w_o"):
        p[name] = _normal((d, d), s, cfg, gen, device, lead)
    # data-dependent decay LoRA (the Finch mechanism)
    p["w_dec_a"] = _normal((d, lora), s, cfg, gen, device, lead)
    p["w_dec_b"] = _normal((lora, d), 1.0 / math.sqrt(lora), cfg, gen,
                           device, lead)
    p["dec_bias"] = _full(lead, (d,), -4.0, dt, device)
    p["u"] = _normal((h, hd), 0.1, cfg, gen, device, lead)
    p["ln_x"] = _full(lead, (d,), 1.0, dt, device)
    return p


def rwkv_specs(cfg: ModelConfig) -> Params:
    return {
        "mu": P(None, None),
        "w_r": P("data", "model"),
        "w_k": P("data", "model"),
        "w_v": P("data", "model"),
        "w_g": P("data", "model"),
        "w_o": P("model", "data"),
        "w_dec_a": P("data", None),
        "w_dec_b": P(None, "model"),
        "dec_bias": P("model"),
        "u": P(None, None),   # 40 heads never divide the 16-way axis
        "ln_x": P(None),
    }


def _rwkv_rkvwg(cfg: ModelConfig, p: Params, x: torch.Tensor,
                x_prev: torch.Tensor):
    """Project token-shifted inputs to r,k,v,w,g.  x: [B, S, D];
    x_prev: [B, S, D] (x shifted right by one)."""
    mu = p["mu"].to(x.dtype)

    def mix(i):
        return x * mu[i] + x_prev * (1.0 - mu[i])

    r = mix(0) @ p["w_r"].to(x.dtype)
    k = mix(1) @ p["w_k"].to(x.dtype)
    v = mix(2) @ p["w_v"].to(x.dtype)
    dec = torch.tanh(mix(3) @ p["w_dec_a"].to(x.dtype)) \
        @ p["w_dec_b"].to(x.dtype) + p["dec_bias"].to(x.dtype)
    w = torch.exp(-torch.exp(dec.float()))                     # (0, 1)
    g = F.silu(mix(4) @ p["w_g"].to(x.dtype))
    return r, k, v, w, g


def _heads(x: torch.Tensor, hd: int) -> torch.Tensor:
    return split_dim(x, -1, (x.shape[-1] // hd, hd))


def rwkv_time_mix(cfg: ModelConfig, p: Params, x: torch.Tensor,
                  state: torch.Tensor | None = None,
                  x_last: torch.Tensor | None = None):
    """x: [B, S, D].  state: [B, H, hd, hd] float32 recurrent state
    (decode), x_last: [B, D] previous token (token shift across calls).
    Returns (y, new_state, new_x_last); the inputs are not written."""
    b, s, d = x.shape
    hd = cfg.rwkv_head_dim
    h = d // hd
    if x_last is None:
        x_last = x.new_zeros((b, d))
    x_prev = torch.cat([x_last[:, None], x[:, :-1]], dim=1)
    r, k, v, w, g = _rwkv_rkvwg(cfg, p, x, x_prev)
    rh, kh, vh = _heads(r, hd), _heads(k, hd), _heads(v, hd)
    wh = _heads(w.float(), hd)
    u = p["u"].float()
    mesh = mesh_of(rh, kh, vh, wh, u, state)
    if mesh is None:
        yh, state = _rwkv_scan(rh, kh, vh, wh, u, state, cfg.rwkv_chunk)
    else:
        # each rank its sequences' heads: batch over "data", heads over
        # "model" where they divide
        spec = head_spec(mesh, (b, s, h, hd), 2)
        st_spec = P(spec[0], spec[2], None, None)
        yh, state = run_local(
            functools.partial(_rwkv_scan, chunk=cfg.rwkv_chunk),
            (rh, kh, vh, wh, u, state),
            (spec,) * 4 + (P(spec[2], None), st_spec), (spec, st_spec))
    y = merge_dims(yh, (b, s, d)).to(x.dtype)
    # group-norm per head (ln_x), then output gate + projection
    y32 = split_dim(y.float(), -1, (h, hd))
    y32 = y32 * torch.rsqrt((y32 * y32).mean(-1, keepdim=True) + 1e-5)
    y = (merge_dims(y32, (b, s, d)) * p["ln_x"].float()).to(x.dtype)
    y = (y * g) @ p["w_o"].to(x.dtype)
    return y, state, x[:, -1]


def _rwkv_scan(rh, kh, vh, wh, u, state, chunk: int | None):
    """The time-mix recurrence over [B, S, H, hd] heads: (y [B, S, H, hd]
    float32, final state [B, H, hd, hd]) from ``state`` (zeros if None),
    in the chunk-parallel form when ``chunk`` divides S, no state is
    carried and S > chunk, else one time step after another."""
    b, s, h, hd = rh.shape
    if chunk and s % chunk == 0 and state is None and s > chunk:
        # chunk-parallel GLA form: matmul-dominant, same math
        return _rwkv_chunked(rh, kh, vh, wh, u, chunk)
    st = rh.new_zeros((b, h, hd, hd), dtype=torch.float32) \
        if state is None else state
    rf, kf, vf = rh.float(), kh.float(), vh.float()
    uk = u[None, :, :, None]

    def step(t):
        nonlocal st
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]   # [B,H,hd,hd]
        y = torch.einsum("bhk,bhkv->bhv", rf[:, t], uk * kv + st)
        st = wh[:, t, :, :, None] * st + kv
        return y

    ys = repeat(s, step)
    return torch.stack(ys, dim=1), st


def rwkv_ffn_init(cfg: ModelConfig, gen: torch.Generator,
                  device: torch.device, lead: tuple[int, ...] = ()
                  ) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mu": _full(lead, (2, d), 0.5, pdtype(cfg), device),
        "w_k": _normal((d, f), 1.0 / math.sqrt(d), cfg, gen, device, lead),
        "w_v": _normal((f, d), 1.0 / math.sqrt(f), cfg, gen, device, lead),
        "w_r": _normal((d, d), 1.0 / math.sqrt(d), cfg, gen, device, lead),
    }


def rwkv_ffn_specs(cfg: ModelConfig) -> Params:
    return {"mu": P(None, None), "w_k": P("data", "model"),
            "w_v": P("model", "data"), "w_r": P("data", "model")}


def rwkv_channel_mix(cfg: ModelConfig, p: Params, x: torch.Tensor,
                     x_last: torch.Tensor | None = None):
    """x: [B, S, D]; x_last: [B, D] previous token.  Returns (y,
    new_x_last)."""
    b, s, d = x.shape
    if x_last is None:
        x_last = x.new_zeros((b, d))
    x_prev = torch.cat([x_last[:, None], x[:, :-1]], dim=1)
    mu = p["mu"].to(x.dtype)
    xk = x * mu[0] + x_prev * (1.0 - mu[0])
    xr = x * mu[1] + x_prev * (1.0 - mu[1])
    k = torch.square(torch.relu(xk @ p["w_k"].to(x.dtype)))
    kv = k @ p["w_v"].to(x.dtype)
    r = torch.sigmoid(xr @ p["w_r"].to(x.dtype))
    return r * kv, x[:, -1]


# -------------------------------- Mamba -------------------------------- #

def mamba_init(cfg: ModelConfig, gen: torch.Generator, device: torch.device,
               lead: tuple[int, ...] = ()) -> Params:
    d, din, n = cfg.d_model, cfg.d_inner_ssm, cfg.ssm_d_state
    dtr = max(d // 16, 1)
    dt = pdtype(cfg)
    a_log = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                   device=device))
    return {
        "in_proj": _normal((d, 2 * din), 1.0 / math.sqrt(d), cfg, gen,
                           device, lead),
        "conv_w": _normal((cfg.ssm_d_conv, din), 0.3, cfg, gen, device,
                          lead),
        "conv_b": _full(lead, (din,), 0.0, dt, device),
        "x_proj": _normal((din, dtr + 2 * n), 1.0 / math.sqrt(din), cfg, gen,
                          device, lead),
        "dt_proj": _normal((dtr, din), 1.0 / math.sqrt(dtr), cfg, gen,
                           device, lead),
        "dt_bias": _full(lead, (din,), -4.6, dt, device),  # softplus^-1(0.01)
        "A_log": a_log.expand(lead + (din, n)).clone(),
        "D": _full(lead, (din,), 1.0, torch.float32, device),
        "out_proj": _normal((din, d), 1.0 / math.sqrt(din), cfg, gen,
                            device, lead),
    }


def mamba_specs(cfg: ModelConfig) -> Params:
    return {
        "in_proj": P("data", "model"),
        "conv_w": P(None, "model"),
        "conv_b": P("model"),
        "x_proj": P("model", None),
        "dt_proj": P(None, "model"),
        "dt_bias": P("model"),
        "A_log": P("model", None),
        "D": P("model"),
        "out_proj": P("model", "data"),
    }


def mamba_block(cfg: ModelConfig, p: Params, x: torch.Tensor,
                ssm_state: torch.Tensor | None = None,
                conv_state: torch.Tensor | None = None):
    """x: [B, S, D].  For decode, pass the states ([B, din, N] float32
    and [B, dconv-1, din]) and S == 1.  Returns (y, ssm_state,
    conv_state); the inputs are not written."""
    b, s, d = x.shape
    din, n, dconv = cfg.d_inner_ssm, cfg.ssm_d_state, cfg.ssm_d_conv
    xz = x @ p["in_proj"].to(x.dtype)
    xi, z = xz.chunk(2, dim=-1)                        # [B, S, din]
    # depthwise causal conv over time
    if conv_state is None:
        conv_state = x.new_zeros((b, dconv - 1, din))
    xpad = torch.cat([conv_state, xi], dim=1)
    new_conv_state = xpad[:, -(dconv - 1):]
    cw = p["conv_w"].to(x.dtype)
    xc = sum(xpad[:, i:i + s] * cw[i] for i in range(dconv))
    xc = F.silu(xc + p["conv_b"].to(x.dtype))
    # input-dependent SSM params
    # row-parallel on a mesh: the small projection is summed whole
    proj = constrain(xc @ p["x_proj"].to(x.dtype), P(DP_AXES, None, None))
    dtr = proj.shape[-1] - 2 * n
    dt, bmat, cmat = torch.split(proj, [dtr, n, n], dim=-1)
    dt = F.softplus(dt @ p["dt_proj"].to(x.dtype)
                    + p["dt_bias"].to(x.dtype)).float()
    a = -torch.exp(p["A_log"])                         # [din, N]
    da = torch.exp(dt[..., None] * a)                  # [B, S, din, N]
    dbx = (dt * xc.float())[..., None] * bmat.float()[:, :, None, :]
    cf = cmat.float()
    mesh = mesh_of(da, dbx, cf, ssm_state)
    if mesh is None:
        y, h = _mamba_scan(da, dbx, cf, ssm_state)
    else:
        # each rank its sequences' channels: batch over "data", d_inner
        # over "model" where it divides
        spec = head_spec(mesh, (b, s, din, n), 2)
        h_spec = P(spec[0], spec[2], None)
        y, h = run_local(_mamba_scan, (da, dbx, cf, ssm_state),
                         (spec, spec, P(spec[0], None, None), h_spec),
                         (P(spec[0], None, spec[2]), h_spec))
    y = y.to(x.dtype)                                  # [B, S, din]
    y = y + xc * p["D"].to(x.dtype)
    y = y * F.silu(z)
    return y @ p["out_proj"].to(x.dtype), h, new_conv_state


def _mamba_scan(da, dbx, cf, h):
    """The selective scan: h_t = da_t * h_{t-1} + dbx_t, y_t = h_t . C_t,
    over da/dbx [B, S, din, N] and C [B, S, N] float32 from ``h`` (zeros
    if None).  Returns (y [B, S, din] float32, final h [B, din, N])."""
    b, s, din, n = da.shape
    if h is None:
        h = da.new_zeros((b, din, n))

    def step(t):
        nonlocal h
        h = da[:, t] * h + dbx[:, t]                   # [B, din, N]
        return torch.einsum("bdn,bn->bd", h, cf[:, t])

    return torch.stack(repeat(s, step), dim=1), h


# ------------------- chunked-parallel RWKV-6 (GLA form) ------------------- #

def _rwkv_chunked(rh, kh, vh, wh, u, chunk: int):
    """Chunk-parallel evaluation of the RWKV-6 recurrence (GLA-style).

    rh/kh/vh: [B, S, H, hd];  wh: [B, S, H, hd] decays in (0,1), f32;
    u: [H, hd].  Returns (y [B, S, H, hd] f32, final state [B, H, hd, hd]).

    Per head, with P_i = prod_{t<i} w_t inside a chunk:
        y_i = r_i (S_before_i + u (.) k_i^T v_i)
        S_before_i = P_i (.) S_chunk_start + sum_{j<i} (P_i / P_{j+1}) k_j^T v_j
    split into an intra-chunk matmul, the diagonal bonus term and an
    inter-chunk pass whose only sequential part is the per-chunk state
    update.  Decay products accumulate in log space, each step's decay
    clamped to exp(-8) so exp(-cum) stays in f32 range over a chunk.
    """
    b, s, h, hd = rh.shape
    nc = s // chunk
    shp = (b, nc, chunk, h, hd)
    r = rh.reshape(shp).float()
    k = kh.reshape(shp).float()
    v = vh.reshape(shp).float()
    w = torch.clamp(wh.reshape(shp).float(), math.exp(-8.0), 1.0)
    logw = torch.log(w)
    cum_inc = torch.cumsum(logw, dim=2)                # log P_{j+1}
    cum_exc = cum_inc - logw                           # log P_i
    cum_all = cum_inc[:, :, -1:]                       # log of full-chunk decay
    r_dec = r * torch.exp(cum_exc)                     # r (.) P
    k_inv = k * torch.exp(-cum_inc)                    # k (.) 1/P_{+1}
    k_end = k * torch.exp(cum_all - cum_inc)           # k (.) P_end/P_{+1}

    # intra-chunk attention (strictly causal within the chunk)
    att = torch.einsum("bnlhd,bnmhd->bnhlm", r_dec, k_inv)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=rh.device), diagonal=-1)
    att = torch.where(mask[None, None, None], att, 0.0)
    y_intra = torch.einsum("bnhlm,bnmhd->bnlhd", att, v)
    # diagonal (current-token bonus) term
    c = torch.einsum("bnlhd,hd,bnlhd->bnlh", r, u.float(), k)
    y_diag = c[..., None] * v
    # chunk summaries for the sequential state pass
    contrib = torch.einsum("bnlhd,bnlhv->bnhdv", k_end, v)
    decay = torch.exp(cum_all[:, :, 0])                # [B, NC, H, hd]
    st = r.new_zeros((b, h, hd, hd))
    befores = []
    for i in range(nc):
        befores.append(st)
        st = decay[:, i, ..., None] * st + contrib[:, i]
    befores = torch.stack(befores, dim=1)              # [B, NC, H, hd, hd]
    y_inter = torch.einsum("bnlhd,bnhdv->bnlhv", r_dec, befores)
    y = (y_intra + y_diag + y_inter).reshape(b, s, h, hd)
    return y, st
