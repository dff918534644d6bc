"""A Jamba decoder language model in plain PyTorch, float32: the full
forward over a whole sequence, with no cache, no batching and no
kernel.

The model (the configuration's ``model`` object, the equations of
``transformers``' ``JambaForCausalLM``): ``num_layers`` blocks in
periods of ``block_pattern``, each a pre-norm mixer (Mamba-1 or
attention) and a pre-norm FFN (a sparse MoE on the period indices
``moe.moe_layers``, else a dense MLP), each with its residual; then a
final norm and an untied output head.

* norm: ``x / sqrt(mean(x^2) + norm_eps) * (1 + scale)``;
* Mamba-1 mixer (``d_inner = ssm_expand * d_model``, ``N =
  ssm_d_state``, ``dt_rank = d_model / 16``): ``x, z = split(a W_in)``;
  a causal depthwise convolution of ``ssm_d_conv`` taps with its bias,
  then SiLU; ``dt, B, C = split(x W_x)``, each RMS-normalised by its own
  norm (Jamba's ``dt_layernorm``, ``b_layernorm``, ``c_layernorm``);
  ``delta = softplus(dt W_dt + b_dt)``, ``A = -exp(A_log)``; the
  selective scan, one time step after another:
  ``h_t = exp(delta_t A) h_{t-1} + delta_t x_t B_t``,
  ``y_t = h_t . C_t + D x_t``; then ``(y * silu(z)) W_out``;
* attention: ``n_heads`` query heads of ``d_head``, ``n_kv_heads`` key
  and value heads (query head ``h`` reads head ``h // (n_heads /
  n_kv_heads)``), no positional encoding (Jamba has none: positions
  enter through the causal mask alone), scores over ``sqrt(d_head)``,
  causal softmax;
* MoE: ``p = softmax(x W_router)`` over all ``num_experts``; each token
  goes to the ``top_k`` largest (the lower index first on a tie) with
  those probabilities as weights, not renormalised; each expert runs
  ``(silu(x W_gate) * (x W_in)) W_out`` over the tokens routed to it,
  none dropped;
* dense MLP: ``(silu(x W_gate) * (x W_in)) W_out``;
* logits: the first ``vocab`` columns of ``x W_head``.

Departures from the published model: the norms scale by ``1 + scale``
(the port's convention; Jamba's ``JambaRMSNorm`` by ``scale``): drawn
as zeros, every norm has the gain 1 that Jamba's start with (their
weights at ones); ``dt_rank`` is ``d_model / 16``, as the published 256
is at ``d_model`` 4,096.

The weights are read by name from a flat dict, as :func:`layout` lays
them out, under the port's parameter names: the embedding and head rows
are the vocabulary padded to a multiple of 128; a block's weights carry
a leading axis of periods; a projection is ``[in, out]``; an expert's
``[experts, in, out]``.  Anything the model states that this file does
not compute raises.  It imports nothing of the program.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

VOCAB_ALIGN = 128
#: weights read a row at a time (a lookup, no product)
LOOKUP = ("embed.tok",)
#: weights applied only to the positions whose logits are asked for
LAST_ONLY = ("embed.head",)
#: the model's options this file computes only in their "off" setting
OFF = ("window", "attn_softcap", "logit_softcap", "qkv_bias",
       "tie_embeddings", "frontend", "enc_dec", "rope_theta")
#: time steps whose ``exp(delta A)`` and ``delta x B`` are made at once
SCAN_CHUNK = 256
#: the scales drawn for the weights no fan-in sets (``layout``); a norm's
#: scale is drawn as zeros, the gain 1 of Jamba's initial norms
CONV_BIAS_STD, DT_BIAS_STD, A_LOG_STD, D_STD, NORM_STD = 0.1, 1.0, 1.0, 1.0, 0.0


def _check(model: dict) -> None:
    kinds = set(model["block_pattern"])
    if not kinds <= {"attn", "mamba"}:
        raise ValueError(f"blocks {sorted(kinds)}: attention and mamba only")
    if model["mlp"] != "silu_glu":
        raise ValueError(f"MLP {model['mlp']!r} is not computed here")
    moe = model.get("moe")
    if not moe or moe.get("capacity_factor", 1.25) is not None \
            or moe.get("renormalize", True):
        raise ValueError("the MoE computed here routes every token (no "
                         "capacity) by the top_k of a softmax over every "
                         "expert, not renormalised")
    if "mamba" in kinds and not model.get("ssm_dt_bc_norm"):
        raise ValueError("the mamba mixer computed here norms dt, B and C")
    on = [k for k in OFF if model.get(k)]
    if on:
        raise ValueError(f"not computed here: {on}")


def padded_vocab(model: dict) -> int:
    return -(-model["vocab"] // VOCAB_ALIGN) * VOCAB_ALIGN


def _periods(model: dict) -> int:
    n, pat = model["num_layers"], len(model["block_pattern"])
    if n % pat:
        raise ValueError(f"{n} layers are not whole periods of {pat}")
    return n // pat


def layout(model: dict) -> dict:
    """Every weight by name: ``(shape, std)``, with ``std`` that of its
    normal draws (1 / sqrt(fan-in), the embedding 0.02, the scales
    above for the convolution's and dt's biases, ``A_log`` and ``D``,
    0 for a norm's scale: zeros, a gain of 1)."""
    _check(model)
    d, h, kv, dh = (model["d_model"], model["n_heads"], model["n_kv_heads"],
                    model["d_head"])
    f, p, vp = model["d_ff"], _periods(model), padded_vocab(model)
    moe = model["moe"]
    e, fe = moe["num_experts"], moe["d_ff_expert"]
    din, n = model["ssm_expand"] * d, model["ssm_d_state"]
    dtr, dconv = max(d // 16, 1), model["ssm_d_conv"]
    out = {
        "embed.tok": ((vp, d), 0.02),
        "embed.head": ((d, vp), 1 / math.sqrt(d)),
        "final_norm.scale": ((d,), NORM_STD),
    }
    for j, kind in enumerate(model["block_pattern"]):
        blk = f"periods.block{j}."
        out[blk + "norm1.scale"] = ((p, d), NORM_STD)
        out[blk + "norm2.scale"] = ((p, d), NORM_STD)
        if kind == "attn":
            out.update({
                blk + "attn.wq": ((p, d, h * dh), 1 / math.sqrt(d)),
                blk + "attn.wk": ((p, d, kv * dh), 1 / math.sqrt(d)),
                blk + "attn.wv": ((p, d, kv * dh), 1 / math.sqrt(d)),
                blk + "attn.wo": ((p, h * dh, d), 1 / math.sqrt(h * dh)),
            })
        else:
            m = blk + "mamba."
            out.update({
                m + "in_proj": ((p, d, 2 * din), 1 / math.sqrt(d)),
                m + "conv_w": ((p, dconv, din), 1 / math.sqrt(dconv)),
                m + "conv_b": ((p, din), CONV_BIAS_STD),
                m + "x_proj": ((p, din, dtr + 2 * n), 1 / math.sqrt(din)),
                m + "dt_norm": ((p, dtr), NORM_STD),
                m + "b_norm": ((p, n), NORM_STD),
                m + "c_norm": ((p, n), NORM_STD),
                m + "dt_proj": ((p, dtr, din), 1 / math.sqrt(dtr)),
                m + "dt_bias": ((p, din), DT_BIAS_STD),
                m + "A_log": ((p, din, n), A_LOG_STD),
                m + "D": ((p, din), D_STD),
                m + "out_proj": ((p, din, d), 1 / math.sqrt(din)),
            })
        if j in moe["moe_layers"]:
            out.update({
                blk + "moe.router": ((p, d, e), 1 / math.sqrt(d)),
                blk + "moe.w_in": ((p, e, d, fe), 1 / math.sqrt(d)),
                blk + "moe.w_gate": ((p, e, d, fe), 1 / math.sqrt(d)),
                blk + "moe.w_out": ((p, e, fe, d), 1 / math.sqrt(fe)),
            })
        else:
            out.update({
                blk + "mlp.w_in": ((p, d, f), 1 / math.sqrt(d)),
                blk + "mlp.w_gate": ((p, d, f), 1 / math.sqrt(d)),
                blk + "mlp.w_out": ((p, f, d), 1 / math.sqrt(f)),
            })
    return out


@contextlib.contextmanager
def _no_tf32():
    """float32 products in float32, not TF32, for the body of the with."""
    was = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = was


def _norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) \
        * (1.0 + scale)


def scan(delta: torch.Tensor, a: torch.Tensor, x: torch.Tensor,
         b: torch.Tensor, c: torch.Tensor,
         h: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The selective scan, one time step after another: ``delta``, ``x``
    [S, din], ``a`` [din, N], ``b``, ``c`` [S, N], from the state ``h``
    [din, N] (zeros if None).  Returns (``h_t . C_t`` [S, din], the
    final state); ``exp(delta A)`` and ``delta x B`` are made
    ``SCAN_CHUNK`` steps at a time."""
    s, din = delta.shape
    h = delta.new_zeros((din, a.shape[1])) if h is None else h.clone()
    ys = delta.new_empty((s, din))
    for t0 in range(0, s, SCAN_CHUNK):
        t1 = min(t0 + SCAN_CHUNK, s)
        dl = delta[t0:t1]
        da = torch.exp(dl[:, :, None] * a)
        dbx = (dl * x[t0:t1])[:, :, None] * b[t0:t1, None, :]
        for t in range(t1 - t0):
            h = torch.addcmul(dbx[t], da[t], h)
            torch.mv(h, c[t0 + t], out=ys[t0 + t])
    return ys, h


def _mamba(model: dict, w, a: torch.Tensor) -> torch.Tensor:
    s, eps = a.shape[0], model["norm_eps"]
    n, dconv = model["ssm_d_state"], model["ssm_d_conv"]
    xi, z = (a @ w("mamba.in_proj")).chunk(2, dim=-1)           # [S, din]
    xpad = F.pad(xi, (0, 0, dconv - 1, 0))
    cw = w("mamba.conv_w")
    xc = sum(xpad[k:k + s] * cw[k] for k in range(dconv))
    xc = F.silu(xc + w("mamba.conv_b"))
    proj = xc @ w("mamba.x_proj")
    dt, b, c = torch.split(proj, [proj.shape[-1] - 2 * n, n, n], dim=-1)
    dt = _norm(dt, w("mamba.dt_norm"), eps)
    b = _norm(b, w("mamba.b_norm"), eps)
    c = _norm(c, w("mamba.c_norm"), eps)
    delta = F.softplus(dt @ w("mamba.dt_proj") + w("mamba.dt_bias"))
    y, _ = scan(delta, -torch.exp(w("mamba.A_log")), xc, b, c)
    y = (y + xc * w("mamba.D")) * F.silu(z)
    return y @ w("mamba.out_proj")


def _attention(model: dict, w, a: torch.Tensor) -> torch.Tensor:
    """Causal GQA attention with no positional encoding, one KV head
    (and its query heads) at a time."""
    h, kv, dh = model["n_heads"], model["n_kv_heads"], model["d_head"]
    s, g = a.shape[0], h // kv
    q = (a @ w("attn.wq")).view(s, kv, g, dh)
    k = (a @ w("attn.wk")).view(s, kv, dh)
    v = (a @ w("attn.wv")).view(s, kv, dh)
    causal = torch.ones(s, s, dtype=torch.bool, device=a.device).tril()
    att = torch.empty(s, kv, g, dh, dtype=a.dtype, device=a.device)
    for j in range(kv):
        scores = torch.einsum("sgd,td->gst", q[:, j], k[:, j]) / math.sqrt(dh)
        p = torch.softmax(scores.masked_fill_(~causal, -math.inf), -1)
        del scores
        att[:, j] = torch.einsum("gst,td->sgd", p, v[:, j])
        del p
    return att.reshape(s, h * dh) @ w("attn.wo")


def _moe(model: dict, weights: dict, blk: str, i: int, cast,
         m: torch.Tensor) -> torch.Tensor:
    """Top-k of the softmax over every expert, not renormalised; each
    expert over the tokens routed to it (its weights cast one expert at
    a time)."""
    moe = model["moe"]
    probs = torch.softmax(m @ cast(weights[blk + "moe.router"][i]), -1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = vals[:, :moe["top_k"]], idx[:, :moe["top_k"]]
    out = torch.zeros_like(m)
    for e in range(moe["num_experts"]):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        def we(name, e=e):
            return cast(weights[blk + name][i, e])
        xe = m[tok]
        he = F.silu(xe @ we("moe.w_gate")) * (xe @ we("moe.w_in"))
        out.index_add_(0, tok, (he @ we("moe.w_out"))
                       * gates[tok, slot, None])
    return out


def logits(weights: dict, model: dict, tokens: torch.Tensor,
           start: int = 0, cast=None) -> torch.Tensor:
    """Float32 logits ``[S - start, vocab]`` of positions ``start`` to
    ``S - 1`` of the sequence ``tokens`` ``[S]`` (the logits at position
    ``p`` score the token at ``p + 1``).  ``cast`` takes each weight (a
    block's one layer at a time, an expert's one expert at a time) to
    the float32 it is computed in: ``.float()`` unless given."""
    _check(model)
    cast = cast or (lambda t: t.float())
    eps, moe_layers = model["norm_eps"], model["moe"]["moe_layers"]
    with _no_tf32():
        x = cast(weights["embed.tok"])[tokens.long()]
        for i in range(_periods(model)):
            for j, kind in enumerate(model["block_pattern"]):
                blk = f"periods.block{j}."

                def w(name, blk=blk, i=i):
                    return cast(weights[blk + name][i])
                a = _norm(x, w("norm1.scale"), eps)
                x = x + (_attention(model, w, a) if kind == "attn"
                         else _mamba(model, w, a))
                m = _norm(x, w("norm2.scale"), eps)
                if j in moe_layers:
                    x = x + _moe(model, weights, blk, i, cast, m)
                else:
                    x = x + (F.silu(m @ w("mlp.w_gate")) * (m @ w("mlp.w_in"))
                             ) @ w("mlp.w_out")
        x = _norm(x[start:], cast(weights["final_norm.scale"]), eps)
        return x @ cast(weights["embed.head"])[:, :model["vocab"]]
