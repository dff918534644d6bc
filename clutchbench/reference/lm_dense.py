"""A dense decoder language model in plain PyTorch, float32: the full
forward over a whole sequence, with no cache, no batching and no
kernel.

The model (the configuration's ``model`` object): ``num_layers`` blocks
of pre-norm attention and MLP, each with its residual, then a final
norm and an untied output head.

* norm: ``x / sqrt(mean(x^2) + norm_eps) * (1 + scale)``;
* attention: ``n_heads`` query heads of ``d_head``, ``n_kv_heads`` key
  and value heads (query head ``h`` reads head ``h // (n_heads /
  n_kv_heads)``), rotary positions on queries and keys (the halves of a
  head rotated against each other, frequencies ``rope_theta ** (-i /
  half)``), scores over ``sqrt(d_head)``, causal softmax;
* MLP: ``relu(x W_in)^2 W_out`` (``mlp`` ``"relu2"``, squared ReLU);
* logits: the first ``vocab`` columns of ``x W_head``.

The weights are read by name from a flat dict, as :func:`layout` lays
them out: the embedding and head rows are the vocabulary padded to a
multiple of 128; a block's weights carry a leading axis of
``num_layers``; a projection is ``[in, out]``.  Anything the model
states that this file does not compute raises.  It imports nothing of
the program.
"""

from __future__ import annotations

import contextlib
import math

import torch

VOCAB_ALIGN = 128
#: weights read a row at a time (a lookup, no product)
LOOKUP = ("embed.tok",)
#: weights applied only to the positions whose logits are asked for
LAST_ONLY = ("embed.head",)
#: the model's options this file computes only in their "off" setting
OFF = ("window", "attn_softcap", "logit_softcap", "qkv_bias",
       "tie_embeddings", "moe", "frontend", "enc_dec")


def _check(model: dict) -> None:
    if tuple(model["block_pattern"]) != ("attn",):
        raise ValueError(f"a dense decoder has attention blocks only, not "
                         f"{model['block_pattern']}")
    if model["mlp"] != "relu2":
        raise ValueError(f"MLP {model['mlp']!r} is not computed here")
    on = [k for k in OFF if model.get(k)]
    if on:
        raise ValueError(f"not computed here: {on}")


def padded_vocab(model: dict) -> int:
    return -(-model["vocab"] // VOCAB_ALIGN) * VOCAB_ALIGN


def layout(model: dict) -> dict:
    """Every weight by name: ``(shape, std)``, with ``std`` that of its
    normal draws (1 / sqrt(fan-in), the embedding 0.02), ``None`` for a
    norm's scale, which starts at ones."""
    _check(model)
    d, h, kv, dh = (model["d_model"], model["n_heads"], model["n_kv_heads"],
                    model["d_head"])
    f, n, vp = model["d_ff"], model["num_layers"], padded_vocab(model)
    return {
        "embed.tok": ((vp, d), 0.02),
        "embed.head": ((d, vp), 1 / math.sqrt(d)),
        "final_norm.scale": ((d,), None),
        "periods.block0.norm1.scale": ((n, d), None),
        "periods.block0.attn.wq": ((n, d, h * dh), 1 / math.sqrt(d)),
        "periods.block0.attn.wk": ((n, d, kv * dh), 1 / math.sqrt(d)),
        "periods.block0.attn.wv": ((n, d, kv * dh), 1 / math.sqrt(d)),
        "periods.block0.attn.wo": ((n, h * dh, d), 1 / math.sqrt(h * dh)),
        "periods.block0.norm2.scale": ((n, d), None),
        "periods.block0.mlp.w_in": ((n, d, f), 1 / math.sqrt(d)),
        "periods.block0.mlp.w_out": ((n, f, d), 1 / math.sqrt(f)),
    }


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


def _rotary(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [S, heads, d_head], position = row."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = torch.arange(x.shape[0], dtype=torch.float32,
                       device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def logits(weights: dict, model: dict, tokens: torch.Tensor,
           start: int = 0, cast=None) -> torch.Tensor:
    """Float32 logits ``[S - start, vocab]`` of positions ``start`` to
    ``S - 1`` of the sequence ``tokens`` ``[S]`` (the logits at position
    ``p`` score the token at ``p + 1``).  ``cast`` takes each weight (a
    block's one layer at a time) to the float32 it is computed in:
    ``.float()`` unless given."""
    _check(model)
    cast = cast or (lambda t: t.float())
    h, kv, dh = model["n_heads"], model["n_kv_heads"], model["d_head"]
    eps, theta = model["norm_eps"], model["rope_theta"]
    s = tokens.shape[0]
    causal = torch.ones(s, s, dtype=torch.bool,
                        device=tokens.device).tril()
    blk = "periods.block0."
    with _no_tf32():
        x = cast(weights["embed.tok"])[tokens.long()]
        for i in range(model["num_layers"]):
            def w(name, i=i):
                return cast(weights[blk + name][i])
            a = _norm(x, w("norm1.scale"), eps)
            q = _rotary((a @ w("attn.wq")).view(s, h, dh), theta)
            k = _rotary((a @ w("attn.wk")).view(s, kv, dh), theta)
            v = (a @ w("attn.wv")).view(s, kv, dh)
            k = k.repeat_interleave(h // kv, dim=1)
            v = v.repeat_interleave(h // kv, dim=1)
            scores = torch.einsum("shd,thd->hst", q, k) / math.sqrt(dh)
            p = torch.softmax(scores.masked_fill(~causal, -math.inf), -1)
            del scores
            att = torch.einsum("hst,thd->shd", p, v).reshape(s, h * dh)
            x = x + att @ w("attn.wo")
            m = _norm(x, w("norm2.scale"), eps)
            x = x + torch.relu(m @ w("mlp.w_in")).square() @ w("mlp.w_out")
        x = _norm(x[start:], cast(weights["final_norm.scale"]), eps)
        return x @ cast(weights["embed.head"])[:, :model["vocab"]]
