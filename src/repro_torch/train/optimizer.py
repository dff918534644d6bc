"""AdamW with a warmup + cosine schedule.

Counterpart of the reference package's ``train/optimizer.py`` on one
card (its ``opt_state_specs`` places moments on a mesh and is left
out).  The arithmetic is the reference's, in its float32 order:

  * the schedule, the bias corrections ``c1``/``c2`` and the clip scale
    are float32 scalars, as JAX's weakly typed Python scalars make them;
    the schedule and bias corrections are computed on the host;
  * weight decay applies where the whole stacked leaf has ``ndim >= 2``,
    so period-stacked norm scales ``[P, D]`` are decayed too.

Unlike the reference, which returns new trees, :func:`apply_updates`
writes parameters and moments in place, a leaf at a time and a piece of
at most :data:`CHUNK` elements along the leading (period) axis at a
time, so the float32 temporaries stay that size: updated whole, the
experts' ``w_in`` of granite-moe-3b ([32, 40, 1536, 512] in bf16) would
take five float32 temporaries of 4 GB each.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from .tree import leaves

Params = Any
CHUNK = 1 << 25


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    opt_dtype: str = "float32"


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def schedule(cfg: OptConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an integer), as a float32 0-d
    tensor on the CPU: linear warmup, then cosine decay to 0."""
    step = torch.tensor(int(step), dtype=torch.int32)
    warm = _f32(cfg.lr) * (step + 1).float() / _f32(max(cfg.warmup_steps, 1))
    prog = torch.clamp((step - cfg.warmup_steps).float()
                       / _f32(max(cfg.total_steps - cfg.warmup_steps, 1)),
                       0.0, 1.0)
    cos = _f32(0.5 * cfg.lr) * (1.0 + torch.cos(_f32(math.pi) * prog))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(cfg: OptConfig, params: Params) -> Params:
    """Zero moments in ``cfg.opt_dtype`` beside each parameter, and a 0-d
    int32 step ``count``."""
    dt = getattr(torch, cfg.opt_dtype)

    def zeros(tree):
        return {k: zeros(v) if isinstance(v, dict)
                else torch.zeros(v.shape, dtype=dt, device=v.device)
                for k, v in tree.items()}

    dev = leaves(params)[0].device
    return {"mu": zeros(params), "nu": zeros(params),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def chunks(t: torch.Tensor) -> list[slice]:
    """Slices along ``t``'s leading axis of at most :data:`CHUNK`
    elements each (one slice for a 0-d or small tensor)."""
    if t.dim() == 0:
        return [slice(None)]
    n = t.shape[0]
    rows = max(1, CHUNK // max(1, t.numel() // max(n, 1)))
    return [slice(i, min(i + rows, n)) for i in range(0, n, rows)]


def global_norm(tree: Params) -> torch.Tensor:
    """sqrt of the float32 sum of squares of every leaf, summed over the
    leaves in the reference's order."""
    total = 0
    for g in leaves(tree):
        total = total + sum(torch.sum(torch.square(g[s].float()))
                            for s in chunks(g))
    return torch.sqrt(total)


def apply_updates(cfg: OptConfig, params: Params, grads: Params,
                  state: Params) -> tuple[Params, Params, dict]:
    """One AdamW step with global-norm clipping.  Writes ``params`` and
    the moments of ``state`` in place and returns (params, state,
    {"grad_norm", "lr"}); ``state["count"]`` is replaced by count + 1."""
    count = int(state["count"])
    dev = state["count"].device
    gnorm = global_norm(grads)
    # a tensor over a tensor: ``float / tensor`` multiplies by a reciprocal
    scale = torch.clamp(_f32(cfg.grad_clip).to(dev) / (gnorm + 1e-9),
                        max=1.0)
    lr = schedule(cfg, count)
    c1 = 1.0 - torch.pow(_f32(cfg.b1), _f32(count + 1))
    c2 = 1.0 - torch.pow(_f32(cfg.b2), _f32(count + 1))
    lr_d, c1_d, c2_d = (x.to(dev) for x in (lr, c1, c2))
    dt = getattr(torch, cfg.opt_dtype)
    with torch.no_grad():
        for p, g, mu, nu in zip(leaves(params), leaves(grads),
                                leaves(state["mu"]), leaves(state["nu"])):
            for s in chunks(p):
                g32 = g[s].float() * scale
                mu32 = cfg.b1 * mu[s].float() + (1 - cfg.b1) * g32
                nu32 = cfg.b2 * nu[s].float() + (1 - cfg.b2) * g32 * g32
                step = (mu32 / c1_d) / (torch.sqrt(nu32 / c2_d) + cfg.eps)
                if p.dim() >= 2:  # decoupled weight decay on matrices only
                    step = step + cfg.weight_decay * p[s].float()
                new_p = p[s].float() - lr_d * step
                p[s] = new_p.to(p.dtype)
                mu[s] = mu32.to(dt)
                nu[s] = nu32.to(dt)
    state["count"] = torch.full((), count + 1, dtype=torch.int32,
                                device=dev)
    return params, state, {"grad_norm": gnorm, "lr": lr}
