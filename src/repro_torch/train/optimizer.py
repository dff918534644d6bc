"""AdamW with a warmup + cosine schedule, and ZeRO-1-style moments.

Counterpart of the reference package's ``train/optimizer.py``.  Moments
take their parameter's partition spec (:func:`opt_state_specs`), so on
a mesh the optimizer state is sharded as the parameters are.  The
arithmetic is the reference's, in its float32 order:

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
take five float32 temporaries of 4 GB each.  On DTensor leaves the
update runs on each rank's local pieces (every leaf's moments placed as
the parameter, each gradient redistributed to it first); only the
global norm is a collective.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.dist.sharding import P, is_dtensor

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


def opt_state_specs(param_specs: Params) -> Params:
    """The partition-spec tree of :func:`init_opt_state`'s result: each
    moment as its parameter, the step count replicated."""
    return {"mu": param_specs, "nu": param_specs, "count": P()}


def _local(t: torch.Tensor, like: torch.Tensor | None = None
           ) -> torch.Tensor:
    """A DTensor's local piece (a view: writes to it write the DTensor),
    after redistributing it to ``like``'s placements when given; a plain
    tensor itself."""
    if not is_dtensor(t):
        return t
    if like is not None and tuple(t.placements) != tuple(like.placements):
        t = t.redistribute(like.device_mesh, like.placements)
    return t.to_local()


def _leaf_sum(t: torch.Tensor, local: torch.Tensor) -> torch.Tensor:
    """The sum of a leaf over all its elements, given ``local``, the sum
    over this rank's piece: for a DTensor, the pieces' sums added over
    the mesh dimensions that shard it (a collective); else ``local``."""
    if not is_dtensor(t):
        return local
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    pl = [Partial() if isinstance(q, Shard) else Replicate()
          for q in t.placements]
    return DTensor.from_local(local, t.device_mesh, pl,
                              run_check=False).full_tensor()


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
        gl = _local(g)
        total = total + _leaf_sum(g, sum(torch.sum(torch.square(
            gl[s].float())) for s in chunks(gl)))
    return torch.sqrt(total)


def apply_updates(cfg: OptConfig, params: Params, grads: Params,
                  state: Params) -> tuple[Params, Params, dict]:
    """One AdamW step with global-norm clipping.  Writes ``params`` and
    the moments of ``state`` in place and returns (params, state,
    {"grad_norm", "lr"}); ``state["count"]`` is replaced by count + 1."""
    count = int(_local(state["count"]))
    dev = _local(state["count"]).device
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
        for pd, g, mu, nu in zip(leaves(params), leaves(grads),
                                 leaves(state["mu"]), leaves(state["nu"])):
            if is_dtensor(pd) and not (
                    tuple(mu.placements) == tuple(nu.placements)
                    == tuple(pd.placements)):
                raise ValueError("moments are not placed as their "
                                 "parameter (opt_state_specs)")
            p, g, mu, nu = _local(pd), _local(g, pd), _local(mu), _local(nu)
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
    new_count = torch.full((), count + 1, dtype=torch.int32, device=dev)
    if is_dtensor(state["count"]):
        c = state["count"]
        new_count = type(c).from_local(new_count, c.device_mesh,
                                       c.placements, run_check=False)
    state["count"] = new_count
    return params, state, {"grad_norm": gnorm, "lr": lr}
