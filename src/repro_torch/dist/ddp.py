"""Data-parallel training step with error-feedback gradient compression.

Counterpart of the reference package's ``dist/ddp.py``.  Given a mesh
and an axis, the step shards the batch over the axis (fitted, as the
reference fits it) and runs the model on replicated views of the
parameters, so each rank's gradients are partial sums and one real
all-reduce (``full_tensor``) joins them, where the reference's GSPMD
inserts it.  Without a mesh (one card) there is nothing to reduce.
With ``compress=True`` the float32 gradients pass through int8
quantization with an error-feedback residual, the payload a compressed
all-reduce would carry:

    t        = g + err          # re-inject last step's rounding residual
    g_hat    = dequantize(quantize(t))
    err'     = t - g_hat
"""

from __future__ import annotations

import torch

from repro_torch.dist.sharding import (
    P,
    NamedSharding,
    distribute,
    fit,
    use_mesh,
)
from repro_torch.train import optimizer as O
from repro_torch.train.train_step import value_and_grad
from repro_torch.train.tree import flatten, unflatten

from .compression import dequantize, quantize


def init_error_state(params):
    """Zero error-feedback residuals, one per parameter leaf (f32)."""
    return {k: init_error_state(v) if isinstance(v, dict)
            else torch.zeros(v.shape, dtype=torch.float32, device=v.device)
            for k, v in params.items()}


def _replicated(params, mesh):
    """Each plain parameter as a replicated DTensor sharing its storage."""
    from torch.distributed.tensor import DTensor, Replicate

    pl = [Replicate()] * mesh.ndim
    return unflatten({k: DTensor.from_local(v, mesh, pl, run_check=False)
                      for k, v in flatten(params).items()})


def make_ddp_step(cfg, opt_cfg: O.OptConfig, compress: bool = False,
                  mesh=None, axis: str | None = None):
    """Returns ``step(params, opt_state, err, batch) -> (params,
    opt_state, err, loss)``; ``batch`` is the global batch ([B, S]
    leaves, no microbatch axis), the same on every rank.  Parameters,
    moments and ``err`` are plain tensors, updated in place (the same on
    every rank, each having applied the all-reduced gradients)."""
    if (mesh is None) != (axis is None):
        raise ValueError("make_ddp_step takes a mesh and an axis together")

    def grads_of(params, batch):
        if mesh is None:
            return value_and_grad(cfg, params, batch)
        from torch.distributed.tensor.experimental import (
            implicit_replication,
        )

        batch = {k: distribute(v, NamedSharding(
            mesh, fit(P(axis), tuple(v.shape), mesh)))
            for k, v in batch.items()}
        with use_mesh(mesh), implicit_replication():
            loss, grads = value_and_grad(cfg, _replicated(params, mesh),
                                         batch)
        # the partial sums of the data shards, all-reduced
        return loss, [None if g is None else g.full_tensor() for g in grads]

    def step(params, opt_state, err, batch):
        loss, grads = grads_of(params, batch)
        flat = flatten(params)
        grads = {k: torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device) if g is None else g.float()
                 for (k, p), g in zip(flat.items(), grads)}
        if compress:
            with torch.no_grad():
                for k, e in flatten(err).items():
                    total = grads[k] + e
                    grads[k] = dequantize(*quantize(total))
                    e.copy_(total - grads[k])
        params, opt_state, _ = O.apply_updates(
            opt_cfg, params, unflatten(grads), opt_state)
        return params, opt_state, err, loss

    return step
