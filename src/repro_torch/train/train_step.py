"""The training step: microbatched gradient accumulation over the
(rematerialised) forward/backward, then the AdamW update.

Counterpart of the reference package's ``train/train_step.py`` on one
card, through ``torch.autograd``.  The batch layout is the reference's:
every batch leaf carries the microbatch as its leading axis,
``[microbatches, mb, S]`` (``[..., S, D]`` for embeddings); each
microbatch's gradients, in the parameters' dtype, are accumulated as
``acc + grad.float() / num_micro`` into float32 buffers, and each is
freed once added.

On a mesh (``torch.distributed``'s ``DeviceMesh``) the same step runs
over DTensor parameters, moments and batch: :func:`jit_train_step`
(the reference's name; nothing is compiled) distributes the batch with
:func:`batch_specs` and runs the step under the ambient mesh and
``implicit_replication``.  The gradient reductions the reference's
GSPMD inserts are DTensor's redistributions.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import (
    P,
    NamedSharding,
    distribute,
    full,
    is_dtensor,
    use_mesh,
)
from repro_torch.models import lm as M
from repro_torch.models.loops import repeat

from . import optimizer as O
from .tree import flatten, unflatten

Params = Any


def value_and_grad(cfg: ModelConfig, params: Params, batch: dict
                   ) -> tuple[torch.Tensor, list]:
    """``forward_loss`` on one (micro)batch and its gradient for every
    leaf of ``params`` (in the reference's leaf order; None where a leaf
    does not reach the loss).  The leaves' ``requires_grad`` is set for
    the call and restored after."""
    leaves = list(flatten(params).values())
    flags = [p.requires_grad for p in leaves]
    try:
        for p in leaves:
            p.requires_grad_(True)
        with torch.enable_grad():
            loss = M.forward_loss(cfg, params, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for p, f in zip(leaves, flags):
            p.requires_grad_(f)
    return full(loss.detach()), list(grads)


def make_train_step(cfg: ModelConfig, opt_cfg: O.OptConfig):
    """Returns ``train_step(params, opt_state, batch) -> (params,
    opt_state, stats)``, with ``stats`` holding ``loss`` (the
    microbatches' mean), ``grad_norm`` and ``lr``; the microbatch must
    be the leading axis of every batch leaf.  Parameters and moments are
    updated in place."""

    def train_step(params, opt_state, batch):
        num_micro = next(iter(batch.values())).shape[0]
        flat = flatten(params)
        dev = O._local(next(iter(flat.values()))).device
        acc = {k: torch.zeros_like(p, dtype=torch.float32)
               if is_dtensor(p) else
               torch.zeros(p.shape, dtype=torch.float32, device=dev)
               for k, p in flat.items()}
        m = torch.tensor(float(num_micro), device=dev)

        def micro(i):
            loss, grads = value_and_grad(
                cfg, params, {k: v[i] for k, v in batch.items()})
            with torch.no_grad():
                for j, ad in enumerate(acc.values()):
                    g, grads[j] = grads[j], None
                    if g is None:
                        continue
                    a, g = O._local(ad), O._local(g, ad)
                    for s in O.chunks(a):
                        a[s] += g[s].float() / m
            return loss

        losses = repeat(num_micro, micro)
        params, opt_state, stats = O.apply_updates(
            opt_cfg, params, unflatten(acc), opt_state)
        stats["loss"] = torch.stack(losses).mean()
        return params, opt_state, stats

    return train_step


# ------------------------------------------------------------------ #
# On a mesh
# ------------------------------------------------------------------ #

def dp_axes(mesh) -> tuple[str, ...]:
    """Batch-sharding axes present in this mesh ("pod" merges into DP)."""
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def _batch_spec(name: str, ndim: int, dp: tuple[str, ...]) -> P:
    if name in ("tokens", "labels"):
        # [M, mb, S] or [B, S]: the batch dim is the first non-microbatch
        return P(None, dp, None) if ndim == 3 else P(dp, None)
    # embeds: [..., S, D]
    return P(None, dp, None, None) if ndim == 4 else P(dp, None, None)


def batch_specs(cfg: ModelConfig, mesh, batch_shapes: dict) -> dict:
    """``{name: P}`` for a batch of ``{name: (shape, dtype)}``."""
    dp = dp_axes(mesh)
    return {name: _batch_spec(name, len(shape), dp)
            for name, (shape, _) in batch_shapes.items()}


def shard_batch(batch: dict, mesh, cfg: ModelConfig) -> dict:
    """Every leaf of ``batch`` (the whole batch, the same on every rank)
    distributed over the mesh's data-parallel axes (DTensor splits a
    batch the axes do not divide unevenly)."""
    dp = dp_axes(mesh)
    return {k: distribute(v, NamedSharding(mesh, _batch_spec(k, v.dim(),
                                                             dp)))
            for k, v in batch.items()}


def jit_train_step(cfg: ModelConfig, opt_cfg: O.OptConfig, mesh,
                   batch_shapes: dict):
    """The train step on ``mesh``, the reference's ``jit_train_step``
    (the name kept; nothing is compiled): ``step(params, opt_state,
    batch) -> (params, opt_state, stats)`` over DTensor parameters and
    moments placed by ``param_specs`` / ``opt_state_specs``
    (:func:`repro_torch.dist.sharding.shardings`).  A plain batch leaf
    is distributed by :func:`batch_specs` first.  ``stats`` hold plain
    tensors, the same on every rank."""
    from torch.distributed.tensor.experimental import implicit_replication

    bspecs = batch_specs(cfg, mesh, batch_shapes)
    step = make_train_step(cfg, opt_cfg)

    def sharded_step(params, opt_state, batch):
        batch = {k: v if is_dtensor(v) else distribute(
            v, NamedSharding(mesh, bspecs[k])) for k, v in batch.items()}
        with use_mesh(mesh), implicit_replication():
            return step(params, opt_state, batch)

    return sharded_step
