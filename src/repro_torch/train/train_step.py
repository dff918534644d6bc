"""The training step: microbatched gradient accumulation over the
(rematerialised) forward/backward, then the AdamW update.

Counterpart of the reference package's ``train/train_step.py`` on one
card, through ``torch.autograd``.  The batch layout is the reference's:
every batch leaf carries the microbatch as its leading axis,
``[microbatches, mb, S]`` (``[..., S, D]`` for embeddings); each
microbatch's gradients, in the parameters' dtype, are accumulated as
``acc + grad.float() / num_micro`` into float32 buffers, and each is
freed once added.  The reference's mesh functions (``dp_axes``,
``batch_specs``, ``shard_batch``, ``jit_train_step``) wait for a
multi-card port (``ROADMAP.md`` Queue 1).
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm as M

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
    return loss.detach(), list(grads)


def make_train_step(cfg: ModelConfig, opt_cfg: O.OptConfig):
    """Returns ``train_step(params, opt_state, batch) -> (params,
    opt_state, stats)``, with ``stats`` holding ``loss`` (the
    microbatches' mean), ``grad_norm`` and ``lr``; the microbatch must
    be the leading axis of every batch leaf.  Parameters and moments are
    updated in place."""

    def train_step(params, opt_state, batch):
        num_micro = next(iter(batch.values())).shape[0]
        flat = flatten(params)
        dev = next(iter(flat.values())).device
        acc = {k: torch.zeros(p.shape, dtype=torch.float32, device=dev)
               for k, p in flat.items()}
        m = torch.tensor(float(num_micro), device=dev)
        losses = []
        for i in range(num_micro):
            loss, grads = value_and_grad(
                cfg, params, {k: v[i] for k, v in batch.items()})
            with torch.no_grad():
                for j, a in enumerate(acc.values()):
                    g, grads[j] = grads[j], None
                    if g is None:
                        continue
                    for s in O.chunks(a):
                        a[s] += g[s].float() / m
            losses.append(loss)
        params, opt_state, stats = O.apply_updates(
            opt_cfg, params, unflatten(acc), opt_state)
        stats["loss"] = torch.stack(losses).mean()
        return params, opt_state, stats

    return train_step
