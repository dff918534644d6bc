"""Data-parallel training step with error-feedback gradient compression.

Counterpart of the reference package's ``dist/ddp.py`` on one card.
The reference shards the batch over a mesh axis and lets GSPMD insert
the gradient all-reduce; on one card that all-reduce is the identity,
so its ``mesh`` and ``axis`` arguments are gone.  With
``compress=True`` the float32 gradients pass through int8 quantization
with an error-feedback residual, the payload a compressed all-reduce
would carry:

    t        = g + err          # re-inject last step's rounding residual
    g_hat    = dequantize(quantize(t))
    err'     = t - g_hat
"""

from __future__ import annotations

import torch

from repro_torch.train import optimizer as O
from repro_torch.train.train_step import value_and_grad
from repro_torch.train.tree import flatten, unflatten

from .compression import dequantize, quantize


def init_error_state(params):
    """Zero error-feedback residuals, one per parameter leaf (f32)."""
    return {k: init_error_state(v) if isinstance(v, dict)
            else torch.zeros(v.shape, dtype=torch.float32, device=v.device)
            for k, v in params.items()}


def make_ddp_step(cfg, opt_cfg: O.OptConfig, compress: bool = False):
    """Returns ``step(params, opt_state, err, batch) -> (params,
    opt_state, err, loss)``; ``batch`` is the global batch ([B, S]
    leaves, no microbatch axis).  Parameters, moments and ``err`` are
    updated in place."""

    def step(params, opt_state, err, batch):
        loss, grads = value_and_grad(cfg, params, batch)
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
