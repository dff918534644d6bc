"""Pipeline parallelism with the GPipe schedule, forward only.

Counterpart of the reference package's ``dist/pipeline.py``.  Stage
``i``'s parameters live on ``devices[i]``; microbatches stream through
the pipe, shifted one stage down each tick.  With ``S`` stages and ``M``
microbatches the schedule runs ``M + S - 1`` ticks: tick ``t`` has
stage 0 ingesting microbatch ``t`` while stage ``S-1`` retires
microbatch ``t - (S-1)`` -- the fill/drain bubble of ``(S-1)/(M+S-1)``.
The reference's ``ppermute`` ring shift is a ``.to(devices[i + 1])``;
a stage that holds no microbatch in a tick (the bubble) computes
nothing, where the reference computes on stale activations and drops
the result.  On one card every entry of ``devices`` is that card.
"""

from __future__ import annotations

import torch


def pipeline_forward(stage_fn, devices, stage_params: torch.Tensor,
                     xs: torch.Tensor) -> torch.Tensor:
    """Run ``xs`` through ``S = len(devices)`` stages.

    stage_fn: ``(W_i, x) -> y`` applied by stage i.
    stage_params: [S, ...] stacked per-stage parameters.
    xs: [M, ...] microbatches.
    Returns [M, ...] on the last stage's device:
    ``stage_{S-1}(... stage_0(xs[m]) ...)`` per m."""
    devices = [torch.device(d) for d in devices]
    num_stages, num_micro = len(devices), xs.shape[0]
    if stage_params.shape[0] != num_stages:
        raise ValueError(f"{stage_params.shape[0]} stages vs "
                         f"{num_stages} devices")
    last = num_stages - 1
    ws = [stage_params[i].to(d) for i, d in enumerate(devices)]
    acts: list[torch.Tensor | None] = [None] * num_stages
    outs = None
    for t in range(num_micro + last):
        acts[0] = xs[t].to(devices[0]) if t < num_micro else None
        ys = [None if a is None else stage_fn(w, a)
              for w, a in zip(ws, acts)]
        if t >= last:                  # microbatch t - last retires
            if outs is None:
                outs = ys[last].new_empty((num_micro,) + ys[last].shape)
            outs[t - last] = ys[last]
        # shift activations one stage down the pipe
        acts[1:] = [None if y is None else y.to(d)
                    for y, d in zip(ys[:last], devices[1:])]
    return outs
