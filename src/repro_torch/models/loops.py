"""Loops over steps of identical shapes -- a recurrence's time steps, a
train step's microbatches -- which the dry run may sample.

The dry run (:mod:`repro_torch.launch.dryrun`) traces a full-width step
on fake tensors, where only shapes and counts matter.  Under a sampler
(:data:`STEP_SAMPLER`) such a loop runs its first step only, inside
``sampler(n)``, which scales what the dry run's counters record by
``n``, and that step's result stands in for every step.  With no
sampler (the default) every step runs.
"""

from __future__ import annotations

import contextvars

STEP_SAMPLER: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_step_sampler", default=None)


def repeat(n: int, body) -> list:
    """``[body(i) for i in range(n)]``, or under :data:`STEP_SAMPLER`
    ``body(0)`` counted ``n`` times and repeated."""
    sampler = STEP_SAMPLER.get()
    if sampler is None or n <= 1:
        return [body(i) for i in range(n)]
    with sampler(n):
        y = body(0)
    return [y] * n
