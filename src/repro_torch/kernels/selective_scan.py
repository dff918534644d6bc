"""Mamba-1's selective scan: wrapper of the CUDA kernel.

Replaces no TPU kernel: the reference package scans with ``lax.scan``
in XLA (``src/repro/models/ssm.py :: mamba_block``).  The kernel
(``csrc/selective_scan.cu``) fuses the step's softplus, ``exp(delta A)``,
the float32 recurrence, ``y = C h + D x`` and the ``silu(z)`` gate in
one pass over time, its state in registers, so no [B, S, din, N] tensor
is built; a CPU tensor (or one on the meta device, shapes only) takes
the plain version :func:`repro_torch.kernels.ref.selective_scan_ref`,
which does build them and loops over time in Python, in the arithmetic
the host path always had.  The kernel computes the recurrence, the
``D`` term and the gate in float32 and rounds y once; the plain version
rounds the scan's output first and adds the ``D`` term and the gate in
the activations' dtype.  The kernel has no backward: where a gradient
is wanted, it is the plain version's, recomputed from the inputs in the
backward pass (:func:`~repro_torch.kernels.common.with_plain_grad`).

While a profiler records, each launch adds to the counters
``ssm.scan_tokens`` (rows B * S), ``ssm.scan_channels`` (B * S * din:
x, dt and z read and y written, one element each) and
``ssm.scan_states`` (B * din * N state elements written, and as many
read when a state comes in), from the shapes on the host.
"""

from __future__ import annotations

import torch

from repro_torch.tracing import count, recording

from . import _build
from .common import on_card, with_plain_grad
from .ref import selective_scan_ref

#: the state width the kernel is built for (Mamba-1's d_state)
D_STATE = 16
_DTYPES = (torch.float32, torch.bfloat16)
_MAX_BATCH = 65535           # the grid's second dimension


def _rows(t: torch.Tensor) -> tuple[torch.Tensor, int]:
    """``t`` [B, S, W] and the stride, in elements, between its rows
    ``b * S + s`` (a copy when they are not evenly spaced or a row is
    not contiguous)."""
    bsz, s = t.shape[:2]
    if t.stride(-1) == 1:
        if s == 1:
            return t, t.stride(0)
        if bsz == 1 or t.stride(0) == s * t.stride(1):
            return t, t.stride(1)
    t = t.contiguous()
    return t, t.shape[-1]


def selective_scan(x: torch.Tensor, dt: torch.Tensor, z: torch.Tensor,
                   b: torch.Tensor, c: torch.Tensor, a_log: torch.Tensor,
                   d: torch.Tensor, dt_bias: torch.Tensor,
                   state: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (the convolved input), dt (the step's pre-activation, before
    its bias), z (the gate): [B, S, din]; b, c: [B, S, N], all in one
    dtype (float32 or bfloat16); a_log [din, N], d and dt_bias [din]
    (read as they are when they share float32 or bfloat16, else as
    float32 copies); state: [B, din, N] float32 or None (zeros).
    Returns (y [B, S, din] in x's dtype, the final state [B, din, N]
    float32); the inputs are not written.  See
    :func:`~repro_torch.kernels.ref.selective_scan_ref` for the
    equations."""
    if x.dim() != 3 or x.dtype not in _DTYPES:
        raise ValueError(f"x must be a 3-D float32 or bfloat16 tensor, got "
                         f"{x.dim()}-D {x.dtype}")
    bsz, s, din = x.shape
    n = a_log.shape[-1]
    for name, t, shape in (("dt", dt, x.shape), ("z", z, x.shape),
                           ("b", b, (bsz, s, n)), ("c", c, (bsz, s, n))):
        if tuple(t.shape) != tuple(shape) or t.dtype != x.dtype:
            raise ValueError(f"{name} must be {x.dtype} of shape "
                             f"{tuple(shape)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if tuple(a_log.shape) != (din, n) or d.shape != (din,) \
            or dt_bias.shape != (din,):
        raise ValueError(f"a_log must be [{din}, {n}], d and dt_bias "
                         f"[{din}]; got {tuple(a_log.shape)}, "
                         f"{tuple(d.shape)}, {tuple(dt_bias.shape)}")
    if state is not None and (tuple(state.shape) != (bsz, din, n)
                              or state.dtype != torch.float32):
        raise ValueError(f"state must be float32 of shape {(bsz, din, n)}, "
                         f"got {state.dtype} {tuple(state.shape)}")
    tensors = [x, dt, z, b, c, a_log, d, dt_bias]
    if x.is_meta or not on_card(*tensors,
                                *([state] if state is not None else [])):
        return selective_scan_ref(x, dt, z, b, c, a_log, d, dt_bias, state)
    return with_plain_grad(_launch, selective_scan_ref, x, dt, z, b, c,
                           a_log, d, dt_bias, state)


def _launch(x, dt, z, b, c, a_log, d, dt_bias, state):
    bsz, s, din = x.shape
    n = a_log.shape[-1]
    if n != D_STATE:
        raise ValueError(f"the kernel scans d_state {D_STATE}, not {n}")
    if bsz > _MAX_BATCH:
        raise ValueError(f"the kernel takes at most {_MAX_BATCH} sequences, "
                         f"got {bsz}")
    rows = [_rows(t) for t in (x, dt, z, b, c)]
    params = [a_log, d, dt_bias]
    if len({t.dtype for t in params}) > 1 or params[0].dtype not in _DTYPES:
        params = [t.float() for t in params]
    params = [t.contiguous() for t in params]
    if state is not None:
        state = state.contiguous()
    y = torch.empty((bsz, s, din), dtype=x.dtype, device=x.device)
    h = torch.empty((bsz, din, n), dtype=torch.float32, device=x.device)
    lib = _build.load("selective_scan")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.selective_scan_launch(
        *(t.data_ptr() for t, _ in rows), *(ld for _, ld in rows),
        *(t.data_ptr() for t in params),
        state.data_ptr() if state is not None else None, y.data_ptr(),
        h.data_ptr(), bsz, s, din, int(x.dtype == torch.bfloat16),
        int(params[0].dtype == torch.bfloat16), stream)
    _build.check(lib, err, "selective_scan")
    selective_scan.launches += 1
    if recording():
        count("ssm.scan_tokens", bsz * s)
        count("ssm.scan_channels", bsz * s * din)
        count("ssm.scan_states", bsz * din * n * (1 + (state is not None)))
    return y, h


selective_scan.launches = 0
