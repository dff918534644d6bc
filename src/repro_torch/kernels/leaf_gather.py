"""GBDT leaf aggregation: wrapper of the CUDA kernel.

Replaces the TPU kernel ``src/repro/kernels/leaf_gather.py ::
leaf_gather``.  The TPU ran the gather as a one-hot contraction on its
matrix unit; the kernel (``csrc/leaf_gather.cu``) gathers directly, one
warp per instance, and sums each instance's trees in a fixed order, so
its result is the same on every launch.  It is bound by the address
matrix it reads.  A CPU tensor takes the plain version
:func:`repro_torch.kernels.ref.leaf_gather_ref`, which sums in another
order: the two agree to float32 rounding, not bit for bit.
"""

from __future__ import annotations

import torch

from . import _build
from .common import on_card
from .ref import leaf_gather_ref

#: the most leaves per tree the kernel stages in shared memory beside the
#: addresses (``MAX_STAGED_L`` in ``csrc/leaf_gather.cu``): depth 6
MAX_STAGED_LEAVES = 64
_MAX_DIM = 2 ** 31 - 1       # B, T and L are C ints in the kernel


def route(t: int, n_leaves: int, addrs_ptr: int) -> tuple[bool, bool]:
    """The kernel's route for ``[B, t]`` addresses at ``addrs_ptr`` and
    ``n_leaves`` leaves per tree: ``(vec, staged)``.  ``vec``: every row
    starts on a 16-byte boundary (``t % 4 == 0`` and an aligned base), so
    the addresses are copied 16 bytes a lane, else 4.  ``staged``: each
    tile's leaf rows fit beside its addresses in shared memory, else the
    leaves are read from the table through L1.  Both routes of each
    choice give the same bits."""
    return t % 4 == 0 and addrs_ptr % 16 == 0, n_leaves <= MAX_STAGED_LEAVES


def leaf_gather(addrs: torch.Tensor, leaves: torch.Tensor) -> torch.Tensor:
    """addrs: [B, T] int32 leaf address per (instance, tree); leaves:
    [T, L] float32 leaf values.  Returns [B] float32, the sum over trees
    of ``leaves[t, addrs[b, t]]``; an address outside ``[0, L)`` adds
    0."""
    if addrs.dim() != 2 or addrs.dtype != torch.int32:
        raise ValueError(f"addrs must be a 2-D int32 tensor, got "
                         f"{addrs.dim()}-D {addrs.dtype}")
    if leaves.dim() != 2 or leaves.dtype != torch.float32:
        raise ValueError(f"leaves must be a 2-D float32 tensor, got "
                         f"{leaves.dim()}-D {leaves.dtype}")
    b, t = addrs.shape
    if leaves.shape[0] != t:
        raise ValueError(f"{t} trees of addresses but {leaves.shape[0]} "
                         "rows of leaves")
    if not on_card(addrs, leaves):
        return leaf_gather_ref(addrs, leaves)
    nl = leaves.shape[1]
    if max(b, t, nl) > _MAX_DIM:
        raise ValueError(f"[{b}, {t}] addresses and {nl} leaves; the kernel "
                         f"takes at most {_MAX_DIM} of each")
    addrs, leaves = addrs.contiguous(), leaves.contiguous()
    vec, staged = route(t, nl, addrs.data_ptr())
    out = torch.empty((b,), dtype=torch.float32, device=addrs.device)
    lib = _build.load("leaf_gather")
    stream = torch.cuda.current_stream(addrs.device).cuda_stream
    err = lib.leaf_gather_launch(addrs.data_ptr(), leaves.data_ptr(), b, t,
                                 nl, vec, staged, out.data_ptr(), stream)
    _build.check(lib, err, "leaf_gather")
    leaf_gather.launches += 1
    return out


leaf_gather.launches = 0
