"""Clutch chunk merge (Algorithm 1): wrappers of the CUDA kernel.

Replaces two TPU kernels of ``src/repro/kernels/clutch_merge.py``:

* ``clutch_merge`` -- one LUT ``[R, W]``, one scalar's ``[C]`` lt/le
  row indices -> the ``[W]`` bitmap of ``a < B``;
* ``clutch_merge_banked`` -- per-bank LUTs ``[B, R, W]``, per-bank
  ``[B, C]`` indices -> ``[B, W]``.

Both run on one CUDA function (``csrc/clutch_merge.cu :: merge_kernel``),
the unbanked merge being one bank; each wrapper keeps its own launch
count.  The kernel takes any number of banks and is bound by the rows
it reads (see the note in the source); it reads a thread's four words
of a row as one 16-byte load where it can
(:func:`~repro_torch.kernels.common.quad_rows`).  A CPU tensor takes
the plain version from :mod:`repro_torch.kernels.ref`.  Host indices outside the LUT raise
before the launch.
"""

from __future__ import annotations

import torch

from . import _build
from .common import check_words, index_tensor, on_card, quad_rows
from .ref import clutch_merge_banked_ref, clutch_merge_ref


def _indices(lut: torch.Tensor, lt_idx, le_idx, lead: tuple):
    """lt/le as int32 tensors on the LUT's device, both shaped ``lead +
    (C,)`` with C >= 1."""
    r = lut.shape[-2]
    lt = index_tensor(lt_idx, r, lut.device)
    le = index_tensor(le_idx, r, lut.device)
    n = len(lead) + 1
    if lt.shape != le.shape or lt.dim() != n or \
            tuple(lt.shape[:-1]) != lead or lt.shape[-1] < 1:
        raise ValueError(f"lt/le indices must both be {list(lead) + ['C']}"
                         f" with C >= 1, got {tuple(lt.shape)} and "
                         f"{tuple(le.shape)}")
    return lt, le


def _launch(lut: torch.Tensor, lt: torch.Tensor, le: torch.Tensor
            ) -> torch.Tensor:
    """``lut`` [B, R, W], ``lt``/``le`` [B, C] int32 on the card."""
    b, r, w = lut.shape
    lut = lut.contiguous()
    out = torch.empty((b, w), dtype=torch.int32, device=lut.device)
    lib = _build.load("clutch_merge")
    stream = torch.cuda.current_stream(lut.device).cuda_stream
    err = lib.merge_launch(lut.data_ptr(), lt.data_ptr(), le.data_ptr(),
                           lt.shape[-1], b, r, w, int(quad_rows(lut)),
                           out.data_ptr(), stream)
    _build.check(lib, err, "clutch_merge.merge_kernel")
    return out


def clutch_merge(lut: torch.Tensor, lt_idx, le_idx) -> torch.Tensor:
    """Algorithm 1 merge over one LUT.

    lut: [R, W] int32 stacked chunk planes and constant rows.  lt_idx /
    le_idx: [C] row indices, boundary substitutions included
    (:func:`repro_torch.kernels.ops.resolve_indices`).  Returns the
    [W] int32 bitmap of ``a < B``; ``le_idx[0]`` is never read."""
    check_words(lut, 2)
    lt, le = _indices(lut, lt_idx, le_idx, ())
    if not on_card(lut, lt, le):
        return clutch_merge_ref(lut, lt, le)
    out = _launch(lut[None], lt, le)[0]
    clutch_merge.launches += 1
    return out


def clutch_merge_banked(lut: torch.Tensor, lt_idx, le_idx) -> torch.Tensor:
    """Per-bank Algorithm 1 merge: each bank compares its own scalar.

    lut: [B, R, W] int32, one stacked LUT per bank.  lt_idx / le_idx:
    [B, C] per-bank row indices
    (:func:`repro_torch.kernels.ops.resolve_indices_banked`).  Returns
    [B, W] int32 bitmaps of ``a_b < B_b``."""
    check_words(lut, 3)
    lt, le = _indices(lut, lt_idx, le_idx, (lut.shape[0],))
    if not on_card(lut, lt, le):
        return clutch_merge_banked_ref(lut, lt, le)
    out = _launch(lut, lt, le)
    clutch_merge_banked.launches += 1
    return out


clutch_merge.launches = 0
clutch_merge_banked.launches = 0
