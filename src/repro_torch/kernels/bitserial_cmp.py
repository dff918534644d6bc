"""Bit-serial borrow-chain comparison (the baseline): wrapper of the CUDA
kernel.

Replaces the TPU kernel ``src/repro/kernels/bitserial_cmp.py ::
bitserial_cmp``, which the paper sets against Clutch: ``n`` plane reads
per comparison where Clutch reads ``2C - 1`` rows.  The kernel
(``csrc/bitserial_cmp.cu``) takes the scalar by value and reads only
the ``n_bits`` planes it needs; it is bound by those bytes.  A CPU tensor
takes the plain version :func:`repro_torch.kernels.ref.bitserial_cmp_ref`.
"""

from __future__ import annotations

import torch

from . import _build
from .common import MASK32, WORD_BITS, check_words, on_card
from .ref import bitserial_cmp_ref


def bitserial_cmp(planes: torch.Tensor, a: int, n_bits: int) -> torch.Tensor:
    """planes: [n_pad, W] int32 bit-planes, LSB plane first (as
    :func:`repro_torch.kernels.ops.encode_bitplanes` lays them out).
    ``a``: a uint32 scalar, of which only the low ``n_bits`` bits are
    read.  Returns the [W] int32 bitmap of ``a < B``."""
    check_words(planes, 2, "planes")
    a = int(a)
    if not 0 <= a <= MASK32:
        raise ValueError(f"scalar {a} is not a uint32 value")
    if not 1 <= n_bits <= min(WORD_BITS, planes.shape[0]):
        raise ValueError(f"n_bits {n_bits} outside [1, "
                         f"{min(WORD_BITS, planes.shape[0])}]")
    if not on_card(planes):
        return bitserial_cmp_ref(planes, a, n_bits)
    planes = planes.contiguous()
    w = planes.shape[1]
    out = torch.empty((w,), dtype=torch.int32, device=planes.device)
    lib = _build.load("bitserial_cmp")
    stream = torch.cuda.current_stream(planes.device).cuda_stream
    err = lib.bitserial_launch(planes.data_ptr(), w, a, n_bits,
                               out.data_ptr(), stream)
    _build.check(lib, err, "bitserial_cmp")
    bitserial_cmp.launches += 1
    return out


bitserial_cmp.launches = 0
