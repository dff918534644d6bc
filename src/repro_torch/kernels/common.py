"""Bit conventions shared by the Hopper kernels and their plain versions.

* Bitmaps are packed little-endian: element ``i`` is bit ``i % 32`` of
  word ``i // 32`` (NumPy :func:`pack_bits` / :func:`unpack_bits`).
* Words travel as **int32 bit patterns**: PyTorch has no usable
  ``uint32`` (its ``>>``, ``<<`` and ``<`` raise on the CPU) and no
  popcount, so NumPy ``uint32`` arrays cross with ``.view(np.int32)``
  and the plain versions compare and popcount in int64 after
  ``& 0xFFFFFFFF``.
* 2-D word arrays are ``[rows, W]`` with W padded to a multiple of
  ``LANES`` and rows to a multiple of ``SUBLANES``, as in the reference
  package, so LUT layouts and row offsets agree byte for byte.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

WORD_BITS = 32
LANES = 128
SUBLANES = 8
MASK32 = 0xFFFFFFFF


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def maj3(a, b, c):
    """Bitwise 3-input majority -- NOT-free, exactly as in-DRAM MAJ3."""
    return (a & b) | (b & c) | (a & c)


# ------------------------------ devices ------------------------------ #

def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller
    names another.  With no CUDA and no ``device`` given this raises
    instead of carrying on on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "plain PyTorch versions of the kernels")
        return torch.device("cuda")
    return torch.device(device)


def on_card(*tensors: torch.Tensor) -> bool:
    """Whether a wrapper must launch its kernel: True when every tensor
    lies on one CUDA device, False when every tensor lies on the CPU
    (the plain version runs).  Anything else raises."""
    kinds = {t.device for t in tensors}
    if len(kinds) != 1:
        raise ValueError(f"tensors lie on several devices: {kinds}")
    dev = next(iter(kinds))
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {dev}")


# ------------------------ NumPy packing (host) ------------------------ #

def pack_bits(bits: np.ndarray) -> np.ndarray:
    """Pack 0/1 bits [..., N] into uint32 words [..., ceil(N/32)],
    little-endian within the word."""
    bits = np.asarray(bits)
    bits = bits.view(np.uint8) if bits.dtype == np.bool_ \
        else bits.astype(np.uint8, copy=False)
    n = bits.shape[-1]
    pad = (-n) % WORD_BITS
    if pad:
        bits = np.concatenate(
            [bits, np.zeros(bits.shape[:-1] + (pad,), np.uint8)], axis=-1
        )
    if sys.byteorder == "little":
        packed = np.packbits(bits, axis=-1, bitorder="little")
        return np.ascontiguousarray(packed).view(np.uint32)
    b = bits.reshape(*bits.shape[:-1], -1, WORD_BITS).astype(np.uint32)
    shifts = np.arange(WORD_BITS, dtype=np.uint32)
    return (b << shifts).sum(axis=-1, dtype=np.uint32)


def unpack_bits(words: np.ndarray, n: int) -> np.ndarray:
    """Inverse of :func:`pack_bits`; returns uint8 bits [..., n]."""
    words = np.asarray(words, dtype=np.uint32)
    if sys.byteorder == "little":
        as_bytes = np.ascontiguousarray(words).view(np.uint8)
        bits = np.unpackbits(as_bytes, axis=-1, bitorder="little")
        return bits[..., :n]
    shifts = np.arange(WORD_BITS, dtype=np.uint32)
    bits = (words[..., :, None] >> shifts) & np.uint32(1)
    bits = bits.reshape(*words.shape[:-1], -1)
    return bits[..., :n].astype(np.uint8)


# ------------------------ torch twins (device) ------------------------ #

def to_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the int32 tensor with the same low
    32 bits (no reliance on how a narrowing cast wraps)."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def pack_bits_torch(bits: torch.Tensor) -> torch.Tensor:
    """[..., N] 0/1 -> [..., ceil(N/32)] int32 words (little-endian)."""
    n = bits.shape[-1]
    pad = (-n) % WORD_BITS
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    b = bits.reshape(*bits.shape[:-1], -1, WORD_BITS)
    acc = torch.zeros(b.shape[:-1], dtype=torch.int64, device=bits.device)
    for i in range(WORD_BITS):
        acc |= b[..., i].to(torch.int64) << i
    return to_int32_bits(acc)


def unpack_bits_torch(words: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_bits_torch`; returns uint8 bits [..., n]."""
    shifts = torch.arange(WORD_BITS, dtype=torch.int64, device=words.device)
    bits = ((words.to(torch.int64) & MASK32)[..., None] >> shifts) & 1
    return bits.reshape(*words.shape[:-1], -1)[..., :n].to(torch.uint8)


def popcount_torch(words: torch.Tensor) -> torch.Tensor:
    """Per-word popcount of int32 bit patterns (SWAR in int64)."""
    x = words.to(torch.int64) & MASK32
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF
