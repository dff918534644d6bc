"""Bit conventions shared by the Hopper kernels and their plain versions.

* Bitmaps are packed little-endian: element ``i`` is bit ``i % 32`` of
  word ``i // 32`` (NumPy :func:`pack_bits` / :func:`unpack_bits`, from
  :mod:`repro_torch.core.machine`).
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

import torch

from repro_torch.core.machine import (  # noqa: F401  (re-exported)
    WORD_BITS,
    pack_bits,
    unpack_bits,
)

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


def with_plain_grad(launch, plain, *args):
    """``launch(*args)``, a kernel's wrapper; where autograd wants a
    gradient through it, the gradient of ``plain(*args)``, its plain
    version, recomputed from the inputs in the backward pass (the
    kernels have no backward of their own).  ``args`` may hold tensors,
    None and numbers."""
    if torch.is_grad_enabled() and any(
            isinstance(a, torch.Tensor) and a.requires_grad for a in args):
        return _PlainGrad.apply(launch, plain, *args)
    return launch(*args)


class _PlainGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, launch, plain, *args):
        ctx.plain = plain
        ctx.where = [i for i, a in enumerate(args)
                     if isinstance(a, torch.Tensor)]
        ctx.rest = [None if isinstance(a, torch.Tensor) else a for a in args]
        ctx.save_for_backward(*(args[i] for i in ctx.where))
        return launch(*args)

    @staticmethod
    def backward(ctx, *grads):
        args = list(ctx.rest)
        wanted = []
        with torch.enable_grad():
            for i, t in zip(ctx.where, ctx.saved_tensors):
                need = ctx.needs_input_grad[2 + i]
                args[i] = t.detach().requires_grad_(need)
                if need:
                    wanted.append(i)
            outs = ctx.plain(*args)
        outs = outs if isinstance(outs, tuple) else (outs,)
        pairs = [(o, g) for o, g in zip(outs, grads)
                 if g is not None and o.requires_grad]
        got = torch.autograd.grad([o for o, _ in pairs],
                                  [args[i] for i in wanted],
                                  [g for _, g in pairs], allow_unused=True)
        out = [None] * (2 + len(args))
        for i, g in zip(wanted, got):
            out[2 + i] = g
        return tuple(out)


# --------------------------- wrapper inputs --------------------------- #

def index_tensor(idx, n_rows: int, device: torch.device) -> torch.Tensor:
    """``idx`` as a contiguous int32 tensor on ``device``; host indices
    outside ``[0, n_rows)`` raise (a negative one would otherwise wrap
    in a plain version's indexing).  Indices already on the card are
    clamped into range by the kernels while staged."""
    t = torch.as_tensor(idx)
    if t.device.type == "cpu" and t.numel():
        lo, hi = int(t.min()), int(t.max())
        if lo < 0 or hi >= n_rows:
            raise ValueError(
                f"row indices span [{lo}, {hi}], outside the LUT's "
                f"{n_rows} rows")
    return t.to(device=device, dtype=torch.int32).contiguous()


def quad_rows(lut: torch.Tensor) -> bool:
    """Whether the gather kernels (``csrc/clutch.cuh :: Rows``) read a
    thread's four words of a LUT row as one 16-byte load: W a multiple
    of 4 and the LUT 16-byte aligned; else four 4-byte loads."""
    return lut.shape[-1] % 4 == 0 and lut.data_ptr() % 16 == 0


def check_words(t: torch.Tensor, ndim: int, what: str = "LUT") -> None:
    """Raise unless ``t`` is an ``ndim``-D int32 tensor of words."""
    if t.dim() != ndim or t.dtype != torch.int32:
        raise ValueError(f"{what} must be a {ndim}-D int32 tensor, got "
                         f"{t.dim()}-D {t.dtype}")


# ------------------------ torch twins (device) ------------------------ #

def to_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the int32 tensor with the same low
    32 bits (no reliance on how a narrowing cast wraps)."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def float_to_monotonic_u32(x: torch.Tensor) -> torch.Tensor:
    """Map float32 values to order-preserving uint32 images, returned as
    int32 bit patterns: ``x < y  <=>  m(x) < m(y)`` as unsigned words
    (the IEEE-754 sign-magnitude fix-up: flip every bit of a negative
    value, only the sign bit of a positive one).  Works in int64, where
    the shift and the XOR are exact.  -0.0 maps below +0.0, +NaN above
    +inf and -NaN below -inf."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & MASK32
    flip = torch.where(bits >> 31 == 1, MASK32, 1 << 31)
    return to_int32_bits(bits ^ flip)


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
