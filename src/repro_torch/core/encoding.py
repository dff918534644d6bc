"""Chunked temporal coding: chunk plans, per-column representations,
and the LUT planes a subarray stores.

A value ``v`` (0 <= v < 2^k) is stored as ``v`` leading ones down a
column: bit ``r`` equals ``r < v``, so ``2^k - 1`` rows form a lookup
table whose row ``a`` is the bitmap of ``a < B_i``.  n-bit operands are
split into ``C`` chunks (LSB first), each with its own table of
``2^k_j - 1`` rows, merged with one MAJ3 per chunk.

The reference package's ``core/encoding.py`` under the same names:
:class:`ChunkPlan`, :func:`make_plan` and :class:`ColumnPlan` lay LUTs
out; :func:`column_footprint_rows` and :func:`infer_n_bits` are what the
representation planner searches with, beside
:func:`min_chunks_for_budget`; :func:`load_vector`,
:func:`clone_vector` and :func:`load_binary_vector` store a vector into
a :class:`~repro_torch.core.machine.BankedSubarray`;
:func:`encode_signed` and :func:`encode_float32` map signed and float
operands onto unsigned ones, order preserved.

:func:`load_vector` computes a chunk's planes with the port's
``temporal_encode`` kernel (:mod:`repro_torch.kernels.temporal_encode`)
on the subarray's device -- the plain version for a CPU subarray --
which computes what :func:`temporal_encode_planes` + ``pack_bits`` do
on the host.  Each bank's columns are whole words, so the packed words
of the flattened ``[banks, num_cols]`` values split into banks by a
reshape.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.tracing import span

from .machine import WORD_BITS, BankedSubarray, pack_bits


@dataclass(frozen=True)
class ChunkPlan:
    """Chunk widths in bits, LSB chunk first."""

    widths: tuple[int, ...]

    @property
    def n_bits(self) -> int:
        return sum(self.widths)

    @property
    def num_chunks(self) -> int:
        return len(self.widths)

    @property
    def rows_required(self) -> int:
        return sum((1 << k) - 1 for k in self.widths)

    @property
    def shifts(self) -> tuple[int, ...]:
        """Bit offset of each chunk within the operand (LSB chunk first)."""
        out, s = [], 0
        for k in self.widths:
            out.append(s)
            s += k
        return tuple(out)

    def split_scalar(self, a: int) -> list[int]:
        """Split a scalar into per-chunk values (LSB chunk first)."""
        if not 0 <= a < (1 << self.n_bits):
            raise ValueError(f"scalar {a} out of range for {self.n_bits} bits")
        return [(a >> s) & ((1 << k) - 1)
                for s, k in zip(self.shifts, self.widths)]

    def split_vector(self, values: np.ndarray) -> list[np.ndarray]:
        values = np.asarray(values, dtype=np.uint64)
        return [((values >> np.uint64(s)) & np.uint64((1 << k) - 1))
                for s, k in zip(self.shifts, self.widths)]


def make_plan(n_bits: int, num_chunks: int) -> ChunkPlan:
    """Split ``n_bits`` into ``num_chunks`` as evenly as possible; the
    remainder bits go to the MSB-side chunks (32/5 -> (6,6,6,7,7))."""
    if not 1 <= num_chunks <= n_bits:
        raise ValueError("need 1 <= num_chunks <= n_bits")
    base, rem = divmod(n_bits, num_chunks)
    widths = [base] * (num_chunks - rem) + [base + 1] * rem
    return ChunkPlan(tuple(widths))


@functools.lru_cache(maxsize=4096)
def min_chunks_for_budget(n_bits: int, row_budget: int) -> ChunkPlan:
    """Smallest chunk count whose LUTs fit within ``row_budget`` rows
    (memoized: plans are immutable)."""
    for c in range(1, n_bits + 1):
        plan = make_plan(n_bits, c)
        if plan.rows_required <= row_budget:
            return plan
    raise ValueError(f"no plan for {n_bits} bits fits {row_budget} rows")


def column_footprint_rows(n_bits: int, num_chunks: int) -> int:
    """``(C - r)(2^b - 1) + r(2^(b+1) - 1)`` with ``b, r = divmod(n_bits,
    C)``: ``make_plan(n_bits, num_chunks).rows_required`` without
    building the plan."""
    if not 1 <= num_chunks <= n_bits:
        raise ValueError("need 1 <= num_chunks <= n_bits")
    base, rem = divmod(n_bits, num_chunks)
    return ((num_chunks - rem) * ((1 << base) - 1)
            + rem * ((1 << (base + 1)) - 1))


def infer_n_bits(values: np.ndarray, *, headroom: int = 0,
                 min_bits: int = 1) -> int:
    """Minimal storage width covering a column's observed values, plus
    ``headroom`` guard bits above the maximum's bit length (0: an exact
    fit; a later value that overflows needs a recode)."""
    if headroom < 0:
        raise ValueError("headroom must be >= 0")
    v = np.asarray(values, dtype=np.uint64)
    mx = int(v.max()) if v.size else 0
    return max(mx.bit_length() + headroom, min_bits)


@dataclass(frozen=True)
class ColumnPlan:
    """One column's representation choice: storage width + chunk count.
    Hashable on purpose: the tuple of per-column plans keys caches."""

    n_bits: int
    num_chunks: int

    def __post_init__(self) -> None:
        if not 1 <= self.num_chunks <= self.n_bits:
            raise ValueError(
                f"need 1 <= num_chunks <= n_bits, got "
                f"({self.n_bits}, {self.num_chunks})")

    @property
    def max_value(self) -> int:
        return (1 << self.n_bits) - 1

    @property
    def chunk_plan(self) -> ChunkPlan:
        return make_plan(self.n_bits, self.num_chunks)

    @property
    def rows_required(self) -> int:
        return column_footprint_rows(self.n_bits, self.num_chunks)

    def lut_rows(self, *, negated: bool = False) -> int:
        """Rows the column occupies; ``negated=True`` doubles it for the
        complement planes (MAX - B)."""
        return self.rows_required * (2 if negated else 1)


def temporal_encode_planes(chunk_values: np.ndarray, k: int) -> np.ndarray:
    """The LUT bit-planes of one chunk on the host: uint8 [..., 2^k - 1,
    N] with plane ``r`` == ``r < chunk_values`` (leading axes kept)."""
    dt = np.uint8 if k <= 8 else (np.uint16 if k <= 16 else np.uint32)
    vals = np.asarray(chunk_values).astype(dt, copy=False)
    r = np.arange((1 << k) - 1, dtype=dt)[:, None]
    return (r < vals[..., None, :]).view(np.uint8)


@dataclass
class LutLayout:
    """Where each chunk's LUT lives inside a subarray (``cp`` in Alg. 1)."""

    plan: ChunkPlan
    cp: tuple[int, ...]          # starting row index per chunk
    complement: bool = False     # planes encode (MAX - B) instead of B


def _conform_values(sub: BankedSubarray, values: np.ndarray) -> np.ndarray:
    """``values`` as [1, num_cols] or [banks, num_cols] uint64, unused
    columns zero."""
    values = np.asarray(values, dtype=np.uint64)
    if values.ndim == 1:
        values = values[None, :]
    if values.ndim != 2 or values.shape[0] not in (1, sub.num_banks):
        raise ValueError(
            f"values must be [n] or [{sub.num_banks}, n], got {values.shape}")
    if values.shape[1] > sub.num_cols:
        raise ValueError("values must fit the subarray columns")
    n = values.shape[1]
    if n < sub.num_cols:
        values = np.concatenate(
            [values,
             np.zeros((values.shape[0], sub.num_cols - n), np.uint64)],
            axis=1,
        )
    return values


def _chunk_planes(sub: BankedSubarray, chunk_vals: np.ndarray,
                 k: int):
    """Packed planes of one chunk on ``sub``'s device: ``chunk_vals``
    [banks, num_cols] -> int32 [banks, 2^k - 1, num_words], through the
    ``temporal_encode`` kernel (its plain version for a CPU subarray).
    A chunk wider than the kernel's widest is encoded on the host for a
    CPU subarray only; a card subarray raises the kernel's error."""
    from repro_torch.kernels.temporal_encode import MAX_K, temporal_encode

    if k > MAX_K:
        if sub.device.type != "cpu":
            raise ValueError(f"chunk width {k} outside [1, {MAX_K}]")
        return pack_bits(temporal_encode_planes(chunk_vals, k))
    banks = chunk_vals.shape[0]
    vals = torch.from_numpy(np.ascontiguousarray(chunk_vals, np.int32))
    words = temporal_encode(vals.to(sub.device).view(-1, WORD_BITS), k)
    return words.view((1 << k) - 1, banks, sub.num_words).transpose(0, 1)


def load_vector(
    sub: BankedSubarray,
    values: np.ndarray,
    plan: ChunkPlan,
    *,
    complement: bool = False,
) -> LutLayout:
    """Encode ``values`` ([n], broadcast to every bank, or [banks, n])
    with chunked temporal coding into freshly allocated rows of ``sub``,
    one WRITE trace entry per row.  ``complement=True`` encodes ``MAX -
    B``, from which Unmodified PuD derives the negated operators."""
    # the profiler's spans split a load: the host's chunk extraction,
    # then the upload, kernel and row writes (the device part async)
    with span("load_vector.extract"):
        values = _conform_values(sub, values)
        if complement:
            values = np.uint64((1 << plan.n_bits) - 1) - values
        wdt = np.uint32 if plan.n_bits <= 32 else np.uint64
        vals_w = values.astype(wdt, copy=False)
    cp = []
    for k, shift in zip(plan.widths, plan.shifts):
        n_planes = (1 << k) - 1
        start = sub.alloc(n_planes)
        cp.append(start)
        with span("load_vector.extract"):
            chunk_vals = (vals_w >> wdt(shift)) & wdt(n_planes)
        with span("load_vector.encode"):
            sub.host_write_rows(start, _chunk_planes(sub, chunk_vals, k))
    return LutLayout(plan=plan, cp=tuple(cp), complement=complement)


def clone_vector(sub: BankedSubarray, src_sub: BankedSubarray,
                 src_layout: LutLayout) -> LutLayout:
    """Replicate an already-loaded LUT into ``sub`` in-DRAM: the same
    per-chunk row spans :func:`load_vector` would allocate, filled by
    clone waves from ``src_sub`` (zero host bytes).  Both groups span
    the same number of banks; the layout is bit-identical."""
    plan = src_layout.plan
    cp = []
    for k, src_start in zip(plan.widths, src_layout.cp):
        n_planes = (1 << k) - 1
        start = sub.alloc(n_planes)
        cp.append(start)
        sub.clone_rows_from(src_sub, src_start, start, n_planes)
    return LutLayout(plan=plan, cp=tuple(cp),
                     complement=src_layout.complement)


def load_binary_vector(sub: BankedSubarray, values: np.ndarray,
                       n_bits: int) -> int:
    """Store plain binary bit-planes (LSB first), the bit-serial
    baseline's layout, cut and packed on ``sub``'s device; returns the
    starting row index."""
    from repro_torch.kernels.common import pack_bits_torch

    values = np.ascontiguousarray(_conform_values(sub, values))
    vals = torch.from_numpy(values.view(np.int64)).to(sub.device)
    shifts = torch.arange(n_bits, device=sub.device)[:, None]
    planes = (vals[:, None, :] >> shifts) & 1           # [banks, n_bits, N]
    start = sub.alloc(n_bits)
    sub.host_write_rows(start, pack_bits_torch(planes))
    return start


# ----------------- beyond-paper: signed / float operands ----------------- #
#
# Both maps are order-preserving bijections into unsigned ints, so the
# whole Clutch machinery applies unchanged:
#   * signed n-bit two's complement:  x  ->  x + 2^(n-1)
#   * float32:  u = bits(x);  u XOR (0xFFFFFFFF if sign else 0x80000000)

def encode_signed(values: np.ndarray, n_bits: int) -> np.ndarray:
    """Two's-complement signed -> order-preserving unsigned."""
    v = np.asarray(values, dtype=np.int64)
    lo, hi = -(1 << (n_bits - 1)), (1 << (n_bits - 1)) - 1
    if v.min() < lo or v.max() > hi:
        raise ValueError(f"values out of signed {n_bits}-bit range")
    return (v + (1 << (n_bits - 1))).astype(np.uint64)


def encode_signed_scalar(a: int, n_bits: int) -> int:
    return int(a + (1 << (n_bits - 1)))


def encode_float32(values: np.ndarray) -> np.ndarray:
    """float32 -> order-preserving uint32.  -0.0 is canonicalized to +0.0
    so the induced order matches IEEE comparisons (NaNs unsupported)."""
    v = np.asarray(values, np.float32) + np.float32(0.0)   # -0.0 -> +0.0
    if np.isnan(v).any():
        raise ValueError("NaNs are not comparable")
    bits = v.view(np.uint32).astype(np.uint64)
    sign = bits >> np.uint64(31)
    flip = np.where(sign == 1, np.uint64(0xFFFFFFFF), np.uint64(0x80000000))
    return bits ^ flip


def encode_float32_scalar(a: float) -> int:
    return int(encode_float32(np.float32([a]))[0])
