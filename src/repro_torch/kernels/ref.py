"""Plain PyTorch versions of the port's kernels.

One function per kernel, mirroring the reference package's pure-jnp
oracles: they take the same logical inputs as the wrappers, run on any
device, and are what a wrapper runs for a CPU tensor.  Words are int32
bit patterns (see :mod:`repro_torch.kernels.common`); bitwise AND/OR
and row gathers are exact on them, and popcounts go through int64.
"""

from __future__ import annotations

import functools
import sys

import numpy as np
import torch

from .common import (
    MASK32,
    float_to_monotonic_u32,
    maj3,
    pack_bits_torch,
    popcount_torch,
)


def clutch_merge_ref(lut: torch.Tensor, lt_idx, le_idx) -> torch.Tensor:
    """Algorithm 1 merge over packed bit-planes.

    ``lut`` is [..., R, W]; ``lt_idx``/``le_idx`` are [C] row indices
    (host-resolved, boundary substitutions included).  Returns the
    [..., W] bitmap of ``a < B``; ``le_idx[0]`` is never read."""
    acc = lut[..., int(lt_idx[0]), :]
    for j in range(1, len(lt_idx)):
        acc = maj3(acc, lut[..., int(lt_idx[j]), :],
                   lut[..., int(le_idx[j]), :])
    return acc


def clutch_merge_banked_ref(lut: torch.Tensor, lt_idx,
                            le_idx) -> torch.Tensor:
    """Per-bank Algorithm 1 merge: ``lut`` [B, R, W], ``lt_idx`` /
    ``le_idx`` [B, C] per-bank row indices.  Returns [B, W]; the bank
    axis is a gather dimension instead of a Python loop."""
    lt = torch.as_tensor(lt_idx).to(device=lut.device, dtype=torch.int64)
    le = torch.as_tensor(le_idx).to(device=lut.device, dtype=torch.int64)
    banks = torch.arange(lut.shape[0], device=lut.device)
    acc = lut[banks, lt[:, 0]]
    for j in range(1, lt.shape[1]):
        acc = maj3(acc, lut[banks, lt[:, j]], lut[banks, le[:, j]])
    return acc


def fused_range_count_ref(lut: torch.Tensor, lut_c: torch.Tensor, idx,
                          num_chunks: int
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused ``x0 < B < x1``: the gt-side merge on the normal LUT, the
    lt-side on the complement LUT, AND, plus popcount.  ``idx`` is [4C]
    (gt_lt, gt_le, lt_lt, lt_le).  Returns (bitmap [W], count: 0-d
    int64)."""
    idx = torch.as_tensor(idx).tolist()
    c = num_chunks
    bm = clutch_merge_ref(lut, idx[:c], idx[c:2 * c]) & \
        clutch_merge_ref(lut_c, idx[2 * c:3 * c], idx[3 * c:])
    return bm, popcount_torch(bm).sum()


def bitserial_cmp_ref(planes: torch.Tensor, a: int,
                      n_bits: int) -> torch.Tensor:
    """Borrow-chain bit-serial baseline: ``planes`` [n_pad, W] (LSB
    plane first), ``a`` a uint32 scalar of which only the low ``n_bits``
    bits are read.  Returns the [W] bitmap of ``a < B``."""
    borrow = torch.zeros_like(planes[0])
    for i in range(n_bits):
        not_a = 0 if (a >> i) & 1 else -1      # all ones as int32 bits
        borrow = maj3(not_a, planes[i], borrow)
    return borrow


def leaf_gather_ref(addrs: torch.Tensor, leaves: torch.Tensor
                    ) -> torch.Tensor:
    """GBDT leaf aggregation: ``addrs`` [B, T] int32, ``leaves`` [T, L]
    float32.  Returns [B] float32, the sum over trees of ``leaves[t,
    addrs[b, t]]``; an address outside ``[0, L)`` adds 0."""
    t, nl = leaves.shape
    a = addrs.to(torch.int64)
    vals = leaves[torch.arange(t, device=leaves.device), a.clamp(0, nl - 1)]
    return torch.where((a >= 0) & (a < nl), vals, 0.0).sum(-1)


def temporal_encode_ref(chunk_vals: torch.Tensor, k: int) -> torch.Tensor:
    """[N] chunk values -> [2^k - 1, ceil(N/32)] packed planes, plane
    ``r`` bit ``i`` == ``r < v_i``."""
    r = torch.arange((1 << k) - 1, dtype=torch.int64,
                     device=chunk_vals.device)[:, None]
    planes = (r < chunk_vals.to(torch.int64)[None, :]).to(torch.uint8)
    return pack_bits_torch(planes)


def _range_bm(lut, idx, c: int, rix: int) -> torch.Tensor:
    o = rix * 4 * c
    gt = clutch_merge_ref(lut, idx[o:o + c], idx[o + c:o + 2 * c])
    lt = clutch_merge_ref(lut, idx[o + 2 * c:o + 3 * c],
                          idx[o + 3 * c:o + 4 * c])
    return gt & lt


def fused_compound_banked_ref(lut: torch.Tensor, idx, num_chunks: int,
                              term_ranges: tuple, term_disj: tuple,
                              conn_disj: tuple
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Compound predicate over a sharded LUT ``[S, R, W]``: each term's
    ranges combined with its own AND/OR (``term_disj``), then the term
    bitmaps folded left to right through ``conn_disj`` (True = OR).
    ``idx`` holds every range's (gt_lt, gt_le, lt_lt, lt_le) indices in
    term order.  Returns (bitmap [S, W], per-shard popcount [S] int64)."""
    idx = torch.as_tensor(idx).tolist()
    c = num_chunks
    rix = 0
    acc = None
    for t, (nr, disj) in enumerate(zip(term_ranges, term_disj)):
        tb = _range_bm(lut, idx, c, rix)
        rix += 1
        for _ in range(1, nr):
            nxt = _range_bm(lut, idx, c, rix)
            rix += 1
            tb = (tb | nxt) if disj else (tb & nxt)
        acc = tb if acc is None else (
            (acc | tb) if conn_disj[t - 1] else (acc & tb))
    return acc, popcount_torch(acc).sum(dim=-1)


def fused_predicate_banked_ref(lut: torch.Tensor, idx, num_chunks: int,
                               num_ranges: int, disjunction: bool = False
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """1-2 range predicates (AND or OR) over a sharded LUT ``[S, R, W]``:
    the one-term compound."""
    return fused_compound_banked_ref(lut, idx, num_chunks, (num_ranges,),
                                     (disjunction,), ())


def gbdt_leafbits_banked_ref(lut: torch.Tensor, masks: torch.Tensor,
                             idx: torch.Tensor, num_chunks: int,
                             num_features: int) -> torch.Tensor:
    """Leaf-address bitmaps: ``lut`` [R, W] threshold planes, ``masks``
    [F_pad, W] one-hot feature masks, ``idx`` [B, F * 2C] per-instance
    (lt, le) row indices per feature.  Returns [B, W]; the batch axis is
    a gather dimension instead of a Python loop."""
    c = num_chunks
    idx = idx.to(device=lut.device, dtype=torch.int64)
    acc = torch.zeros((idx.shape[0], lut.shape[1]), dtype=lut.dtype,
                      device=lut.device)
    for f in range(num_features):
        o = f * 2 * c
        cmp = lut[idx[:, o]]
        for j in range(1, c):
            cmp = maj3(cmp, lut[idx[:, o + j]], lut[idx[:, o + c + j]])
        acc |= cmp & masks[f]
    return acc


def _pairwise_sum(a: torch.Tensor) -> torch.Tensor:
    """Float32 sums of the rows of ``a`` [B, n] in NumPy's pairwise
    order (``pairwise_sum`` of its umath loops): below 8 elements left
    to right from 0; up to 128, eight accumulators over strides of 8,
    combined ``((r0 + r1) + (r2 + r3)) + ((r4 + r5) + (r6 + r7))``,
    then the ``n % 8`` tail in order; beyond, the two halves split at
    ``n // 2`` rounded down to a multiple of 8, summed apart and
    added."""
    n = a.shape[1]
    if n < 8:
        res = torch.zeros(a.shape[0], dtype=a.dtype, device=a.device)
        for i in range(n):
            res = res + a[:, i]
        return res
    if n <= 128:
        r = a[:, :8]
        for i in range(8, n - n % 8, 8):
            r = r + a[:, i:i + 8]
        res = ((r[:, 0] + r[:, 1]) + (r[:, 2] + r[:, 3])) + \
            ((r[:, 4] + r[:, 5]) + (r[:, 6] + r[:, 7]))
        for i in range(n - n % 8, n):
            res = res + a[:, i]
        return res
    n2 = n // 2
    n2 -= n2 % 8
    return _pairwise_sum(a[:, :n2]) + _pairwise_sum(a[:, n2:])


def numpy_row_run(n: int) -> int:
    """How many values of a C-ordered float32 row of ``n`` NumPy's
    ``.sum(-1)`` takes at a time: the whole row, or, where its iterator
    buffers a row longer than ``np.getbufsize()`` (NumPy 2.0 does, 2.3
    does not), the buffer, each buffer's pairwise sum added in turn.
    Which, a probe of this NumPy tells, once per buffer size."""
    bufsize = np.getbufsize()
    return max(n, 1) if n <= bufsize else _probe_run(bufsize)


@functools.lru_cache(maxsize=8)
def _probe_run(bufsize: int) -> int:
    n = 2 * bufsize + 136
    rng = np.random.default_rng(0)
    row = (rng.normal(size=(8, n)) * 10.0 ** rng.uniform(-3, 3, (8, n))
           ).astype(np.float32)
    want, vals = row.sum(-1).tobytes(), torch.from_numpy(row)
    for run in (bufsize, sys.maxsize):
        res = torch.zeros(8)
        for t0 in range(0, n, run):
            res = res + _pairwise_sum(vals[:, t0:t0 + run])
        if res.numpy().tobytes() == want:
            return run
    raise RuntimeError(f"NumPy {np.__version__} sums a float32 row of "
                       f"{n} values in neither known order")


def gbdt_leafbits_sum_ref(bm: torch.Tensor, leaves: torch.Tensor,
                          trees: int, depth: int) -> torch.Tensor:
    """GBDT predictions from leaf-address bitmaps: ``bm`` [B, W] int32
    (node ``n = t * depth + d`` at word ``n // 32``, bit ``n % 32``),
    ``leaves`` [trees, L] float32.  Tree ``t``'s address is ``sum_d
    bit(t, d) << (depth - 1 - d)``; returns [B] float32, the sum of
    ``leaves[t, addr_t]`` over the trees as NumPy's ``.sum(-1)`` takes
    it, so the bits of ``assemble_leaves`` over the same addresses held
    C-ordered: from 0, each run of trees (:func:`numpy_row_run`) added
    in turn as its pairwise sum (:func:`_pairwise_sum`)."""
    nodes = torch.arange(trees * depth, device=bm.device)
    bits = (bm[:, nodes // 32].to(torch.int64) >> (nodes % 32)) & 1
    weights = 1 << torch.arange(depth - 1, -1, -1, device=bm.device)
    addrs = (bits.view(bm.shape[0], trees, depth) * weights).sum(-1)
    vals = leaves[torch.arange(trees, device=bm.device), addrs]
    run = numpy_row_run(trees)
    res = torch.zeros(bm.shape[0], dtype=leaves.dtype, device=bm.device)
    for t0 in range(0, trees, run):
        res = res + _pairwise_sum(vals[:, t0:t0 + run])
    return res


MINP_FILL = -1e30


def minp_mask_ref(logits: torch.Tensor, tau: torch.Tensor,
                  chunks: tuple[int, ...] = (8, 8, 8, 8)) -> torch.Tensor:
    """Min-p logit mask as the TPU kernel computes it: ``logits`` [B, V]
    and ``tau`` [B] float32 are mapped to order-preserving uint32 images
    (:func:`float_to_monotonic_u32`) and compared chunk by chunk with the
    Clutch recurrence ``acc = lt | (le & acc)``, LSB chunk first; a logit
    is kept where ``acc | (xu == tu)``, i.e. ``m(x) >= m(tau)``, and
    replaced by ``MINP_FILL`` (-1e30) elsewhere.

    This differs from the float comparison (:func:`minp_mask_float_ref`)
    in two places only: a logit -0.0 against tau +0.0 is dropped here
    (kept there), and a logit +NaN is kept here (dropped there); against
    a tau that is not NaN, a -NaN is dropped by both."""
    xu = float_to_monotonic_u32(logits).to(torch.int64) & MASK32
    tu = (float_to_monotonic_u32(tau).to(torch.int64) & MASK32)[:, None]
    shift, acc = 0, None
    for k in chunks:
        mask = (1 << k) - 1
        xc, tc = (xu >> shift) & mask, (tu >> shift) & mask
        lt = tc < xc
        acc = lt if acc is None else lt | ((tc <= xc) & acc)
        shift += k
    return torch.where(acc | (xu == tu), logits, MINP_FILL)


def minp_mask_float_ref(logits: torch.Tensor, tau: torch.Tensor
                        ) -> torch.Tensor:
    """The reference package's float oracle: keep ``logits >= tau[:,
    None]``.  It agrees with :func:`minp_mask_ref` bit for bit except on
    a logit -0.0 against tau +0.0 (kept here) and a logit +NaN (dropped
    here)."""
    return torch.where(logits >= tau[:, None], logits, MINP_FILL)


def mamba_scan_ref(da: torch.Tensor, dbx: torch.Tensor, c: torch.Tensor,
                   h: torch.Tensor | None):
    """The selective scan's recurrence, one time step after another:
    ``h_t = da_t * h_{t-1} + dbx_t``, ``y_t = h_t . C_t``, over ``da`` /
    ``dbx`` [B, S, din, N] and ``c`` [B, S, N] float32 from ``h`` [B,
    din, N] (zeros if None).  Returns (y [B, S, din] float32, final h)."""
    from repro_torch.models.loops import repeat

    b, s, din, n = da.shape
    if h is None:
        h = da.new_zeros((b, din, n))

    def step(t):
        nonlocal h
        h = da[:, t] * h + dbx[:, t]                   # [B, din, N]
        return torch.einsum("bdn,bn->bd", h, c[:, t])

    return torch.stack(repeat(s, step), dim=1), h


def selective_scan_ref(x: torch.Tensor, dt: torch.Tensor, z: torch.Tensor,
                       b: torch.Tensor, c: torch.Tensor, a_log: torch.Tensor,
                       d: torch.Tensor, dt_bias: torch.Tensor,
                       state: torch.Tensor | None = None):
    """Mamba-1's selective scan as :func:`repro_torch.models.ssm.
    mamba_block` computes it on the host: ``x`` (the convolved input),
    ``dt`` (the step's pre-activation, before its bias) and ``z`` (the
    gate) [B, S, din] and ``b``, ``c`` [B, S, N] in the activations'
    dtype; ``a_log`` [din, N], ``d`` and ``dt_bias`` [din]; ``state``
    [B, din, N] float32 or None (zeros).

        delta = softplus(dt + dt_bias)   (in x's dtype, then float32)
        h_t   = exp(delta_t A) h_{t-1} + delta_t x_t B_t,  A = -exp(a_log)
        y_t   = (h_t . C_t + D x_t) silu(z_t)

    The recurrence runs in float32 over ``[B, S, din, N]`` tensors of
    ``exp(delta A)`` and ``delta x B`` (:func:`mamba_scan_ref`); its
    output is rounded to x's dtype before the ``D`` term and the gate,
    which run in that dtype.  Returns (y [B, S, din] in x's dtype, the
    final state [B, din, N] float32)."""
    delta = torch.nn.functional.softplus(dt + dt_bias.to(x.dtype)).float()
    a = -torch.exp(a_log.float())                      # [din, N]
    da = torch.exp(delta[..., None] * a)               # [B, S, din, N]
    dbx = (delta * x.float())[..., None] * b.float()[:, :, None, :]
    y, h = mamba_scan_ref(da, dbx, c.float(), state)
    y = y.to(x.dtype) + x * d.to(x.dtype)
    return y * torch.nn.functional.silu(z), h


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, eps: float
                ) -> torch.Tensor:
    """The port's RMS norm: ``x * rsqrt(mean(x^2) + eps) * (1 + scale)``
    over the last axis in float32, rounded to x's dtype; ``scale``
    broadcasts against x's trailing axes."""
    dt = x.dtype
    x32 = x.float()
    x32 = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return (x32 * (1.0 + scale.float())).to(dt)
