"""Plain PyTorch versions of the port's kernels.

One function per kernel, mirroring the reference package's pure-jnp
oracles: they take the same logical inputs as the wrappers, run on any
device, and are what a wrapper runs for a CPU tensor.  Words are int32
bit patterns (see :mod:`repro_torch.kernels.common`); bitwise AND/OR
and row gathers are exact on them, and popcounts go through int64.
"""

from __future__ import annotations

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
