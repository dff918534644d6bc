"""Plain PyTorch versions of the port's kernels.

One function per kernel, mirroring the reference package's pure-jnp
oracles: they take the same logical inputs as the wrappers, run on any
device, and are what a wrapper runs for a CPU tensor.  Words are int32
bit patterns (see :mod:`repro_torch.kernels.common`); bitwise AND/OR
and row gathers are exact on them, and popcounts go through int64.
"""

from __future__ import annotations

import torch

from .common import maj3, pack_bits_torch, popcount_torch


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
