"""Flash decode over blocks of the KV cache: the reference's
sequence-parallel decode.

Counterpart of the reference package's ``dist/sp_decode.py``.  There the
cache of the B = 1 long-context cell is sharded over the sequence, and
a ``lax.scan`` over blocks of ``_BLOCK`` keys carries a float32 online
softmax -- running max ``m``, normalizer ``l``, weighted accumulator
``acc`` -- so no [S]-sized score tensor is materialised unsharded.
Here, under a mesh (:func:`repro_torch.dist.sharding.use_mesh`) a
DTensor cache is constrained to the reference's sequence spec
``P(None, ("data", "model"), None)`` (split unevenly where it does not
divide); the new K/V row is written by the rank that holds its
position, each rank folds its own keys, and the partial ``(m, l, acc)``
are joined across the ranks with the softmax rescaling (a max and a sum
all-reduce of O(B * H * dh)).  A plain cache runs the same arithmetic
on one device, with no collective.

A Python loop over the S / 512 blocks would launch about ten kernels a
block: at a 262,144-token cache, 512 blocks in each of 32 layers, some
160k launches a decode step.  So the blocks go ``GROUP`` (64, 32,768
keys) at a time: each block's partial ``(m_b, l_b, acc_b)`` is computed
for the whole group as batched tensors, the group's partials fold into
the running ``(m, l, acc)`` with the rescaling the scan applies, and only
the groups loop (8 at 262,144 positions).  A group's keys and values
are cast to float32 (as the reference casts each block) in one pass
each, straight into the head-major layout the two batched products
read; a group bounds those copies to 128 MiB each at minitron's width,
where a whole layer's would take 1 GiB each.  Folding a group's blocks
at once, rather than one after another, changes only the float32
rounding: the tests hold the result within 1e-6 of the reference's
scan.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import P, constrain, full, is_dtensor
from repro_torch.models.layers import _softcap

_NEG = -2.0e38
_BLOCK = 512
GROUP = 64


def _f32_heads(x: torch.Tensor, kv: int, dh: int, length: int
               ) -> torch.Tensor:
    """Flat keys or values [B, T, KV*dh] as contiguous float32
    [B, KV, length, dh], zero-padded past T: one pass over ``x``."""
    b, t, _ = x.shape
    x = x.reshape(b, t, kv, dh).permute(0, 2, 1, 3)
    if length > t:
        x = F.pad(x, (0, 0, 0, length - t))
    return x.to(torch.float32, memory_format=torch.contiguous_format)


def sp_flash_decode(cfg, q: torch.Tensor, cache_k: torch.Tensor,
                    cache_v: torch.Tensor, k1: torch.Tensor,
                    v1: torch.Tensor, pos: int):
    """One-token decode against a flat KV cache, in float32 over blocks
    of ``_BLOCK`` keys (the cache padded to a whole number of them).

    q: [B, 1, H, dh]; cache_k/v: [B, S, KV*dh]; k1/v1: [B, 1, KV*dh];
    pos: the position written and attended.  Returns (attn_out
    [B, 1, H*dh] in ``q``'s dtype, cache_k, cache_v): the new K/V row is
    written into the caches in place, at ``pos`` clamped into the cache
    as ``dynamic_update_slice`` clamps it.  DTensor caches are
    constrained to the sequence spec first (the returned caches are
    those DTensors)."""
    seq_spec = P(None, ("data", "model"), None)
    cache_k = constrain(cache_k, seq_spec, allow_uneven=True)
    cache_v = constrain(cache_v, seq_spec, allow_uneven=True)
    q, k1, v1 = full(q), full(k1), full(v1)
    s_max = cache_k.shape[1]
    slot = min(max(pos, 0), s_max - 1)
    if not is_dtensor(cache_k):
        cache_k[:, slot] = k1[:, 0].to(cache_k.dtype)
        cache_v[:, slot] = v1[:, 0].to(cache_v.dtype)
        m, l, acc = _fold(cfg, q, cache_k, cache_v, pos, 0, s_max)
        return _finish(q, l, acc), cache_k, cache_v
    ck, off = _local_rows(cache_k)
    cv, _ = _local_rows(cache_v)
    if off <= slot < off + ck.shape[1]:
        ck[:, slot - off] = k1[:, 0].to(ck.dtype)
        cv[:, slot - off] = v1[:, 0].to(cv.dtype)
    m, l, acc = _fold(cfg, q, ck, cv, pos, off, s_max)
    # join the ranks' partials: rescale to the global max, then sum
    m2 = _reduce(cache_k, m, "max")
    w = torch.exp(m - m2)
    l = _reduce(cache_k, l * w, "sum")
    acc = _reduce(cache_k, acc * w[..., None], "sum")
    return _finish(q, l, acc), cache_k, cache_v


def _local_rows(cache) -> tuple[torch.Tensor, int]:
    """A sequence-sharded DTensor cache's local rows and the global
    position of the first."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset,
    )

    _, offset = compute_local_shape_and_global_offset(
        cache.shape, cache.device_mesh, cache.placements)
    return cache.to_local(), int(offset[1])


def _reduce(cache, t: torch.Tensor, op: str) -> torch.Tensor:
    """``t`` reduced by ``op`` over the mesh dimensions that shard the
    cache's sequence (the same value on the others)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    pl = [Partial(op) if isinstance(q, Shard) else Replicate()
          for q in cache.placements]
    return DTensor.from_local(t, cache.device_mesh, pl,
                              run_check=False).full_tensor()


def _finish(q: torch.Tensor, l: torch.Tensor, acc: torch.Tensor
            ) -> torch.Tensor:
    b, _, h, dh = q.shape
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(b, 1, h * dh).to(q.dtype)


def _fold(cfg, q: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor,
          pos: int, off: int, s_max: int):
    """The online softmax's ``(m, l, acc)`` [B, KV, G(, dh)] over the
    cache rows given, the first at global position ``off``; keys past
    ``pos`` or the cache's end are masked.  No rows: ``m`` at the fill,
    ``l`` and ``acc`` 0."""
    b, _, h, dh = q.shape
    kv = cfg.n_kv_heads
    g = h // kv
    rows = cache_k.shape[1]
    qg = q.reshape(b, kv, g, dh).float()
    if rows == 0:
        return (qg.new_full((b, kv, g), _NEG), qg.new_zeros((b, kv, g)),
                qg.new_zeros((b, kv, g, dh)))
    blk = min(_BLOCK, rows)
    n_blk = -(-rows // blk)
    inv_sqrt = 1.0 / math.sqrt(dh)
    m = l = acc = None
    for j0 in range(0, n_blk, GROUP):
        n = min(GROUP, n_blk - j0)
        lo, hi = j0 * blk, min((j0 + n) * blk, rows)
        kb = _f32_heads(cache_k[:, lo:hi], kv, dh, n * blk)
        vb = _f32_heads(cache_v[:, lo:hi], kv, dh, n * blk)
        idx = torch.arange(off + lo, off + lo + n * blk, device=q.device)
        valid = (idx <= pos) & (idx < off + rows) & (idx < s_max)
        s = torch.einsum("bkgd,bktd->bkgt", qg, kb) * inv_sqrt
        s = _softcap(s, cfg.attn_softcap)
        s = torch.where(valid, s, _NEG).reshape(b, kv, g, n, blk)
        mb = s.amax(-1)                                    # [B, KV, G, n]
        p = torch.exp(s - mb[..., None])
        ab = torch.einsum("bkgnt,bkntd->bkgnd", p,
                          vb.reshape(b, kv, n, blk, dh))
        # fold the group's partials into the running (m, l, acc)
        m2 = mb.amax(-1) if m is None else torch.maximum(m, mb.amax(-1))
        wb = torch.exp(mb - m2[..., None])
        lg = (p.sum(-1) * wb).sum(-1)
        ag = (ab * wb[..., None]).sum(-2)
        if m is None:
            l, acc = lg, ag
        else:
            alpha = torch.exp(m - m2)
            l = l * alpha + lg
            acc = acc * alpha[..., None] + ag
        m = m2
    return m, l, acc
