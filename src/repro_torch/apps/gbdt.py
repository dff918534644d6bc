"""GBDT (CatBoost-style oblivious tree) inference on PuD (paper
section 6.1).

One column per tree node, nodes grouped by tree and ordered by depth, so
the per-node comparison bits are the leaf address bits (depth 0 = MSB).
Per feature f with instance value v: ``cmp = Clutch(v < thresholds)``,
``acc |= cmp & mask_f``, all in-DRAM; one row readout gives every tree's
leaf address and the host sums the leaf values (:func:`assemble_leaves`,
the exact float32 expression the backends share; the card's fused path
sums them with ``gbdt_leafbits_sum`` in the same float32 order).

:class:`GbdtPudEngine` maps one instance per bank (a forest wider than a
bank spans ``col_shards`` banks an instance), so a wave of
``wave_width`` instances costs the command count of one
(:func:`gbdt_ops_per_instance`); ``clone_source`` replicates a loaded
engine's planes and masks by in-DRAM clones.  The batch pipeline lives
in :class:`repro_torch.pud.executors.GbdtBatchExecutor`; the card's
kernels compute the same leaf addresses through
:class:`repro_torch.kernels.fused_session.FusedGbdtExec`.

The reference package's ``apps/gbdt.py`` under the same names.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from repro_torch.core.clutch import ClutchEngine, clutch_op_count
from repro_torch.core.machine import (
    BankedSubarray,
    PuDArch,
    pack_bits,
    unpack_bits,
)

# Paper section 5.1 kernel chunk counts (minimum fitting a subarray).
PAPER_GBDT_CHUNKS = {8: 1, 16: 2, 32: 5}


@dataclass
class ObliviousForest:
    """Every node at depth k of tree t shares (feature_idx[t, k],
    thresholds[t, k])."""

    feature_idx: np.ndarray   # [T, D] int32  in [0, F)
    thresholds: np.ndarray    # [T, D] uint   in [0, 2^n_bits)
    leaves: np.ndarray        # [T, 2^D] float32
    n_bits: int
    num_features: int

    @property
    def num_trees(self) -> int:
        return self.feature_idx.shape[0]

    @property
    def depth(self) -> int:
        return self.feature_idx.shape[1]

    @staticmethod
    def random(num_trees: int, depth: int, num_features: int, n_bits: int,
               seed: int = 0) -> "ObliviousForest":
        rng = np.random.default_rng(seed)
        return ObliviousForest(
            feature_idx=rng.integers(0, num_features, (num_trees, depth),
                                     dtype=np.int32),
            thresholds=rng.integers(0, 1 << n_bits, (num_trees, depth),
                                    dtype=np.uint64),
            leaves=rng.normal(size=(num_trees, 1 << depth)
                              ).astype(np.float32),
            n_bits=n_bits,
            num_features=num_features,
        )


def fit_oblivious_forest(X: np.ndarray, y: np.ndarray, num_trees: int,
                         depth: int, n_bits: int, lr: float = 0.3,
                         seed: int = 0) -> ObliviousForest:
    """Tiny gradient-boosting fitter for the examples: greedy random
    (feature, quantile-threshold) per level, leaf value = mean residual.
    X must already be quantized to [0, 2^n_bits)."""
    rng = np.random.default_rng(seed)
    n, f = X.shape
    resid = y.astype(np.float64).copy()
    feat = np.zeros((num_trees, depth), np.int32)
    thr = np.zeros((num_trees, depth), np.uint64)
    leaves = np.zeros((num_trees, 1 << depth), np.float32)
    for t in range(num_trees):
        addr = np.zeros(n, np.int64)
        for k in range(depth):
            fi = int(rng.integers(0, f))
            q = float(rng.uniform(0.25, 0.75))
            th = np.uint64(np.quantile(X[:, fi], q))
            feat[t, k], thr[t, k] = fi, th
            addr = (addr << 1) | (X[:, fi] < th)
        sums = np.bincount(addr, weights=resid, minlength=1 << depth)
        cnts = np.bincount(addr, minlength=1 << depth)
        leaf = lr * sums / np.maximum(cnts, 1)
        leaves[t] = leaf.astype(np.float32)
        resid -= leaf[addr]
    return ObliviousForest(feat, thr, leaves, n_bits, f)


def assemble_leaves(leaves: np.ndarray, addrs: np.ndarray) -> np.ndarray:
    """``leaves`` [T, L] float32, ``addrs`` [B, T] -> [B] float32 sums,
    on the host.  The reference's machine and fused backends use this
    exact expression: float32 summation order is part of the bit-exact
    contract, so the port keeps it unchanged.  Over C-ordered ``addrs``
    NumPy sums each row pairwise (blocks of at most 128 trees, eight
    accumulators each); the port's fused executor sums on the card
    instead (``kernels.fused_query.gbdt_leafbits_sum``), with the same
    additions in the same tree, so its predictions are these bits."""
    t = leaves.shape[0]
    return leaves[np.arange(t)[None], addrs].sum(-1).astype(np.float32)


def reference_leaf_addrs(forest: ObliviousForest, X: np.ndarray
                         ) -> np.ndarray:
    """[B, T] int32 ground-truth leaf addresses (depth 0 bit is MSB)."""
    bits = (X[:, forest.feature_idx] <
            forest.thresholds[None])                   # [B, T, D]
    weights = 1 << np.arange(forest.depth)[::-1]
    return (bits * weights).sum(-1).astype(np.int32)


def reference_predict(forest: ObliviousForest, X: np.ndarray) -> np.ndarray:
    """Ground-truth predictions; sums the trees in another order than
    :func:`assemble_leaves`, so compare with a float32 tolerance."""
    addrs = reference_leaf_addrs(forest, X)
    return np.take_along_axis(forest.leaves, addrs.T, axis=1).sum(0
        ).astype(np.float32)


class GbdtPudEngine:
    """A bank group holding the forest's GBDT state.

    Small forests map one instance per bank; forests wider than
    ``cols_per_bank`` columns are column-sharded so one instance spans
    ``col_shards`` consecutive banks (``num_banks`` must then be a
    multiple of ``col_shards``; ``wave_width`` instances run per wave).
    Thresholds and one-hot feature masks are loaded once; :meth:`infer`
    then processes ``wave_width`` instances per broadcast wave with
    per-bank Clutch scalars.  ``device`` optionally places the group on
    a :class:`~repro_torch.core.device.PuDDevice`; ``channels`` selects the
    device placement policy (e.g. a channel index, or ``"spread"``).

    The leaf-bitmap accumulator is double-buffered (``acc_rows``): wave
    N's result row survives while wave N+1 computes into the other
    buffer, which is what lets
    :class:`repro_torch.pud.executors.GbdtBatchExecutor` defer wave N's
    readout until after wave N+1 has been issued.

    ``clone_source`` replicates an already-loaded engine's device state
    (threshold LUT planes + one-hot mask rows) via in-DRAM RowClone
    waves instead of a fresh host load -- the source must hold the same
    forest with the same sharding, and must live on the same channel of
    the same device (the executor picks sources accordingly).  After
    the fleet's FIRST host load, every further replica costs zero host
    WRITE bytes.
    """

    def __init__(self, forest: ObliviousForest, arch: PuDArch,
                 num_chunks: int | None = None, num_rows: int = 1024,
                 num_banks: int = 1, device=None,
                 cols_per_bank: int = 65536, channels=None,
                 label: str = "gbdt",
                 clone_source: "GbdtPudEngine | None" = None,
                 plan=None, torch_device=None) -> None:
        """``plan`` optionally narrows the threshold representation to a
        :class:`~repro_torch.core.encoding.ColumnPlan` (storage width inferred
        from the observed threshold range + chunk count picked by the
        representation optimizer).  Instance feature values are then
        clamped to the plan's range -- every threshold fits it, so
        ``v < threshold`` keeps its exact truth value.  ``torch_device``
        holds a standalone group's bank state (a placed group's is its
        :class:`~repro_torch.core.device.PuDDevice`'s)."""
        if device is not None:
            if device.arch is not arch:
                raise ValueError(
                    f"device arch {device.arch.value} != engine arch "
                    f"{arch.value}")
            num_rows = device.num_rows
            cols_per_bank = min(cols_per_bank, device.cols_per_bank)
        self.forest = forest
        self.arch = arch
        self.num_banks = num_banks
        t, d, f = forest.num_trees, forest.depth, forest.num_features
        n_nodes = t * d
        self.n_nodes = n_nodes
        n_cols = max(4096, 1 << (n_nodes - 1).bit_length())
        if n_cols > cols_per_bank:
            n_cols = cols_per_bank
        self.col_shards = math.ceil(n_nodes / n_cols)
        if num_banks % self.col_shards:
            raise ValueError(
                f"forest needs {self.col_shards} column shards per "
                f"instance; num_banks={num_banks} must be a multiple")
        self.wave_width = num_banks // self.col_shards
        if device is not None:
            self.sub = device.alloc_banks(num_banks, num_cols=n_cols,
                                          label=label, channels=channels,
                                          active_elems=n_nodes *
                                          self.wave_width)
        else:
            self.sub = BankedSubarray(num_banks=num_banks, num_rows=num_rows,
                                      num_cols=n_cols, arch=arch,
                                      device=torch_device)
        self.label = label
        if plan is not None and \
                int(forest.thresholds.max()) > plan.max_value:
            raise ValueError(
                f"threshold max {int(forest.thresholds.max())} overflows "
                f"the {plan.n_bits}-bit column plan")
        self.plan = plan
        if clone_source is not None and (
                clone_source.col_shards != self.col_shards
                or clone_source.sub.num_banks != num_banks
                or clone_source.sub.num_cols != n_cols):
            raise ValueError("clone source has incompatible sharding")
        # Only the native `<` is used => no complement planes needed.
        thresholds = self._shard_cols(
            forest.thresholds.reshape(-1).astype(np.uint64))
        if plan is not None:
            self.engine = ClutchEngine(
                self.sub, thresholds, forest.n_bits, plan=plan,
                support_negated=False, clamp=True,
                clone_from=None if clone_source is None
                else clone_source.engine)
        else:
            chunks = num_chunks or PAPER_GBDT_CHUNKS[forest.n_bits]
            self.engine = ClutchEngine(
                self.sub, thresholds, forest.n_bits,
                num_chunks=chunks, support_negated=False,
                clone_from=None if clone_source is None
                else clone_source.engine)
        self.num_chunks = self.engine.plan.num_chunks
        # One-hot feature mask rows (paper Fig. 12 layout).  First load
        # goes through the bulk host-write path (one vectorized store,
        # one WRITE entry per row); replicas clone the source's mask
        # rows in-DRAM instead.
        self.mask_rows = self.sub.alloc(f)
        if clone_source is not None:
            self.sub.clone_rows_from(clone_source.sub,
                                     clone_source.mask_rows,
                                     self.mask_rows, f)
        else:
            flat_feat = forest.feature_idx.reshape(-1)
            mask_bits = (flat_feat[None, :] ==
                         np.arange(f)[:, None]).astype(np.uint8)  # [F, nodes]
            self.sub.host_write_rows(
                self.mask_rows, pack_bits(self._shard_cols(mask_bits)))
        self.acc_rows = (self.sub.alloc(1), self.sub.alloc(1))
        self.acc_row = self.acc_rows[0]
        self.ops_per_instance: int | None = None

    def _shard_cols(self, rows: np.ndarray) -> np.ndarray:
        """[..., n_nodes] node-indexed data -> per-bank layout.

        With one column shard this is the broadcast layout (zero-padded
        to ``num_cols``); with ``S`` shards, slice ``s`` of the node
        axis goes to banks ``i * S + s`` (tiled over the ``wave_width``
        instances), so every bank holds exactly its node slice."""
        n_cols, s = self.sub.num_cols, self.col_shards
        pad = [(0, 0)] * (rows.ndim - 1) + [(0, s * n_cols - rows.shape[-1])]
        padded = np.pad(rows, pad)
        if s == 1:
            return padded
        shards = padded.reshape(*rows.shape[:-1], s, n_cols)
        shards = np.moveaxis(shards, -2, 0)            # [S, ..., n_cols]
        return np.tile(shards,
                       (self.wave_width,) + (1,) * (shards.ndim - 1))

    def _infer_wave(self, X: np.ndarray, buf: int = 0
                    ) -> tuple[np.ndarray, np.ndarray]:
        """One broadcast wave: compute + immediate readout (serial path)."""
        w = self._compute_wave(X, buf)
        return self._merge_wave(self._read_wave(buf), w)

    def _compute_wave(self, X: np.ndarray, buf: int = 0) -> int:
        """Record + execute one broadcast compute wave over up to
        ``wave_width`` instances into accumulator buffer ``buf``.

        X: [W, F] quantized feature values (W <= wave_width).  Returns
        W.  The command schedule is identical for every wave width:
        short waves pad with a repeat of instance 0 and discard the
        extra banks' results at merge time.
        """
        sub, forest = self.sub, self.forest
        w = X.shape[0]
        if w > self.wave_width:
            raise ValueError(
                f"wave of {w} instances > {self.wave_width} lanes")
        if w < self.wave_width:
            X = np.concatenate(
                [X, np.repeat(X[:1], self.wave_width - w, axis=0)])
        acc_row = self.acc_rows[buf]
        before = sub.trace.pud_ops
        sub.rowcopy(sub.ROW_ZERO, acc_row)        # clear the leaf bitmap
        for fi in range(forest.num_features):
            # per-bank scalar: instance value repeated over column shards
            scalars = np.repeat(np.asarray(X[:, fi], np.int64),
                                self.col_shards)
            cmp_row = self.engine.predicate(">", scalars).row
            # masked = cmp AND mask_f   (cmp already in the MAJ accumulator)
            masked = sub.maj3_into_acc(cmp_row, self.mask_rows + fi,
                                       sub.ROW_ZERO)
            # acc = acc OR masked
            merged = sub.maj3_into_acc(masked, acc_row, sub.ROW_ONE)
            sub.rowcopy(merged, acc_row)
        self.ops_per_instance = sub.trace.pud_ops - before
        return w

    def _read_wave(self, buf: int = 0) -> np.ndarray:
        """Read back buffer ``buf``'s leaf-bitmap row -> [banks, words]."""
        return self.sub.host_read_row(self.acc_rows[buf])

    def _merge_wave(self, words: np.ndarray, w: int
                    ) -> tuple[np.ndarray, np.ndarray]:
        """Host-side merge of one wave's readout: concatenate the
        column-shard partial rows, split leaf-address bits, gather and
        sum leaves.  Returns (addrs [W, T], preds [W])."""
        forest = self.forest
        bits = unpack_bits(words, self.sub.num_cols)   # [banks, n_cols]
        bits = bits.reshape(self.wave_width,
                            self.col_shards * self.sub.num_cols)
        bits = bits[:, :self.n_nodes].reshape(
            self.wave_width, forest.num_trees, forest.depth)
        weights = 1 << np.arange(forest.depth)[::-1]
        addrs = (bits * weights).sum(-1).astype(np.int32)      # [W, T]
        preds = assemble_leaves(forest.leaves, addrs)
        return addrs[:w], preds[:w]

    def infer_one(self, x: np.ndarray) -> tuple[np.ndarray, float]:
        """x: [F] quantized feature values.  Returns (leaf addresses [T],
        prediction)."""
        addrs, preds = self._infer_wave(np.asarray(x)[None, :])
        return addrs[0], float(preds[0])

    def infer(self, X: np.ndarray) -> np.ndarray:
        """Batch inference: ``wave_width`` instances per broadcast wave
        (serial readout; see
        :class:`repro_torch.pud.executors.GbdtBatchExecutor` for the async
        pipeline)."""
        X = np.asarray(X)
        if X.shape[0] == 0:
            return np.empty((0,), np.float32)
        preds = [self._infer_wave(X[i:i + self.wave_width], buf=j % 2)[1]
                 for j, i in enumerate(
                     range(0, X.shape[0], self.wave_width))]
        return np.concatenate(preds).astype(np.float32)


def gbdt_ops_per_instance(forest: ObliviousForest, chunks: int,
                          arch: PuDArch) -> int:
    """Closed-form PuD ops per instance: clear + per feature
    (compare + AND(3 or 4) + OR(3 or 4) + copy-back)."""
    per_maj = 3 if arch is PuDArch.MODIFIED else 4
    per_feature = clutch_op_count(chunks, arch) + 2 * per_maj + 1
    return 1 + forest.num_features * per_feature
