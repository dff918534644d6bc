"""GBDT (CatBoost-style oblivious tree) inference (paper section 6.1).

One column per tree node, nodes grouped by tree and ordered by depth, so
the per-node comparison bits are the leaf address bits (depth 0 = MSB).
Per feature f with instance value v: ``cmp = Clutch(v < thresholds)``,
``acc |= cmp & mask_f``; the leaf addresses come out of one bitmap and
the host sums the leaf values.

This module holds what the port needs from the reference package's
``apps/gbdt.py``: :class:`ObliviousForest`, :data:`PAPER_GBDT_CHUNKS`,
:func:`assemble_leaves` (the exact float32 expression both packages
share) and the NumPy references.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

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


def assemble_leaves(leaves: np.ndarray, addrs: np.ndarray) -> np.ndarray:
    """``leaves`` [T, L] float32, ``addrs`` [B, T] -> [B] float32 sums.
    The reference's machine and fused backends use this exact
    expression: float32 summation order is part of the bit-exact
    contract, so the port keeps it unchanged."""
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
