"""Carry state across from plain NumPy arrays and ints.

The port shares no objects with the reference package: a caller holding
the reference's table, forest or plans reads their NumPy fields and
passes them here, and gets the port's own objects back.  Word arrays
cross as bit patterns: a ``uint32`` array becomes an int32 tensor with
the same bits, and back.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.apps.gbdt import ObliviousForest
from repro_torch.apps.predicate import Table
from repro_torch.core.encoding import ColumnPlan


def table(n_bits: int, features) -> Table:
    """The port's :class:`Table` over copies of ``features``."""
    return Table(n_bits=int(n_bits),
                 features=[np.array(f, np.uint64) for f in features])


def forest(feature_idx, thresholds, leaves, n_bits: int,
           num_features: int) -> ObliviousForest:
    """The port's :class:`ObliviousForest` over copies of the arrays."""
    return ObliviousForest(
        feature_idx=np.array(feature_idx, np.int32),
        thresholds=np.array(thresholds, np.uint64),
        leaves=np.array(leaves, np.float32),
        n_bits=int(n_bits), num_features=int(num_features))


def column_plan(n_bits: int, num_chunks: int) -> ColumnPlan:
    return ColumnPlan(int(n_bits), int(num_chunks))


def words_to_torch(words: np.ndarray, device="cpu") -> torch.Tensor:
    """``uint32`` words -> int32 tensor with the same bits."""
    arr = np.ascontiguousarray(words, dtype=np.uint32)
    return torch.from_numpy(arr.view(np.int32).copy()).to(device)


def words_to_numpy(words: torch.Tensor) -> np.ndarray:
    """int32 tensor -> ``uint32`` array with the same bits."""
    return words.detach().cpu().numpy().view(np.uint32)
