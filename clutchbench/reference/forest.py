"""Oblivious-forest inference in plain PyTorch: at level ``d`` of tree
``t`` an instance goes right when ``x[feature[t, d]] < threshold[t, d]``
(level 0 the most significant bit of the leaf address), and its
prediction is the sum of its leaves over the trees.

The sum is taken in float64 from the float32 leaves.  The control
casts the leaves to bfloat16 first (the next precision below float32)
and sums in float32.
"""

from __future__ import annotations

import numpy as np
import torch


class Forest:
    def __init__(self, feature_idx: np.ndarray, thresholds: np.ndarray,
                 leaves: np.ndarray, device, control: bool = False) -> None:
        self.device = device
        self.feat = torch.from_numpy(
            np.asarray(feature_idx, np.int64)).to(device)
        self.thr = torch.from_numpy(
            np.asarray(thresholds).astype(np.int64)).to(device)
        lv = torch.from_numpy(np.asarray(leaves, np.float32)).to(device)
        self.leaves = (lv.to(torch.bfloat16).to(torch.float32) if control
                       else lv.to(torch.float64))
        t, d = self.feat.shape
        self.weights = 1 << torch.arange(d - 1, -1, -1, device=device)
        self.tree = torch.arange(t, device=device)

    def predict(self, x: np.ndarray, block: int = 4096) -> torch.Tensor:
        """[B, F] instance values -> [B] sums (float64; float32 under the
        control), in blocks of ``block`` rows."""
        xt = torch.from_numpy(np.asarray(x).astype(np.int64)).to(
            self.device)
        out = []
        for i in range(0, xt.shape[0], block):
            xb = xt[i:i + block]
            bits = xb[:, self.feat] < self.thr              # [b, T, D]
            addr = (bits.to(torch.int64) * self.weights).sum(-1)
            out.append(self.leaves[self.tree, addr].sum(-1))
        return torch.cat(out) if out else torch.empty(0, device=self.device)
