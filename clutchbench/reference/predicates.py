"""Predicate semantics over plain columns (the paper's section 6.2):

* ``q1``: ``x0 < f < x1``, a bitmap
* ``q2``: two ranges AND-ed, a bitmap; ``q3``: OR-ed, their count
* ``q4``: the mean of ``f_k`` over ``q2``'s rows (0.0 over none)
* ``q5``: ``avg`` = the mean of ``f_k`` over ``q3``'s rows, cut to an
  integer; the count of ``avg < f_l < min(2 avg, MAX)`` (0 where that
  range is empty)
* ``compound``: each term's rows, joined left to right by its
  connectives; the bitmap or its count

``Columns`` holds the columns as int64 tensors.  The means are exact: an
integer sum over an integer count, rounded once.  With ``bits`` below
the configuration's width (the control), every value and scalar is cut
to its low ``bits`` bits and the means are taken in float32.
"""

from __future__ import annotations

import numpy as np
import torch


class Columns:
    def __init__(self, columns: list[np.ndarray], n_bits: int, device,
                 bits: int | None = None) -> None:
        self.n_bits = n_bits
        self.bits = bits or n_bits
        self.mask = (1 << self.bits) - 1
        self.cols = [torch.from_numpy(np.asarray(c).view(np.int64)).to(
            device) & self.mask for c in columns]

    def _range(self, f: int, x0: int, x1: int) -> torch.Tensor:
        c = self.cols[f]
        return (c > (x0 & self.mask)) & (c < (x1 & self.mask)) \
            if self.bits < self.n_bits else (c > x0) & (c < x1)

    def _term(self, t: tuple) -> torch.Tensor:
        if t[0] == "q1":
            return self._range(*t[1:4])
        a, b = self._range(*t[1:4]), self._range(*t[4:7])
        return a & b if t[0] == "q2" else a | b

    def _mean(self, f: int, rows: torch.Tensor):
        """(exact mean as a float, its integer part), or the float32
        mean under the control."""
        vals = self.cols[f][rows]
        n = int(vals.numel())
        if n == 0:
            return 0.0, 0
        if self.bits < self.n_bits:
            m = float(vals.to(torch.float32).sum() / n)
            return m, int(m)
        s = int(vals.sum())
        return s / n, s // n

    def answer(self, req: tuple):
        """The request's answer: a bool tensor for a bitmap, else an int
        or a float."""
        kind = req[0]
        if kind in ("q1", "q2"):
            return self._term(req)
        if kind == "q3":
            return int(self._term(req).sum())
        if kind == "q4":
            return self._mean(req[1], self._term(("q2",) + req[2:]))[0]
        if kind == "q5":
            fl, fk = req[1], req[2]
            avg = self._mean(fk, self._term(("q3",) + req[3:]))[1]
            hi = min(2 * avg, (1 << self.n_bits) - 1)
            if avg >= hi:
                return 0
            return int(self._range(fl, avg, hi).sum())
        if kind == "compound":
            _, count, ops, terms = req
            rows = self._term(terms[0])
            for op, t in zip(ops, terms[1:]):
                rows = rows & self._term(t) if op == "and" \
                    else rows | self._term(t)
            return int(rows.sum()) if count else rows
        raise ValueError(f"unknown query {kind!r}")
