"""The yardstick: the least time the chip could take for a window's
work, counted from the requests alone.

Nothing here reads the program.  The chunk arithmetic is a frozen copy
of Clutch's Algorithm 1 (paper section 4) at the table's declared chunk
plan: a comparison ``a < B`` over ``C`` chunks reads, per chunk ``j``,
the ``lt`` row of the scalar's chunk value and, for ``j > 0``, its
``le`` row; a row whose chunk value sits at the chunk's edge is a
constant (all zeros or all ones), which need not be read at all.
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM data sheet: HBM3 bytes/s, and the float32 rate outside
# the tensor cores, the highest non-tensor rate, used for the integer
# logic of these jobs, so the bound stays a lower bound
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
# the same data sheet (as the port's launch/roofline.py states it): dense
# bfloat16 on the tensor cores, the rate of a language model's products
PEAK_BF16_FLOPS_S = 989e12


def chunk_widths(n_bits: int, chunks: int) -> list[int]:
    """``n_bits`` split into ``chunks`` LSB first, the remainder bits on
    the most significant chunks (32 over 5: 6, 6, 6, 7, 7)."""
    base, rem = divmod(n_bits, chunks)
    return [base] * (chunks - rem) + [base + 1] * rem


def side_rows(a: int, widths: list[int]) -> set[tuple[int, int]]:
    """The non-constant LUT rows, as ``(chunk, row)``, that one
    comparison against the scalar ``a`` reads."""
    rows, shift = set(), 0
    for j, k in enumerate(widths):
        c = (a >> shift) & ((1 << k) - 1)
        if c != (1 << k) - 1:           # lt row; all zeros at the top
            rows.add((j, c))
        if j > 0 and c != 0:            # le row; all ones at zero
            rows.add((j, c - 1))
        shift += k
    return rows


def range_rows(x0: int, x1: int, n_bits: int, chunks: int
               ) -> set[tuple[str, int, int]]:
    """Rows read for ``x0 < f < x1``: ``f > x0`` on the values' planes,
    ``f < x1`` as ``MAX - x1 < MAX - f`` on the complement's planes
    (all true, so nothing read, when ``x1 > MAX``)."""
    widths, mx = chunk_widths(n_bits, chunks), (1 << n_bits) - 1
    rows = {("n",) + r for r in side_rows(min(x0, mx), widths)}
    if x1 <= mx:
        rows |= {("c",) + r for r in side_rows(mx - x1, widths)}
    return rows


def _ranges(req: tuple) -> list[tuple[int, int, int]]:
    """The ``(column, x0, x1)`` scans a query request evaluates on the
    card before any host finish."""
    kind = req[0]
    if kind == "q1":
        return [req[1:4]]
    if kind in ("q2", "q3"):
        return [req[1:4], req[4:7]]
    if kind == "q4":
        return [req[2:5], req[5:8]]
    if kind == "q5":
        return [req[3:6], req[6:9]]
    if kind == "compound":
        return [r for t in req[3] for r in _ranges(t)]
    raise ValueError(f"unknown query {kind!r}")


def returns_bitmap(req: tuple) -> bool:
    return req[0] in ("q1", "q2") or (req[0] == "compound" and not req[1])


def query_bytes(req: tuple, records: int, n_bits: int, chunks: int
                ) -> float:
    """Least bytes a query moves: for each column it scans, the lesser
    of the distinct non-constant LUT rows Algorithm 1 reads (a row is
    one bit a record) and the column's values at the declared width;
    then its result written once, a bitmap or one 8-byte scalar.  Not
    counted, since they depend on the data: the values a Q4/Q5 average
    reads and Q5's second scan, whose scalars are that average."""
    by_col: dict[int, set] = {}
    for f, x0, x1 in _ranges(req):
        by_col.setdefault(f, set()).update(range_rows(x0, x1, n_bits,
                                                      chunks))
    row_bytes = records / 8
    col_bytes = records * n_bits / 8
    total = sum(min(len(rows) * row_bytes, col_bytes)
                for rows in by_col.values())
    return total + (row_bytes if returns_bitmap(req) else 8)


def predict_work(batch: int, trees: int, depth: int, features: int,
                 n_bits: int) -> tuple[float, float]:
    """(bytes, operations) of scoring ``batch`` instances: the instances,
    the forest's thresholds, feature indices and float32 leaves read
    once, the float32 predictions written once; a comparison per
    instance, tree and level, and an add per instance and tree."""
    val_bytes = math.ceil(n_bits / 8)
    idx_bytes = math.ceil(max(1, (features - 1).bit_length()) / 8)
    nbytes = (batch * features * val_bytes
              + trees * depth * (val_bytes + idx_bytes)
              + trees * (1 << depth) * 4 + batch * 4)
    ops = batch * trees * depth + batch * trees
    return float(nbytes), float(ops)


def least_seconds(nbytes: float, ops: float) -> float:
    """The larger of the byte bound and the operation bound."""
    return max(nbytes / PEAK_BYTES_S, ops / PEAK_OPS_S)


class DecoderWork:
    """The least work of a decoder language model's serving calls,
    counted from the sizes of the tensors built for it, whatever its
    family:

    * every weight is read once a call (a prefill, or a decode step of
      all slots), but a lookup table, of which only the rows of the
      call's tokens are read;
    * a cache leaf with a sequence axis is read up to each slot's
      position, and a prefill writes its rows; any other cache leaf is
      read and written whole for each slot;
    * float32 logits are written once, a row each position asked for;
    * 2 FLOPs a weight of every product and token (the head's tokens
      only those whose logits are asked for), plus attention's two
      products, 2 * n_heads * d_head FLOPs a (query, key) pair for each
      sequence leaf and layer.

    ``weights``: ``(name, shape, bytes a element)``; ``cache``: the
    same for a cache of ``slots`` slots of ``max_len`` positions, each
    leaf ``[layers, slots, ...]``."""

    def __init__(self, weights: list, lookup, last_only, cache: list,
                 slots: int, max_len: int, n_heads: int, d_head: int
                 ) -> None:
        self.weight_bytes = self.row_bytes = 0.0
        self.flops_token = self.flops_last = 0.0
        self.logit_row_bytes = 0.0
        for name, shape, size in weights:
            n = math.prod(shape)
            if name in lookup:
                self.row_bytes += shape[-1] * size
                continue
            self.weight_bytes += n * size
            if len(shape) < 2:
                continue
            if name in last_only:
                self.flops_last += 2 * n
                self.logit_row_bytes += shape[-1] * 4
            else:
                self.flops_token += 2 * n
        self.pos_bytes = self.state_bytes = self.flops_pair = 0.0
        for _, shape, size in cache:
            if len(shape) >= 3 and shape[2] == max_len:
                per_pos = math.prod(shape) / (slots * max_len)
                self.pos_bytes += per_pos * size
                self.flops_pair += 2 * n_heads * d_head * shape[0]
            else:
                self.state_bytes += math.prod(shape) / slots * size

    def prefill(self, tokens: int) -> float:
        """Least seconds of one sequence's prefill of ``tokens``, with
        the logits of its last position."""
        nbytes = (self.weight_bytes + tokens * self.row_bytes
                  + tokens * self.pos_bytes + self.state_bytes
                  + self.logit_row_bytes)
        flops = (self.flops_token * tokens + self.flops_last
                 + self.flops_pair * tokens * (tokens + 1) / 2)
        return max(nbytes / PEAK_BYTES_S, flops / PEAK_BF16_FLOPS_S)

    def decode(self, slots: int, positions: int) -> float:
        """Least seconds of one decode step of ``slots`` sequences whose
        attended positions, each slot's own, sum to ``positions``."""
        nbytes = (self.weight_bytes + slots * self.row_bytes
                  + positions * self.pos_bytes + 2 * slots * self.state_bytes
                  + slots * self.logit_row_bytes)
        flops = ((self.flops_token + self.flops_last) * slots
                 + self.flops_pair * positions)
        return max(nbytes / PEAK_BYTES_S, flops / PEAK_BF16_FLOPS_S)
