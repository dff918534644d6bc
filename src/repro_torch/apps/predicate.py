"""Predicate evaluation (paper section 6.2): the table, the paper's chunk
counts, and the NumPy ground truth of Q1-Q5.

The port evaluates queries with :class:`repro_torch.kernels.fused_session.
FusedTableExec`; this module holds what that needs from the reference
package's ``apps/predicate.py``: the :class:`Table` with its overflow
check, :data:`PAPER_PREDICATE_CHUNKS`, the analytic row-budget chunk fit
(:func:`fit_chunks`), and ``reference_q1`` .. ``reference_q5``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.encoding import make_plan
from repro_torch.core.machine import NUM_RESERVED, PuDArch


@dataclass
class Table:
    """Benchmark table: ``features[f][i]`` = feature f of record i,
    sampled uniformly from [0, 2^n_bits) by :meth:`generate`."""

    n_bits: int
    features: list[np.ndarray]

    def __post_init__(self) -> None:
        # reject values the encoder would otherwise silently wrap
        limit = 1 << self.n_bits
        for i, f in enumerate(self.features):
            f = np.asarray(f)
            if not f.size:
                continue
            mn, mx = int(f.min()), int(f.max())
            if mn < 0 or mx >= limit:
                raise ValueError(
                    f"column {i}: values span [{mn}, {mx}], which "
                    f"overflows the declared {self.n_bits}-bit width "
                    f"(representable range [0, {limit - 1}])")

    @property
    def num_records(self) -> int:
        return int(self.features[0].shape[0])

    @staticmethod
    def generate(num_records: int, n_bits: int, num_features: int = 8,
                 seed: int = 0) -> "Table":
        rng = np.random.default_rng(seed)
        return Table(
            n_bits=n_bits,
            features=[
                rng.integers(0, 1 << n_bits, num_records, dtype=np.uint64)
                for _ in range(num_features)
            ],
        )


# Chunk counts per paper section 6.2 so all 8 features (+complements on
# Unmodified) fit one 1024-row subarray.
PAPER_PREDICATE_CHUNKS = {
    (8, PuDArch.MODIFIED): 2,
    (8, PuDArch.UNMODIFIED): 2,
    (16, PuDArch.MODIFIED): 4,
    (16, PuDArch.UNMODIFIED): 4,
    (32, PuDArch.MODIFIED): 8,
    (32, PuDArch.UNMODIFIED): 12,
}


def fit_chunks(n_bits: int, num_features: int, arch: PuDArch, chunks: int,
               num_rows: int = 1024) -> int:
    """Smallest chunk count >= ``chunks`` whose LUT planes (x features,
    complements on Unmodified) plus the reference engine's shared
    scratch, save and park rows fit a ``num_rows``-row subarray: the
    reference's ``PudQueryEngine._fit_chunks``, so both packages lay a
    table out with the same chunk count."""
    budget = num_rows - NUM_RESERVED
    mult = 2 if arch is PuDArch.UNMODIFIED else 1
    while True:
        need = 2 + 4 + 2 + num_features * mult * \
            make_plan(n_bits, chunks).rows_required
        if need <= budget:
            return chunks
        chunks += 1
        if chunks > n_bits:
            raise MemoryError(
                f"no chunking of {n_bits}-bit features fits "
                f"{num_rows} rows for {num_features} features")


# ------------------------- NumPy ground truth -------------------------- #

def reference_q1(t: Table, fi, x0, x1):
    f = t.features[fi]
    return (f > x0) & (f < x1)


def reference_q2(t: Table, fi, x0, x1, fj, y0, y1):
    return reference_q1(t, fi, x0, x1) & reference_q1(t, fj, y0, y1)


def reference_q3(t: Table, fi, x0, x1, fj, y0, y1):
    return int((reference_q1(t, fi, x0, x1)
                | reference_q1(t, fj, y0, y1)).sum())


def reference_q4(t: Table, fk, fi, x0, x1, fj, y0, y1):
    mask = reference_q2(t, fi, x0, x1, fj, y0, y1)
    vals = t.features[fk][mask]
    return float(vals.mean()) if vals.size else 0.0


def reference_q5(t: Table, fl, fk, fi, x0, x1, fj, y0, y1):
    mask = (reference_q1(t, fi, x0, x1) | reference_q1(t, fj, y0, y1))
    vals = t.features[fk][mask]
    avg = int(vals.mean()) if vals.size else 0
    hi = min(2 * avg, (1 << t.n_bits) - 1)
    if avg >= hi:
        return 0
    return int(reference_q1(t, fl, avg, hi).sum())
