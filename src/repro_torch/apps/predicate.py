"""Predicate evaluation on PuD (paper section 6.2), sharded across banks.

The paper's queries Q1-Q5 over a table of uniformly sampled feature
columns, with :class:`PudQueryEngine` evaluating them on the PuD
machine model (Clutch or bit-serial engines per feature, WHERE-clause
bitmaps combined in-DRAM, COUNT/AVERAGE on the host) and
``reference_q1`` .. ``reference_q5`` as NumPy ground truth.  The card's
kernels evaluate the same queries through :class:`repro_torch.kernels.
fused_session.FusedTableExec`, on the layout :func:`fit_chunks` sizes.

Layout: one record per DRAM column, all features of a record in one
column; records shard across the banks of one group (bank ``b`` owns
records ``[b * cols, (b+1) * cols)``), every predicate is one broadcast
stream, and only final bitmaps leave the chip.  The async batch path
(double-buffered park rows, per-shard merge leaves and a root join, Q5's
host barrier, in-DRAM compound merges) lives in
:class:`repro_torch.pud.executors.QueryBatchExecutor`.

The reference package's ``apps/predicate.py`` under the same names.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from repro_torch.core.bitserial import BitSerialEngine
from repro_torch.core.clutch import ClutchEngine
from repro_torch.core.encoding import make_plan
from repro_torch.core.machine import (
    NUM_RESERVED,
    BankedSubarray,
    PuDArch,
    unpack_bits,
)
from repro_torch.tracing import span

from .pipeline import HostTimer


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


@dataclass
class QueryStats:
    pud_ops: int = 0
    rows_read: int = 0
    host_values_read: int = 0  # conventional-layout reads for post-processing


class PudQueryEngine:
    """All feature vectors of one table resident in one bank group,
    sharded record-wise across as many banks as the table needs.

    ``method`` is "clutch" or "bitserial"; both expose the same predicate
    API so Q1-Q5 run identically, which is how the paper compares them.
    ``device`` optionally allocates the bank group from a
    :class:`~repro_torch.core.device.PuDDevice` (engine-to-bank placement +
    device-level cost aggregation) instead of standalone state.
    """

    def __init__(self, table: Table, arch: PuDArch, method: str = "clutch",
                 num_chunks: int | None = None, num_rows: int = 1024,
                 cols_per_bank: int = 65536, device=None, channels=None,
                 label: str | None = None, plans=None,
                 torch_device=None) -> None:
        """``plans`` (clutch only): one
        :class:`~repro_torch.core.encoding.ColumnPlan` per feature for
        heterogeneous per-column representation -- narrow columns store
        fewer LUT planes and engines clamp full-width query scalars to
        each column's range.  ``None`` keeps the uniform plan (every
        column at ``table.n_bits`` with one shared chunk count).
        ``torch_device`` holds a standalone group's bank state (a
        placed group's is its :class:`~repro_torch.core.device.
        PuDDevice`'s)."""
        if device is not None:
            if device.arch is not arch:
                raise ValueError(
                    f"device arch {device.arch.value} != engine arch "
                    f"{arch.value}")
            num_rows = device.num_rows
            cols_per_bank = min(cols_per_bank, device.cols_per_bank)
        self.label = label or f"query:{method}"
        self.table = table
        self.arch = arch
        self.method = method
        records = table.num_records
        self.num_banks = max(1, math.ceil(records / cols_per_bank))
        per_bank = math.ceil(records / self.num_banks)
        n_cols = max(4096, 1 << (per_bank - 1).bit_length())
        with span("PudQueryEngine.shard"):
            self._shards = [self._shard(f, n_cols) for f in table.features]

        def make_sub():
            if device is not None:
                return device.alloc_banks(self.num_banks, num_cols=n_cols,
                                          label=self.label,
                                          channels=channels,
                                          active_elems=records)
            return BankedSubarray(num_banks=self.num_banks,
                                  num_rows=num_rows, num_cols=n_cols,
                                  arch=arch, device=torch_device)

        self.plans = None
        if method == "clutch" and plans is not None:
            plans = tuple(plans)
            if len(plans) != len(table.features):
                raise ValueError(
                    f"need one ColumnPlan per feature: got {len(plans)} "
                    f"plans for {len(table.features)} features")
            for i, (p, shard) in enumerate(zip(plans, self._shards)):
                if p.n_bits > table.n_bits:
                    raise ValueError(
                        f"column {i}: plan width {p.n_bits} exceeds the "
                        f"table's declared {table.n_bits} bits")
                mx = int(shard.max()) if shard.size else 0
                if mx > p.max_value:
                    raise ValueError(
                        f"column {i}: max value {mx} overflows the "
                        f"{p.n_bits}-bit column plan")
            self._check_plan_budget(plans, num_rows)
            self.sub = make_sub()
            shared = (self.sub.alloc(1), self.sub.alloc(1))
            self.engines = [
                ClutchEngine(self.sub, shard, table.n_bits, plan=p,
                             scratch=shared, clamp=True)
                for shard, p in zip(self._shards, plans)
            ]
            self.plans = plans
            self.num_chunks = max(p.num_chunks for p in plans)
        elif method == "clutch":
            chunks = num_chunks or PAPER_PREDICATE_CHUNKS[
                (table.n_bits, arch)]
            # The paper's chunk counts assume shared scratch rows; if a
            # configuration still exceeds the row budget, bump the chunk
            # count (paper §6.2 footnote 4: "a larger number of chunks can
            # be required to fit ... the row budget of a single subarray").
            # Row demand is computed analytically BEFORE any allocation so
            # a device-placed engine never leaks banks to failed attempts.
            chunks = self._fit_chunks(chunks, num_rows)
            self.sub = make_sub()
            shared = (self.sub.alloc(1), self.sub.alloc(1))
            self.engines = [
                ClutchEngine(self.sub, shard, table.n_bits,
                             num_chunks=chunks, scratch=shared)
                for shard in self._shards
            ]
            self.num_chunks = chunks
        elif method == "bitserial":
            self.sub = make_sub()
            self.engines = [
                BitSerialEngine(self.sub, shard, table.n_bits)
                for shard in self._shards
            ]
        else:
            raise ValueError(method)
        self._save_rows = [self.sub.alloc(1) for _ in range(4)]
        # Double-buffered park rows for the async query pipeline: query
        # N's WHERE bitmap survives here while query N+1 computes.
        self._park_rows = (self.sub.alloc(1), self.sub.alloc(1))

    def _fit_chunks(self, chunks: int, num_rows: int) -> int:
        """Smallest chunk count >= ``chunks`` whose full engine set (LUT
        planes x features, complements on Unmodified, shared scratch,
        save and park rows) fits the row budget."""
        return fit_chunks(self.table.n_bits, len(self.table.features),
                          self.arch, chunks, num_rows)

    def _check_plan_budget(self, plans, num_rows: int) -> None:
        """Heterogeneous analog of :meth:`_fit_chunks`: the summed
        per-column LUT footprints (+ complements on Unmodified, shared
        scratch, save and park rows) must fit the row budget.  The
        representation optimizer accounts with the same formula, so an
        optimizer-produced plan set never trips this."""
        budget = num_rows - NUM_RESERVED
        negated = self.arch is PuDArch.UNMODIFIED
        need = 2 + 4 + 2 + sum(p.lut_rows(negated=negated) for p in plans)
        if need > budget:
            raise MemoryError(
                f"per-column plans need {need} rows > budget {budget} "
                f"({num_rows}-row subarray)")

    def _shard(self, feature: np.ndarray, n_cols: int) -> np.ndarray:
        """[records] -> [banks, n_cols] record-wise shards, zero-padded."""
        pad = self.num_banks * n_cols - feature.shape[0]
        return np.concatenate(
            [np.asarray(feature, np.uint64), np.zeros(pad, np.uint64)]
        ).reshape(self.num_banks, n_cols)

    # ------------------------------------------------------------------ #
    def _pred(self, feat: int, op: str, x: int, save_slot: int) -> int:
        eng = self.engines[feat]
        if self.method == "clutch":
            return eng.predicate(op, x, save_to=self._save_rows[save_slot]).row
        return eng.predicate(op, x, save_to=self._save_rows[save_slot])

    def _range(self, feat: int, x0: int, x1: int, save_slot: int) -> int:
        """Bitmap of ``x0 < f < x1`` saved to a stable row.  Both predicate
        bitmaps are parked in stable rows before the AND because the MAJ3
        accumulator row is clobbered by the next predicate."""
        lo = self._pred(feat, ">", x0, 2)
        hi = self._pred(feat, "<", x1, 3)
        row = self.sub.maj3_into_acc(lo, hi, self.sub.ROW_ZERO)
        self.sub.rowcopy(row, self._save_rows[save_slot])
        return self._save_rows[save_slot]

    def _term_row(self, term: tuple, save_slot: int) -> int:
        """Evaluate ONE compound term's bitmap into a stable save row.
        ``term`` is a query wire tuple (q1: plain range; q2/q3: two
        ranges internally AND/OR-combined)."""
        kind = term[0]
        if kind == "q1":
            return self._range(term[1], term[2], term[3], save_slot)
        if kind in ("q2", "q3"):
            fi, x0, x1, fj, y0, y1 = term[1:]
            r1 = self._range(fi, x0, x1, save_slot)
            # slot 2 is predicate scratch; _range reads it before the
            # final save, so reusing it for the second range is safe.
            r2 = self._range(fj, y0, y1, 2)
            const = self.sub.ROW_ZERO if kind == "q2" else self.sub.ROW_ONE
            row = self.sub.maj3_into_acc(r1, r2, const)
            self.sub.rowcopy(row, self._save_rows[save_slot])
            return self._save_rows[save_slot]
        raise ValueError(f"unsupported compound term {kind!r}")

    def _compound(self, connectives: tuple, terms: tuple) -> int:
        """Left-associative in-DRAM combine of term bitmaps: each
        connective is one Ambit AND/OR merge (2 staging copies + 1
        merge wave), accumulator kept in save row 0.  Only the final
        row ever leaves the chip."""
        acc = self._term_row(terms[0], 0)
        for op, term in zip(connectives, terms[1:]):
            nxt = self._term_row(term, 1)
            if op == "and":
                self.sub.ambit_and(acc, nxt, self._save_rows[0])
            else:
                self.sub.ambit_or(acc, nxt, self._save_rows[0])
            acc = self._save_rows[0]
        return acc

    def _read(self, row: int) -> np.ndarray:
        """One broadcast row readout -> merged host bitmap [records]."""
        return self.merge_words(self.sub.host_read_row(row))

    def merge_words(self, words: np.ndarray) -> np.ndarray:
        """Host-side half of a readout: unpack one row's [banks, words]
        into the table-order bitmap [records]."""
        bits = unpack_bits(words, self.sub.num_cols).astype(bool)
        return bits.reshape(-1)[: self.table.num_records]

    # --------------------- pipelined submit/collect -------------------- #
    def submit(self, kind: str, params: tuple, buf: int,
               segment: str | None = None,
               after: tuple[int, ...] | None = None,
               after_host: tuple[int, ...] = ()) -> int:
        """Record (and functionally execute) one WHERE-clause bitmap
        stream, parking the result in double-buffer row ``buf`` so it
        survives the next submission.  ``kind``: ``"range"`` (x0<f<x1),
        ``"and2"`` / ``"or2"`` (two ranges combined), or ``"compound"``
        (params = (connectives, term wire tuples): every term's bitmap
        evaluated, then Ambit AND/OR merge waves combine them
        left-associatively inside the banks).  ``segment`` opens
        a labeled trace segment for the scheduler; ``after_host`` lists
        host events (recorded merges) the segment's waves must wait for
        -- the host-barrier case where this stream's scalar comes from
        an earlier readout's merge.  Returns the park row."""
        if segment is not None:
            self.sub.trace.begin_segment(segment, after=after,
                                         after_host=tuple(after_host))
        elif after is not None or after_host:
            raise ValueError("`after`/`after_host` require a `segment` "
                             "label: without a new segment the dependency "
                             "would be silently dropped")
        if kind == "range":
            fi, x0, x1 = params
            row = self._range(fi, x0, x1, 0)
        elif kind in ("and2", "or2"):
            fi, x0, x1, fj, y0, y1 = params
            r1 = self._range(fi, x0, x1, 0)
            r2 = self._range(fj, y0, y1, 1)
            const = self.sub.ROW_ZERO if kind == "and2" else self.sub.ROW_ONE
            row = self.sub.maj3_into_acc(r1, r2, const)
        elif kind == "compound":
            connectives, terms = params
            row = self._compound(connectives, terms)
        else:
            raise ValueError(f"unknown bitmap kind {kind!r}")
        park = self._park_rows[buf]
        self.sub.rowcopy(row, park)
        return park

    def read_parked(self, buf: int) -> np.ndarray:
        """Device half of collecting a parked bitmap: one row readout
        -> [banks, words] (host unpacking happens in merge_words)."""
        return self.sub.host_read_row(self._park_rows[buf])

    # --------------------------- queries ------------------------------- #
    def q1(self, fi: int, x0: int, x1: int) -> np.ndarray:
        """WHERE x0 < f_i < x1 -> bitmap."""
        return self._read(self._range(fi, x0, x1, 0))

    def q2(self, fi: int, x0: int, x1: int, fj: int, y0: int, y1: int
           ) -> np.ndarray:
        """WHERE (x0 < f_i < x1 AND y0 < f_j < y1) -> bitmap."""
        r1 = self._range(fi, x0, x1, 0)
        r2 = self._range(fj, y0, y1, 1)
        row = self.sub.maj3_into_acc(r1, r2, self.sub.ROW_ZERO)
        return self._read(row)

    def q3(self, fi: int, x0: int, x1: int, fj: int, y0: int, y1: int) -> int:
        """COUNT(WHERE (x0 < f_i < x1 OR y0 < f_j < y1))."""
        r1 = self._range(fi, x0, x1, 0)
        r2 = self._range(fj, y0, y1, 1)
        row = self.sub.maj3_into_acc(r1, r2, self.sub.ROW_ONE)
        return int(self._read(row).sum())

    def q4(self, fk: int, fi: int, x0: int, x1: int, fj: int, y0: int,
           y1: int) -> float:
        """AVERAGE(f_k) over WHERE(x0 < f_i < x1 AND y0 < f_j < y1).

        The bitmap stays in DRAM until the final read; AVERAGE runs on the
        host over the conventional-layout copy (paper: all platforms keep
        one for value retrieval)."""
        mask = self.q2(fi, x0, x1, fj, y0, y1)
        vals = self.table.features[fk][mask]
        return float(vals.mean()) if vals.size else 0.0

    _host_uid = 0

    def q5(self, fl: int, fk: int, fi: int, x0: int, x1: int, fj: int,
           y0: int, y1: int) -> int:
        """WITH avg = AVERAGE(f_k) WHERE(x0<f_i<x1 OR y0<f_j<y1)
        COUNT(WHERE avg < f_l < 2*avg).

        The phase-2 scan's bounds exist only after the host has merged
        phase 1's readout and averaged f_k, so that host work is
        recorded as a host event and phase 2 opens a segment gated on it
        -- the scheduled timeline includes the round trip."""
        r1 = self._range(fi, x0, x1, 0)
        r2 = self._range(fj, y0, y1, 1)
        row = self.sub.maj3_into_acc(r1, r2, self.sub.ROW_ONE)
        words = self.sub.host_read_row(row)
        timer = HostTimer()

        def host_average() -> int:
            vals = self.table.features[fk][self.merge_words(words)]
            return int(vals.mean()) if vals.size else 0
        avg = timer.measure(host_average)
        PudQueryEngine._host_uid += 1
        hid = self.sub.trace.add_host_event(
            f"{self.label}.q5m{PudQueryEngine._host_uid}",
            duration_ns=timer.samples_ns[-1],
            bytes_in=self.sub.num_banks * self.sub.num_cols / 8)
        self.sub.trace.begin_segment(
            f"{self.label}.q5p2.{PudQueryEngine._host_uid}",
            after_host=(hid,))
        hi = min(2 * avg, (1 << self.table.n_bits) - 1)
        if avg >= hi:
            return 0
        return int(self.q1(fl, avg, hi).sum())


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
