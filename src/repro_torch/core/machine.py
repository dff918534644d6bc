"""A command-level model of a Processing-using-DRAM subarray, kept as the
planner's cost oracle.

The port runs every job on the card; nothing here computes a query or an
inference.  :func:`repro_torch.pud.planner.choose_representation` prices
each candidate ``(n_bits, num_chunks)`` by running one representative
predicate on a tiny :class:`BankedSubarray`, recording its command
stream (:class:`CommandTrace`) and scheduling it with
:class:`repro_torch.core.scheduler.ChannelScheduler`.  This module holds
the part of the reference package's ``core/machine.py`` that the probe
reaches, under the reference's names:

* ``PuDArch.MODIFIED`` (SIMDRAM/Ambit: triple-row activation among the
  compute rows ``T0..T2``, a dual-contact row ``DCC0`` for NOT) and
  ``PuDArch.UNMODIFIED`` (COTS DRAM: a 4-row activation ``APA`` over the
  fixed group ``G0..G3`` armed by ``FRAC``; no NOT).
* The trace types: one :class:`TraceEntry` per broadcast wave, tagged
  with a :class:`Segment` id (waves of a segment chain; a segment waits
  for its ``after`` segments and ``after_host`` :class:`HostEvent` s).
* :class:`BankedSubarray` with the primitives Algorithm 1 and the probe
  issue: ``alloc``, host row writes and reads, ``rowcopy``, ``bulk_not``,
  ``tra``, ``frac``, ``apa`` and ``maj3_into_acc``.

Left out: the RowClone/Ambit/PULSAR bulk-movement methods, ``replay``,
the single-bank ``Subarray`` view and the pudlint metadata.
:data:`PuDOp` keeps every wave kind, since the cost tables key on them.
``PuDArch`` and ``NUM_RESERVED`` also remain the layout parameters of
:class:`repro_torch.pud.PudSession`.
"""

from __future__ import annotations

import enum
import sys
from dataclasses import dataclass, field
from typing import Union

import numpy as np

WORD_BITS = 32

#: Rows of a subarray no LUT may use: T0..T2 / G0..G3, DCC0, and the two
#: constant rows.
NUM_RESERVED = 8

#: Row address operand: a broadcast row index, or per-bank indices [banks].
RowIdx = Union[int, np.ndarray]


class PuDArch(str, enum.Enum):
    UNMODIFIED = "unmodified"
    MODIFIED = "modified"  # SIMDRAM / Ambit


class PuDOp(str, enum.Enum):
    ROWCOPY = "rowcopy"      # AAP: ACT-ACT-PRE (or ACT-PRE-ACT on COTS DRAM)
    TRA = "tra"              # triple-row activation (Modified only)
    APA = "apa"              # 4-row activation, ACT-PRE-ACT (Unmodified only)
    FRAC = "frac"            # fractional charge op (Unmodified only)
    NOT = "not"              # dual-contact-cell NOT (Modified only)
    READ = "read"            # row readout to host (off-chip transfer)
    WRITE = "write"          # host write of a full row (off-chip transfer)
    ROWCLONE = "rowclone"    # bulk relocation copy, rows=(src, dst)
    ROWINIT = "rowinit"      # bulk init from a constant row, rows=(const, dst)
    AND = "and"              # Ambit AND merge wave, rows=(a, b, dst)
    OR = "or"                # Ambit OR merge wave, rows=(a, b, dst)
    MRACT = "mract"          # multi-row ACT clone, rows=(src, dst, span)


@dataclass
class TraceEntry:
    op: PuDOp
    rows: tuple  # ints (broadcast) and/or [banks] int arrays (per-bank)
    seg: int = 0  # segment id (dependency tag; see CommandTrace)


@dataclass(frozen=True)
class Segment:
    """One dependency-tagged span of a command stream.  Waves inside a
    segment form a chain; the segment's first wave waits for every wave
    of every segment in ``after`` and for every host event in
    ``after_host`` (ids into the trace's ``host_events``)."""

    sid: int
    label: str
    after: tuple[int, ...]
    after_host: tuple[int, ...] = ()


@dataclass
class HostEvent:
    """Host-side work interposed in a recorded stream (a host barrier).

    It starts once every wave of every segment in ``after`` (and every
    host event in ``after_host``) has completed; segments naming it in
    their ``after_host`` start after it ends.  ``duration_ns`` is a
    measured wall-clock, or ``None`` to let the scheduler model it from
    ``bytes_in``.  Events with one non-empty ``label`` in several
    streams are one host step; ``parallelism`` lets a multi-lane host
    gang it over that many lanes."""

    hid: int
    label: str
    after: tuple[int, ...]
    after_host: tuple[int, ...] = ()
    duration_ns: float | None = None
    bytes_in: float = 0.0
    parallelism: int = 1


@dataclass
class CommandTrace:
    """Ordered record of the broadcast primitives issued to one bank
    group: the group's command stream.  Entries carry the current
    segment; ``begin_segment`` opens a new one (by default chained to
    the previous one)."""

    entries: list[TraceEntry] = field(default_factory=list)
    segments: list[Segment] = field(
        default_factory=lambda: [Segment(0, "", ())])
    host_events: list[HostEvent] = field(default_factory=list)
    _cur_seg: int = 0

    def begin_segment(self, label: str = "",
                      after: tuple[int, ...] | None = None,
                      after_host: tuple[int, ...] = ()) -> int:
        """Open a new segment and make it current; returns its id.
        ``after=None`` chains to the current segment."""
        if after is None:
            after = (self._cur_seg,)
        sid = len(self.segments)
        self.segments.append(
            Segment(sid, label, tuple(after), tuple(after_host)))
        self._cur_seg = sid
        return sid

    def add_host_event(self, label: str = "",
                       after: tuple[int, ...] | None = None,
                       after_host: tuple[int, ...] = (),
                       duration_ns: float | None = None,
                       bytes_in: float = 0.0,
                       parallelism: int = 1) -> int:
        """Record host work gated on ``after`` segments (``None``: the
        current one) and ``after_host`` events; returns its id."""
        if after is None:
            after = (self._cur_seg,)
        hid = len(self.host_events)
        self.host_events.append(HostEvent(
            hid, label, tuple(after), tuple(after_host),
            duration_ns, bytes_in, parallelism))
        return hid

    @property
    def current_segment(self) -> int:
        return self._cur_seg

    def emit(self, op: PuDOp, *rows: RowIdx) -> None:
        self.entries.append(TraceEntry(op, rows, self._cur_seg))

    def emit_rows(self, op: PuDOp, start: int, n: int) -> None:
        """Bulk-emit ``n`` consecutive single-row entries (host row I/O)."""
        self.entries.extend(
            TraceEntry(op, (r,), self._cur_seg)
            for r in range(start, start + n))

    @property
    def pud_ops(self) -> int:
        """Per-bank in-DRAM PuD op count (excludes host READ/WRITE)."""
        return sum(
            1 for e in self.entries if e.op not in (PuDOp.READ, PuDOp.WRITE)
        )


def pack_bits(bits: np.ndarray) -> np.ndarray:
    """Pack 0/1 bits [..., N] into uint32 words [..., ceil(N/32)],
    little-endian within the word."""
    bits = np.asarray(bits)
    bits = bits.view(np.uint8) if bits.dtype == np.bool_ \
        else bits.astype(np.uint8, copy=False)
    n = bits.shape[-1]
    pad = (-n) % WORD_BITS
    if pad:
        bits = np.concatenate(
            [bits, np.zeros(bits.shape[:-1] + (pad,), np.uint8)], axis=-1
        )
    if sys.byteorder == "little":
        packed = np.packbits(bits, axis=-1, bitorder="little")
        return np.ascontiguousarray(packed).view(np.uint32)
    b = bits.reshape(*bits.shape[:-1], -1, WORD_BITS).astype(np.uint32)
    shifts = np.arange(WORD_BITS, dtype=np.uint32)
    return (b << shifts).sum(axis=-1, dtype=np.uint32)


def unpack_bits(words: np.ndarray, n: int) -> np.ndarray:
    """Inverse of :func:`pack_bits`; returns uint8 bits [..., n]."""
    words = np.asarray(words, dtype=np.uint32)
    if sys.byteorder == "little":
        as_bytes = np.ascontiguousarray(words).view(np.uint8)
        bits = np.unpackbits(as_bytes, axis=-1, bitorder="little")
        return bits[..., :n]
    shifts = np.arange(WORD_BITS, dtype=np.uint32)
    bits = (words[..., :, None] >> shifts) & np.uint32(1)
    bits = bits.reshape(*words.shape[:-1], -1)
    return bits[..., :n].astype(np.uint8)


class BankedSubarray:
    """A group of ``num_banks`` PuD subarrays driven by one broadcast
    command stream: state ``[banks, rows, words]`` uint32, one trace.

    Reserved rows sit at the top: ``ROW_ZERO`` / ``ROW_ONE`` (constant),
    then ``T0..T2`` and ``DCC0`` on Modified PuD or the activation group
    ``G0..G3`` on Unmodified PuD.  A source row operand may be a
    ``[banks]`` int array (per-bank gather); destinations are broadcast.
    """

    NUM_RESERVED = NUM_RESERVED

    def __init__(
        self,
        num_banks: int = 1,
        num_rows: int = 1024,
        num_cols: int = 65536,
        arch: PuDArch = PuDArch.UNMODIFIED,
        seed: int | None = 0,
    ) -> None:
        if num_cols % WORD_BITS:
            raise ValueError("num_cols must be a multiple of 32")
        if num_banks < 1:
            raise ValueError("need at least one bank")
        self.num_banks = num_banks
        self.num_rows = num_rows
        self.num_cols = num_cols
        self.num_words = num_cols // WORD_BITS
        self.arch = arch
        rng = np.random.default_rng(seed)
        # DRAM content is undefined at power-up; randomize to catch code
        # that relies on zero-initialized rows
        self.state = rng.integers(
            0, 2**32, size=(num_banks, num_rows, self.num_words),
            dtype=np.uint32,
        )
        self.trace = CommandTrace()
        self._bidx = np.arange(num_banks)
        self.ROW_ZERO = num_rows - 1
        self.ROW_ONE = num_rows - 2
        self.state[:, self.ROW_ZERO] = 0
        self.state[:, self.ROW_ONE] = 0xFFFFFFFF
        if arch is PuDArch.MODIFIED:
            self.T0, self.T1, self.T2 = num_rows - 3, num_rows - 4, num_rows - 5
            self.DCC0 = num_rows - 6
        else:
            self.G = (num_rows - 3, num_rows - 4, num_rows - 5, num_rows - 6)
        self._frac_row: int | None = None
        self._alloc_ptr = 0  # bump allocator for data/LUT rows

    def _fetch(self, idx: RowIdx) -> np.ndarray:
        """Row content [banks, words]; per-bank gather for array ``idx``."""
        if isinstance(idx, np.ndarray):
            if idx.shape != (self.num_banks,):
                raise ValueError(
                    f"per-bank row index must have shape ({self.num_banks},)")
            return self.state[self._bidx, idx.astype(np.int64)]
        return self.state[:, idx]

    def alloc(self, n: int) -> int:
        """Allocate ``n`` consecutive data rows (same index in every
        bank); returns the first index."""
        start = self._alloc_ptr
        if start + n > self.num_rows - self.NUM_RESERVED:
            raise MemoryError(
                f"subarray row budget exceeded: need {n} rows at {start}, "
                f"capacity {self.num_rows - self.NUM_RESERVED}"
            )
        self._alloc_ptr += n
        return start

    # Host-side (off-chip) accessors: one trace entry per row moved.
    def host_write_rows(self, start: int, words: np.ndarray) -> None:
        """Store consecutive rows: ``words`` is [rows, words] (broadcast
        across banks) or [banks, rows, words]; one WRITE entry a row."""
        words = np.asarray(words, dtype=np.uint32)
        n = words.shape[-2]
        self.state[:, start:start + n] = words
        self.trace.emit_rows(PuDOp.WRITE, start, n)

    def host_read_row(self, idx: int) -> np.ndarray:
        """Read one row from every bank -> [banks, words]."""
        self.trace.emit(PuDOp.READ, idx)
        return self.state[:, idx].copy()

    # PuD primitives (one broadcast wave across all banks each)
    def rowcopy(self, src: RowIdx, dst: int) -> None:
        """In-subarray bulk copy; ``src`` may be per-bank."""
        if not isinstance(src, np.ndarray) and src == dst:
            return
        self.state[:, dst] = self._fetch(src)
        if self._frac_row == dst:
            self._frac_row = None
        self.trace.emit(PuDOp.ROWCOPY, src, dst)

    def bulk_not(self, src: RowIdx, dst: int) -> None:
        if self.arch is not PuDArch.MODIFIED:
            raise RuntimeError("bulk NOT requires dual-contact cells "
                               "(Modified PuD only)")
        self.state[:, dst] = ~self._fetch(src)
        self.trace.emit(PuDOp.NOT, src, dst)

    def tra(self) -> None:
        """Triple-row activation: MAJ3(T0,T1,T2) -> written to all three."""
        if self.arch is not PuDArch.MODIFIED:
            raise RuntimeError("TRA requires Modified (SIMDRAM) PuD")
        a, b, c = (self.state[:, r] for r in (self.T0, self.T1, self.T2))
        maj = (a & b) | (b & c) | (a & c)
        for r in (self.T0, self.T1, self.T2):
            self.state[:, r] = maj
        self.trace.emit(PuDOp.TRA, self.T0, self.T1, self.T2)

    def frac(self, group_slot: int) -> None:
        """Drive one activation-group row to an intermediate voltage."""
        if self.arch is not PuDArch.UNMODIFIED:
            raise RuntimeError("Frac is an Unmodified-PuD operation")
        self._frac_row = self.G[group_slot]
        self.trace.emit(PuDOp.FRAC, self.G[group_slot])

    def apa(self) -> None:
        """4-row activation over the fixed group; the Frac'd row is
        neutral, so all four rows receive MAJ3 of the other three."""
        if self.arch is not PuDArch.UNMODIFIED:
            raise RuntimeError("APA is an Unmodified-PuD operation")
        if self._frac_row is None:
            raise RuntimeError("APA without a preceding Frac: result would "
                               "be a 4-input majority (undefined tie)")
        live = [r for r in self.G if r != self._frac_row]
        a, b, c = (self.state[:, r] for r in live)
        maj = (a & b) | (b & c) | (a & c)
        for r in self.G:
            self.state[:, r] = maj
        self._frac_row = None
        self.trace.emit(PuDOp.APA, *self.G)

    def maj3_into_acc(self, acc: RowIdx, x: RowIdx, y: RowIdx) -> int:
        """MAJ3(rows[acc], rows[x], rows[y]) by the substrate's own
        mechanism; returns the row holding the result.  Modified: acc
        stays in T0 (staged only when elsewhere), x, y into T1, T2, then
        TRA.  Unmodified: acc in G0, x, y into G1, G2, FRAC G3, APA."""
        acc_is_vec = isinstance(acc, np.ndarray)
        if self.arch is PuDArch.MODIFIED:
            if acc_is_vec or acc != self.T0:
                self.rowcopy(acc, self.T0)
            self.rowcopy(x, self.T1)
            self.rowcopy(y, self.T2)
            self.tra()
            return self.T0
        if acc_is_vec or acc != self.G[0]:
            self.rowcopy(acc, self.G[0])
        self.rowcopy(x, self.G[1])
        self.rowcopy(y, self.G[2])
        self.frac(3)
        self.apa()
        return self.G[0]
