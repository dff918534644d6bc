"""A command-level model of a Processing-using-DRAM device whose bank
state lives in a torch tensor, on the card unless the caller names
another device.

The two PuD substrates of the paper:

* ``PuDArch.MODIFIED``   -- SIMDRAM/Ambit: triple-row activation (TRA)
  among the compute rows ``T0..T2`` implements bulk MAJ3; a
  dual-contact row ``DCC0`` gives bulk NOT.
* ``PuDArch.UNMODIFIED`` -- COTS DRAM: MAJ3 is a 4-row activation
  (``APA``) over the fixed group ``G0..G3`` with one row first
  neutralized by ``FRAC``; there is no NOT.

This is the reference package's ``core/machine.py`` under the same names
and with the same semantics, trace for trace.  What differs is where the
bits live: :class:`BankedSubarray` keeps its ``[banks, rows, words]``
state as an **int32** tensor on ``device`` (torch has no usable
``uint32``, see :mod:`repro_torch.kernels.common`; the bits are the
same), so every broadcast wave is a tensor op across the bank axis.
Its power-up content is the reference's own draw from
``np.random.default_rng(seed)``, uploaded once, so on any device every
row -- written or not -- equals the reference's.  The command traces
stay on the host with the reference's NumPy row operands: the scheduler,
cost model and planner read them unchanged.  Host reads
(:meth:`BankedSubarray.host_read_row`, :meth:`BankedSubarray.peek`)
return NumPy ``uint32`` words; they are the only place the state crosses
back, and they wait for the device.

Streams: one :class:`TraceEntry` per broadcast wave, tagged with a
:class:`Segment` id (waves of a segment chain; a segment waits for its
``after`` segments and ``after_host`` :class:`HostEvent` s).  Host
events carry a measured wall-clock when one exists, else the readout
bytes the scheduler models their time from; one label in several
streams is one host step.  :func:`replay` re-runs a stream's compute
waves on another subarray.

In-DRAM bulk movement (zero host bytes, activation cost only):
``ROWCLONE`` / ``ROWINIT`` relocation copies, Ambit ``AND`` / ``OR``
merges staged through the compute rows (:meth:`BankedSubarray.
ambit_and`), and PULSAR ``MRACT`` clones of up to ``multi_row_act``
rows in one wave (:meth:`BankedSubarray.rowclone_rows`,
:meth:`BankedSubarray.clone_rows_from`).
"""

from __future__ import annotations

import enum
import sys
import time
from dataclasses import dataclass, field
from typing import Union

import numpy as np
import torch

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
    #: Source subarray of a cross-group clone wave
    #: (:meth:`BankedSubarray.clone_rows_from`); ``None`` otherwise.
    xsrc: "BankedSubarray | None" = None


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
    #: True while the stream covers the subarray's whole life from
    #: reset; :meth:`clear` drops history the state still reflects.
    from_reset: bool = True
    _cur_seg: int = 0
    #: READ/WRITE entries so far (entries appended by hand are in-DRAM
    #: clone waves), so :attr:`pud_ops` costs no scan of the stream
    _io: int = 0

    def begin_segment(self, label: str = "",
                      after: tuple[int, ...] | None = None,
                      after_host: tuple[int, ...] = ()) -> int:
        """Open a new segment and make it current; returns its id.
        ``after=None`` chains to the current segment; ``after_host``
        lists host events that must end before its first wave."""
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
        current one; ``()``: none) and ``after_host`` events; returns
        its id.  ``duration_ns`` may be back-filled later by
        :meth:`set_host_duration`."""
        if after is None:
            after = (self._cur_seg,)
        hid = len(self.host_events)
        self.host_events.append(HostEvent(
            hid, label, tuple(after), tuple(after_host),
            duration_ns, bytes_in, parallelism))
        return hid

    def set_host_duration(self, hid: int, duration_ns: float) -> None:
        """Back-fill a host event's measured wall-clock duration."""
        self.host_events[hid].duration_ns = duration_ns

    @property
    def current_segment(self) -> int:
        return self._cur_seg

    def emit(self, op: PuDOp, *rows: RowIdx) -> None:
        self.entries.append(TraceEntry(op, rows, self._cur_seg))
        self._io += op in (PuDOp.READ, PuDOp.WRITE)

    def emit_rows(self, op: PuDOp, start: int, n: int) -> None:
        """Bulk-emit ``n`` consecutive single-row entries (host row I/O)."""
        self.entries.extend(
            TraceEntry(op, (r,), self._cur_seg)
            for r in range(start, start + n))
        self._io += n * (op in (PuDOp.READ, PuDOp.WRITE))

    def count(self, op: PuDOp) -> int:
        return sum(1 for e in self.entries if e.op is op)

    @property
    def pud_ops(self) -> int:
        """Per-bank in-DRAM PuD op count (excludes host READ/WRITE)."""
        return len(self.entries) - self._io

    def counts(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for e in self.entries:
            out[e.op.value] = out.get(e.op.value, 0) + 1
        return out

    def clear(self) -> None:
        self.entries.clear()
        self._io = 0
        self.segments[:] = [Segment(0, "", ())]
        self.host_events.clear()
        self._cur_seg = 0
        # the rows still hold what the cleared stream loaded
        self.from_reset = False


def replay(entries, sub: "BankedSubarray",
           reads: "list[np.ndarray] | None" = None) -> None:
    """Re-execute a recorded stream's waves on ``sub``.

    Compute and in-DRAM bulk waves replay exactly, per-bank gathers
    included, so a subarray holding the same pre-stream state reaches
    the same post-stream state.  READ waves re-issue the readout
    (collected into ``reads`` when given); WRITE waves and the payload
    of cross-group clones are not in the stream, so WRITEs are skipped
    and clones replay as intra-subarray copies."""
    sub.trace.from_reset = False
    for e in entries:
        if e.op is PuDOp.ROWCOPY:
            sub.rowcopy(*e.rows)
        elif e.op is PuDOp.ROWCLONE:
            sub.rowclone(*e.rows)
        elif e.op is PuDOp.ROWINIT:
            sub.rowinit(e.rows[1], ones=(e.rows[0] == sub.ROW_ONE))
        elif e.op is PuDOp.MRACT:
            sub.mract_clone(*e.rows)
        elif e.op is PuDOp.AND:
            sub.and_wave(*e.rows)
        elif e.op is PuDOp.OR:
            sub.or_wave(*e.rows)
        elif e.op is PuDOp.TRA:
            sub.tra()
        elif e.op is PuDOp.APA:
            sub.apa()
        elif e.op is PuDOp.FRAC:
            sub.frac(sub.G.index(e.rows[0]))
        elif e.op is PuDOp.NOT:
            sub.bulk_not(*e.rows)
        elif e.op is PuDOp.READ:
            data = sub.host_read_row(e.rows[0])
            if reads is not None:
                reads.append(data)
        elif e.op is PuDOp.WRITE:
            pass  # payload not recorded; state assumed pre-loaded
        else:  # pragma: no cover - enum is closed
            raise ValueError(e.op)


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


def _host_words(t: torch.Tensor) -> np.ndarray:
    """An int32 state slice -> an independent NumPy ``uint32`` copy (a
    device slice waits for the queued waves that write it)."""
    return t.cpu().numpy().view(np.uint32).copy()


class BankedSubarray:
    """A group of ``num_banks`` PuD subarrays driven by one broadcast
    command stream: state ``[banks, rows, words]`` (int32 on
    ``device``), one trace.

    Reserved rows sit at the top: ``ROW_ZERO`` / ``ROW_ONE`` (constant),
    then ``T0..T2`` and ``DCC0`` on Modified PuD or the activation group
    ``G0..G3`` on Unmodified PuD.  A source row operand may be a
    ``[banks]`` int array (per-bank gather); destinations are broadcast.

    ``device`` is the card unless the caller names another
    (``device="cpu"``); with no CUDA and no ``device`` this raises.
    ``powerup_ns`` records the host time of the power-up draw and of
    its upload to ``device``.
    """

    NUM_RESERVED = NUM_RESERVED

    def __init__(
        self,
        num_banks: int = 1,
        num_rows: int = 1024,
        num_cols: int = 65536,
        arch: PuDArch = PuDArch.UNMODIFIED,
        seed: int | None = 0,
        multi_row_act: int = 1,
        device=None,
    ) -> None:
        from repro_torch.kernels.common import resolve_device

        if num_cols % WORD_BITS:
            raise ValueError("num_cols must be a multiple of 32")
        if num_banks < 1:
            raise ValueError("need at least one bank")
        if multi_row_act < 1:
            raise ValueError("multi_row_act must be >= 1")
        self.device = resolve_device(device)
        self.num_banks = num_banks
        #: PULSAR capability: max rows one MRACT wave may clone (1 = off).
        self.multi_row_act = multi_row_act
        self.num_rows = num_rows
        self.num_cols = num_cols
        self.num_words = num_cols // WORD_BITS
        self.arch = arch
        self.ROW_ZERO = num_rows - 1
        self.ROW_ONE = num_rows - 2
        # DRAM content is undefined at power-up: the reference's random
        # draw, so unwritten rows equal the reference's too
        t0 = time.perf_counter_ns()
        rng = np.random.default_rng(seed)
        draw = rng.integers(
            0, 2**32, size=(num_banks, num_rows, self.num_words),
            dtype=np.uint32,
        )
        draw[:, self.ROW_ZERO] = 0
        draw[:, self.ROW_ONE] = 0xFFFFFFFF
        t1 = time.perf_counter_ns()
        self.state = torch.from_numpy(draw.view(np.int32)).to(self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.powerup_ns = (t1 - t0, time.perf_counter_ns() - t1)
        self.trace = CommandTrace()
        self._bidx = torch.arange(num_banks, device=self.device)
        if arch is PuDArch.MODIFIED:
            self.T0, self.T1, self.T2 = num_rows - 3, num_rows - 4, num_rows - 5
            self.DCC0 = num_rows - 6
        else:
            # fixed activation group for the 4-row APA
            self.G = (num_rows - 3, num_rows - 4, num_rows - 5, num_rows - 6)
        self._frac_row: int | None = None
        self._alloc_ptr = 0  # bump allocator for data/LUT rows

    # ------------------------------------------------------------------ #
    # Row addressing
    # ------------------------------------------------------------------ #
    def _fetch(self, idx: RowIdx) -> torch.Tensor:
        """Row content [banks, words]; per-bank gather for array ``idx``
        (its indices cross to the device once per wave)."""
        if isinstance(idx, np.ndarray):
            if idx.shape != (self.num_banks,):
                raise ValueError(
                    f"per-bank row index must have shape ({self.num_banks},)")
            rows = idx.astype(np.int64)
            if rows.size and (rows.min() < -self.num_rows
                              or rows.max() >= self.num_rows):
                raise IndexError(
                    f"per-bank row index outside the {self.num_rows} rows")
            rows_t = torch.from_numpy(rows).to(self.device)
            return self.state[self._bidx, rows_t]
        return self.state[:, idx]

    def _words(self, words) -> torch.Tensor:
        """Row words to store: NumPy ``uint32`` words, or int32 words
        already on the device, as an int32 tensor on ``device``."""
        if isinstance(words, torch.Tensor):
            if words.dtype != torch.int32:
                raise TypeError(f"row words must be int32, got {words.dtype}")
            return words.to(self.device)
        arr = np.ascontiguousarray(np.asarray(words, dtype=np.uint32))
        return torch.from_numpy(arr.view(np.int32)).to(self.device)

    # ------------------------------------------------------------------ #
    # Row allocation
    # ------------------------------------------------------------------ #
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

    @property
    def rows_free(self) -> int:
        return self.num_rows - self.NUM_RESERVED - self._alloc_ptr

    # ------------------------------------------------------------------ #
    # Host-side (off-chip) accessors: one trace entry per row moved.
    # ------------------------------------------------------------------ #
    def host_write_row(self, idx: int, words) -> None:
        """Write one row; ``words`` is [words] (broadcast to all banks)
        or [banks, words]."""
        self.state[:, idx] = self._words(words)
        self.trace.emit(PuDOp.WRITE, idx)

    def host_write_rows(self, start: int, words) -> None:
        """Store consecutive rows: ``words`` is [rows, words] (broadcast
        across banks) or [banks, rows, words]; one WRITE entry a row."""
        words = self._words(words)
        n = words.shape[-2]
        self.state[:, start:start + n] = words
        self.trace.emit_rows(PuDOp.WRITE, start, n)

    def host_read_row(self, idx: int) -> np.ndarray:
        """Read one row from every bank -> [banks, words] ``uint32``."""
        self.trace.emit(PuDOp.READ, idx)
        return _host_words(self.state[:, idx])

    def peek(self, idx: int) -> np.ndarray:
        """Debug view of a row without emitting trace traffic."""
        return _host_words(self.state[:, idx])

    # ------------------------------------------------------------------ #
    # PuD primitives (one broadcast wave across all banks each)
    # ------------------------------------------------------------------ #
    def _store(self, dst: int, rows: torch.Tensor) -> None:
        self.state[:, dst] = rows
        if self._frac_row == dst:
            self._frac_row = None

    def rowcopy(self, src: RowIdx, dst: int) -> None:
        """In-subarray bulk copy; ``src`` may be per-bank.  A compute
        staging copy onto its own row is elided."""
        if not isinstance(src, np.ndarray) and src == dst:
            return
        self._store(dst, self._fetch(src))
        self.trace.emit(PuDOp.ROWCOPY, src, dst)

    def rowclone(self, src: int, dst: int) -> None:
        """RowClone relocation copy: one wave, no host traffic, emitted
        even when ``src == dst`` (a defragmentation re-homes a group on
        other physical banks at unchanged row indices; the state, kept
        per group, is unchanged then)."""
        if src != dst:
            self._store(dst, self._fetch(src))
        elif self._frac_row == dst:
            self._frac_row = None
        self.trace.emit(PuDOp.ROWCLONE, src, dst)

    def rowinit(self, dst: int, ones: bool = False) -> None:
        """RowClone bulk initialization of ``dst`` from a constant row."""
        const = self.ROW_ONE if ones else self.ROW_ZERO
        self._store(dst, self.state[:, const])
        self.trace.emit(PuDOp.ROWINIT, const, dst)

    def mract_clone(self, src_start: int, dst_start: int, span: int) -> None:
        """PULSAR multi-row ACT: clone ``span`` consecutive rows in ONE
        wave.  Requires ``span <= multi_row_act``; the spans must not
        partially overlap (``src_start == dst_start`` is fine)."""
        if not 1 <= span <= self.multi_row_act:
            raise ValueError(
                f"MRACT span {span} exceeds multi_row_act="
                f"{self.multi_row_act}")
        if src_start != dst_start and (
                abs(src_start - dst_start) < span):
            raise ValueError("MRACT source/destination spans overlap")
        if src_start != dst_start:
            self.state[:, dst_start:dst_start + span] = \
                self.state[:, src_start:src_start + span]
        if self._frac_row is not None and \
                dst_start <= self._frac_row < dst_start + span:
            self._frac_row = None
        self.trace.emit(PuDOp.MRACT, src_start, dst_start, span)

    def rowclone_rows(self, src_start: int, dst_start: int, n: int) -> None:
        """In-DRAM relocation of ``n`` consecutive rows: MRACT waves of
        up to ``multi_row_act`` rows, else one ROWCLONE a row."""
        mra = self.multi_row_act
        done = 0
        while done < n:
            span = min(mra, n - done)
            if span > 1:
                self.mract_clone(src_start + done, dst_start + done, span)
            else:
                self.rowclone(src_start + done, dst_start + done)
            done += span

    def clone_rows_from(self, src_sub: "BankedSubarray", src_start: int,
                        dst_start: int, n: int) -> None:
        """In-DRAM replication of ``n`` rows of ``src_sub`` into this
        group (same bank count; the device layer keeps both on one
        channel), recorded in THIS group's trace, chunked by
        ``multi_row_act`` like :meth:`rowclone_rows`."""
        if src_sub.num_banks != self.num_banks:
            raise ValueError(
                "in-DRAM clone requires matching bank counts: "
                f"{src_sub.num_banks} != {self.num_banks}")
        self.state[:, dst_start:dst_start + n] = \
            src_sub.state[:, src_start:src_start + n].to(self.device)
        mra = self.multi_row_act
        done = 0
        while done < n:
            span = min(mra, n - done)
            if span > 1:
                self.trace.entries.append(TraceEntry(
                    PuDOp.MRACT, (src_start + done, dst_start + done, span),
                    self.trace.current_segment, xsrc=src_sub))
            else:
                self.trace.entries.append(TraceEntry(
                    PuDOp.ROWCLONE, (src_start + done, dst_start + done),
                    self.trace.current_segment, xsrc=src_sub))
            done += span

    def and_wave(self, a: RowIdx, b: RowIdx, dst: int) -> None:
        """Ambit AND merge wave: ``dst = a & b`` in one trace entry."""
        self._store(dst, self._fetch(a) & self._fetch(b))
        self.trace.emit(PuDOp.AND, a, b, dst)

    def or_wave(self, a: RowIdx, b: RowIdx, dst: int) -> None:
        """Ambit OR merge wave: ``dst = a | b`` (control row = ONE)."""
        self._store(dst, self._fetch(a) | self._fetch(b))
        self.trace.emit(PuDOp.OR, a, b, dst)

    def _ambit_stage(self) -> tuple[int, int]:
        """The two compute rows Ambit merges stage their operands in."""
        if self.arch is PuDArch.MODIFIED:
            return self.T1, self.T2
        return self.G[1], self.G[2]

    def ambit_and(self, x: RowIdx, y: RowIdx, dst: int) -> None:
        """Bitmap AND in-DRAM: stage ``x``/``y`` into the compute rows
        and fire one AND wave into ``dst`` (3 waves, zero host bytes)."""
        s1, s2 = self._ambit_stage()
        self.rowcopy(x, s1)
        self.rowcopy(y, s2)
        self.and_wave(s1, s2, dst)

    def ambit_or(self, x: RowIdx, y: RowIdx, dst: int) -> None:
        """Bitmap OR in-DRAM; see :meth:`ambit_and`."""
        s1, s2 = self._ambit_stage()
        self.rowcopy(x, s1)
        self.rowcopy(y, s2)
        self.or_wave(s1, s2, dst)

    def bulk_not(self, src: RowIdx, dst: int) -> None:
        if self.arch is not PuDArch.MODIFIED:
            raise RuntimeError("bulk NOT requires dual-contact cells "
                               "(Modified PuD only)")
        self.state[:, dst] = ~self._fetch(src)
        self.trace.emit(PuDOp.NOT, src, dst)

    def tra(self) -> None:
        """Triple-row activation: MAJ3(T0,T1,T2) -> written to all three
        (rows ``T2..T0`` are consecutive)."""
        if self.arch is not PuDArch.MODIFIED:
            raise RuntimeError("TRA requires Modified (SIMDRAM) PuD")
        a, b, c = (self.state[:, r] for r in (self.T0, self.T1, self.T2))
        maj = (a & b) | (b & c) | (a & c)
        self.state[:, self.T2:self.T0 + 1] = maj[:, None]
        self.trace.emit(PuDOp.TRA, self.T0, self.T1, self.T2)

    def frac(self, group_slot: int) -> None:
        """Drive one activation-group row to an intermediate voltage."""
        if self.arch is not PuDArch.UNMODIFIED:
            raise RuntimeError("Frac is an Unmodified-PuD operation")
        self._frac_row = self.G[group_slot]
        self.trace.emit(PuDOp.FRAC, self.G[group_slot])

    def apa(self) -> None:
        """4-row activation over the fixed group; the Frac'd row is
        neutral, so all four rows (``G3..G0``, consecutive) receive MAJ3
        of the other three."""
        if self.arch is not PuDArch.UNMODIFIED:
            raise RuntimeError("APA is an Unmodified-PuD operation")
        if self._frac_row is None:
            raise RuntimeError("APA without a preceding Frac: result would "
                               "be a 4-input majority (undefined tie)")
        live = [r for r in self.G if r != self._frac_row]
        a, b, c = (self.state[:, r] for r in live)
        maj = (a & b) | (b & c) | (a & c)
        self.state[:, self.G[3]:self.G[0] + 1] = maj[:, None]
        self._frac_row = None
        self.trace.emit(PuDOp.APA, *self.G)

    # ------------------------------------------------------------------ #
    # Composite MAJ3 helper used by the algorithms
    # ------------------------------------------------------------------ #
    def maj3_into_acc(self, acc: RowIdx, x: RowIdx, y: RowIdx) -> int:
        """MAJ3(rows[acc], rows[x], rows[y]) by the substrate's own
        mechanism; returns the row holding the result.  Modified: acc
        stays in T0 (staged only when elsewhere), x, y into T1, T2, then
        TRA.  Unmodified: acc in G0, x, y into G1, G2, FRAC G3, APA.
        Per-bank rows are staged with gather copies, so the command
        count equals the broadcast case."""
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


class Subarray(BankedSubarray):
    """Single-bank view of :class:`BankedSubarray`: ``rows`` is the
    ``[num_rows, num_words]`` state of the only bank, and host reads
    return 1-D word vectors."""

    def __init__(
        self,
        num_rows: int = 1024,
        num_cols: int = 65536,
        arch: PuDArch = PuDArch.UNMODIFIED,
        seed: int | None = 0,
        device=None,
    ) -> None:
        super().__init__(1, num_rows, num_cols, arch, seed, device=device)

    @property
    def rows(self) -> torch.Tensor:
        """2-D [num_rows, num_words] int32 view of the bank's state."""
        return self.state[0]

    def host_read_row(self, idx: int) -> np.ndarray:
        return super().host_read_row(idx)[0]

    def peek(self, idx: int) -> np.ndarray:
        return super().peek(idx)[0]
