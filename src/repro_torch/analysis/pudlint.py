"""pudlint: static verifier for recorded PuD command streams.

The reference package's ``analysis/pudlint.py`` under the same names:
equal inputs give equal diagnostics (codes, messages, fields and order,
so :meth:`LintReport.to_json` is equal).  It is host Python over host
data: a machine job's bank state may live on the card, but its command
traces keep NumPy row operands on the host, and nothing here reads the
state.

Every machine-backend result flows through recorded
:class:`~repro_torch.core.machine.CommandTrace` streams that the
:class:`~repro_torch.core.scheduler.ChannelScheduler` is free to reorder under
its earliest-start policy.  Correctness therefore rests on (a) segments
declaring the right ``after`` / ``after_host`` edges and (b) waves
respecting the DRAM protocol rules (Ambit compute-row staging, RowClone
channel confinement, PULSAR ``multi_row_act`` spans).  Nothing at
runtime checks those invariants globally -- a missing dependency edge
only surfaces if a test happens to replay into a wrong bit.

pudlint analyzes streams and scheduled timelines **without executing
them** and reports typed diagnostics in three passes:

Pass 1 -- per-bank row-state dataflow.  An abstract per-row lattice
(UNINIT -> CONST / HOST_LOADED / COPY / RESULT, with staging-row
CONSUMED and FRAC-neutralized refinements) is walked over the recorded
waves in issue order:

* ``PL101`` uninit-read: a compute wave reads a row no earlier wave
  wrote (only checked on from-reset streams; host READ waves and the
  relocation clone family are exempt -- bulk relocation legitimately
  moves whatever a row holds).
* ``PL102`` const-write: any wave writes ``ROW_ZERO`` / ``ROW_ONE``.
  The constant rows back Ambit control-row init and ``rowinit``; a
  write corrupts every later consumer.
* ``PL103`` row-oob: a row operand outside ``[0, num_rows)``.
* ``PL104`` apa-without-frac: an APA whose activation group has no
  live Frac'd row -- the result would be an undefined 4-input majority.
* ``PL105`` arch-mismatch: TRA/NOT on Unmodified PuD, APA/FRAC on
  Modified.
* ``PL106`` clobbered-result (warning): a compute result parked in a
  *data* row is overwritten before anything read it -- the classic
  double-buffer park-row collision.
* ``PL107`` stale-staging-read: an Ambit merge (AND/OR) reads a
  staging row (T1/T2 or G1/G2) whose previous staged operand was
  already consumed by an earlier merge and never re-staged.
* ``PL301`` mract-overspan: an MRACT wave's span exceeds the stream's
  recorded ``multi_row_act`` capability (also checked on the scheduled
  timeline against ``SystemConfig.multi_row_act``).

Pass 2 -- hazard / race detection over the segment dependency graph.
Waves of one segment are a chain; across segments, ordering exists only
along declared ``after`` / ``after_host`` edges (transitively, host
events included).  Two waves touching overlapping rows with no path
between their segments may be legally reordered by the scheduler:

* ``PL201`` RAW / ``PL202`` WAR / ``PL203`` WAW hazards (classified by
  record order, the order the app intended).
* ``PL204`` host-missing-readout: a host event that consumes readout
  bytes (``bytes_in > 0``) with no READ wave anywhere in its
  dependency closure -- the scheduler could start the merge before the
  data it merges exists.
* ``PL205`` dangling-dep: a segment or host event references an
  unknown segment id / host event id.
* ``PL206`` dep-cycle: the segment/host-event graph has a cycle (the
  scheduler would deadlock; it raises ``DependencyCycleError``).

Pass 3 -- protocol / capability conformance of a scheduled
:class:`~repro_torch.core.scheduler.Timeline`:

* ``PL301`` mract-overspan vs ``SystemConfig.multi_row_act``.
* ``PL302`` clone-cross-channel: a cross-group RowClone/MRACT whose
  source group lives on different channels than the destination (clones
  move over a channel's internal bus; they cannot cross channels) --
  checked by :func:`lint_device`, which sees both groups' placements.
* ``PL303`` channel-overlap: two waves holding the same channel at
  overlapping times (waves hold their channels exclusively).
* ``PL304`` wave-underrun: a scheduled wave shorter than the tFAW/tRRD
  window its op and bank footprint require (the timing violation IS the
  compute mechanism, so shaving the stagger corrupts the wave).
* ``PL305`` dep-time: a wave scheduled before its segment dependencies'
  waves or host barriers completed (or out of order within its
  segment's chain).
* ``PL306`` clone-io: an in-DRAM wave (clone family, Ambit merges,
  compute) reporting nonzero ``io_bytes`` -- these waves never touch
  the pins.
* ``PL307`` op-mismatch: the timeline's waves for a (group, segment)
  disagree with the recorded stream (scheduler / stream skew).

Pass 5 -- representation conformance of adaptive per-column plans:

* ``PL501`` representation-mismatch: an engine's encoded LUT layout
  (chunk widths, plane count, complement planes) disagrees with the
  :class:`~repro_torch.core.encoding.ColumnPlan` the session declares for
  that column -- the signature of a ``recode_column`` whose rebuild
  was skipped, leaving stale planes in the banks.  Checked by
  :func:`representation_diags`, which sessions run on every verified
  job over a plan-bearing resource.

Entry points: :func:`lint_stream` / :func:`lint_streams` (passes 1-2),
:func:`lint_timeline` (pass 3, plus 1-2 when streams are supplied),
:func:`lint_subarray` and :func:`lint_device` (machine-level
conveniences), and :func:`enforce` (raise / warn / ignore on a report).
``Timeline.verify()`` and ``PudSession(verify=...)`` wire these into
the scheduler and session layers.
"""

from __future__ import annotations

import json
import types
import warnings
import weakref
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.machine import PuDArch, PuDOp

#: diagnostic code -> (default severity, short title)
CODES: dict[str, tuple[str, str]] = {
    "PL101": ("error", "uninit-read"),
    "PL102": ("error", "const-write"),
    "PL103": ("error", "row-oob"),
    "PL104": ("error", "apa-without-frac"),
    "PL105": ("error", "arch-mismatch"),
    "PL106": ("warning", "clobbered-result"),
    "PL107": ("error", "stale-staging-read"),
    "PL201": ("error", "raw-hazard"),
    "PL202": ("error", "war-hazard"),
    "PL203": ("error", "waw-hazard"),
    "PL204": ("error", "host-missing-readout"),
    "PL205": ("error", "dangling-dep"),
    "PL206": ("error", "dep-cycle"),
    "PL301": ("error", "mract-overspan"),
    "PL302": ("error", "clone-cross-channel"),
    "PL303": ("error", "channel-overlap"),
    "PL304": ("error", "wave-underrun"),
    "PL305": ("error", "dep-time"),
    "PL306": ("error", "clone-io"),
    "PL307": ("error", "op-mismatch"),
    "PL401": ("error", "deadline-precedes-start"),
    "PL501": ("error", "representation-mismatch"),
}

#: Relocation clone family: reads are bulk moves of whatever the row
#: holds (may legitimately relocate never-written rows), and their
#: destinations are treated as (re)initialized -- a cross-group clone's
#: payload comes from the *source* group's rows, which this stream
#: never wrote.
_CLONE_OPS = (PuDOp.ROWCLONE, PuDOp.ROWINIT, PuDOp.MRACT)

#: Timing tolerance (ns) for float comparisons on scheduled times.
_EPS = 1e-6


@dataclass(frozen=True)
class Diagnostic:
    """One typed pudlint finding."""

    code: str
    severity: str                  # "error" | "warning"
    message: str
    group: str = ""
    wave: int | None = None        # wave index within the stream
    seg: int | None = None         # segment id
    row: int | None = None         # row index, when one is at fault

    def __str__(self) -> str:
        where = self.group or "?"
        if self.wave is not None:
            where += f"[w{self.wave}]"
        if self.seg is not None:
            where += f"(seg {self.seg})"
        return f"{self.code} {self.severity} {where}: {self.message}"

    def to_dict(self) -> dict:
        return {
            "code": self.code, "severity": self.severity,
            "title": CODES.get(self.code, ("", "?"))[1],
            "message": self.message, "group": self.group,
            "wave": self.wave, "seg": self.seg, "row": self.row,
        }


@dataclass
class LintReport:
    """All diagnostics of one pudlint run."""

    diagnostics: list[Diagnostic] = field(default_factory=list)

    @property
    def errors(self) -> list[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == "error"]

    @property
    def warnings(self) -> list[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == "warning"]

    @property
    def ok(self) -> bool:
        """True when no error-severity diagnostics were reported."""
        return not self.errors

    def codes(self) -> set[str]:
        return {d.code for d in self.diagnostics}

    def extend(self, other: "LintReport") -> "LintReport":
        self.diagnostics.extend(other.diagnostics)
        return self

    def summary(self, limit: int = 8) -> str:
        n_err, n_warn = len(self.errors), len(self.warnings)
        head = f"pudlint: {n_err} error(s), {n_warn} warning(s)"
        shown = [str(d) for d in (self.errors + self.warnings)[:limit]]
        more = len(self.diagnostics) - len(shown)
        if more > 0:
            shown.append(f"... and {more} more")
        return "\n  ".join([head] + shown)

    def to_json(self) -> dict:
        return {
            "errors": len(self.errors),
            "warnings": len(self.warnings),
            "diagnostics": [d.to_dict() for d in self.diagnostics],
        }

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2)
            f.write("\n")


class PudLintError(RuntimeError):
    """Raised by :func:`enforce` in strict mode; carries the report."""

    def __init__(self, report: LintReport, where: str = "") -> None:
        self.report = report
        prefix = f"{where}: " if where else ""
        super().__init__(prefix + report.summary())


def enforce(report: LintReport, mode: str = "strict",
            where: str = "") -> LintReport:
    """Apply a verify mode to a report: ``"strict"`` raises
    :class:`PudLintError` on any error-severity diagnostic, ``"warn"``
    emits a :class:`UserWarning` instead, ``"off"`` does nothing.
    Returns the report either way."""
    if mode not in ("strict", "warn", "off"):
        raise ValueError(
            f"verify mode must be 'strict', 'warn' or 'off', got {mode!r}")
    if mode == "off" or report.ok:
        return report
    if mode == "strict":
        raise PudLintError(report, where)
    warnings.warn((f"{where}: " if where else "") + report.summary(),
                  stacklevel=2)
    return report


# --------------------------------------------------------------------- #
# Wave access model
# --------------------------------------------------------------------- #
def _as_rows(operand) -> list[int]:
    """Row operand -> concrete row indices (per-bank arrays expand to
    their unique values)."""
    if isinstance(operand, np.ndarray):
        return [int(r) for r in np.unique(operand)]
    return [int(operand)]


def wave_accesses(op: PuDOp, rows: tuple) -> tuple[list[int], list[int]]:
    """(read rows, written rows) of one recorded wave.

    FRAC is modeled as a write (it destroys the row's charge); APA
    conservatively reads the whole activation group (the neutral member
    is not known statically).  MRACT expands its span.
    """
    if op in (PuDOp.ROWCOPY, PuDOp.ROWCLONE, PuDOp.ROWINIT, PuDOp.NOT):
        return _as_rows(rows[0]), _as_rows(rows[1])
    if op is PuDOp.MRACT:
        src, dst, span = int(rows[0]), int(rows[1]), int(rows[2])
        return (list(range(src, src + span)),
                list(range(dst, dst + span)))
    if op in (PuDOp.AND, PuDOp.OR):
        return _as_rows(rows[0]) + _as_rows(rows[1]), _as_rows(rows[2])
    if op is PuDOp.TRA:
        r = [x for a in rows for x in _as_rows(a)]
        return r, list(r)
    if op is PuDOp.APA:
        r = [x for a in rows for x in _as_rows(a)]
        return r, list(r)
    if op is PuDOp.FRAC:
        return [], _as_rows(rows[0])
    if op is PuDOp.READ:
        return _as_rows(rows[0]), []
    if op is PuDOp.WRITE:
        return [], _as_rows(rows[0])
    raise ValueError(f"unknown op {op!r}")  # pragma: no cover


# --------------------------------------------------------------------- #
# Pass 1: per-bank row-state dataflow
# --------------------------------------------------------------------- #
@dataclass
class _RowState:
    written: bool = False
    origin: str = "uninit"     # uninit|const|host|copy|result|frac
    read_since_write: bool = True   # no unread value at start
    stage_consumed: bool = False


def _row_pass(stream, out: list[Diagnostic]) -> None:
    num_rows = stream.num_rows
    if num_rows is None or not stream.rows:
        return      # no machine metadata: nothing row-level to check
    arch = stream.arch
    row_zero, row_one = num_rows - 1, num_rows - 2
    const_rows = {row_zero, row_one}
    reserved0 = num_rows - 8    # BankedSubarray.NUM_RESERVED
    staging = {num_rows - 4, num_rows - 5}   # T1,T2 / G[1],G[2]
    g_rows = {num_rows - 3, num_rows - 4, num_rows - 5, num_rows - 6}

    state: dict[int, _RowState] = {}

    def st(r: int) -> _RowState:
        s = state.get(r)
        if s is None:
            s = _RowState()
            if r in const_rows:
                s.written, s.origin = True, "const"
            elif not stream.from_reset:
                # unknown pre-state: assume initialized, so uninit-read
                # is only checked on from-reset streams
                s.written, s.origin = True, "host"
            state[r] = s
        return s

    frac_row: int | None = None
    mra = stream.multi_row_act

    for w, (op, rows) in enumerate(zip(stream.ops, stream.rows)):
        sid = stream.segs[w] if w < len(stream.segs) else None
        # ---- arch / protocol conformance ---------------------------- #
        if arch is not None:
            if op in (PuDOp.TRA, PuDOp.NOT) and arch is not PuDArch.MODIFIED:
                out.append(Diagnostic(
                    "PL105", "error",
                    f"{op.value} requires Modified (SIMDRAM) PuD, stream "
                    f"records arch={arch.value}",
                    stream.label, w, sid))
            if op in (PuDOp.APA, PuDOp.FRAC) and \
                    arch is not PuDArch.UNMODIFIED:
                out.append(Diagnostic(
                    "PL105", "error",
                    f"{op.value} is an Unmodified-PuD operation, stream "
                    f"records arch={arch.value}",
                    stream.label, w, sid))
        if op is PuDOp.MRACT:
            span = int(rows[2])
            if mra is not None and not 1 <= span <= mra:
                out.append(Diagnostic(
                    "PL301", "error",
                    f"MRACT span {span} exceeds the stream's "
                    f"multi_row_act={mra} capability",
                    stream.label, w, sid, row=int(rows[1])))
        if op is PuDOp.APA:
            if frac_row is None:
                out.append(Diagnostic(
                    "PL104", "error",
                    "APA without a live Frac'd group row: the 4-row "
                    "activation would be an undefined 4-input majority",
                    stream.label, w, sid))
            frac_row = None

        reads, writes = wave_accesses(op, rows)

        # ---- reads -------------------------------------------------- #
        for r in reads:
            if not 0 <= r < num_rows:
                out.append(Diagnostic(
                    "PL103", "error",
                    f"row operand {r} outside [0, {num_rows})",
                    stream.label, w, sid, row=r))
                continue
            s = st(r)
            if (not s.written and op not in _CLONE_OPS
                    and op is not PuDOp.READ):
                out.append(Diagnostic(
                    "PL101", "error",
                    f"{op.value} reads row {r}, which no earlier wave "
                    "wrote (undefined DRAM power-up content)",
                    stream.label, w, sid, row=r))
            if (s.stage_consumed and op in (PuDOp.AND, PuDOp.OR)
                    and r in staging):
                out.append(Diagnostic(
                    "PL107", "error",
                    f"{op.value} reads staging row {r}, already consumed "
                    "by an earlier merge and never re-staged",
                    stream.label, w, sid, row=r))
            s.read_since_write = True

        # an Ambit merge consumes its staged operands (a later merge
        # must re-stage); TRA/APA rewrite their group below, which
        # clears the flag again -- only AND/OR leave operands consumed
        if op in (PuDOp.AND, PuDOp.OR, PuDOp.TRA, PuDOp.APA):
            for r in reads:
                if r in staging and 0 <= r < num_rows:
                    st(r).stage_consumed = True

        # ---- writes ------------------------------------------------- #
        src_written = True
        if op in (PuDOp.ROWCOPY,):   # compute staging copy: propagate
            src_written = all(
                st(r).written for r in reads if 0 <= r < num_rows)
        for r in writes:
            if not 0 <= r < num_rows:
                out.append(Diagnostic(
                    "PL103", "error",
                    f"row operand {r} outside [0, {num_rows})",
                    stream.label, w, sid, row=r))
                continue
            if r in const_rows:
                name = "ROW_ZERO" if r == row_zero else "ROW_ONE"
                out.append(Diagnostic(
                    "PL102", "error",
                    f"{op.value} writes constant row {name} ({r}); "
                    "every later rowinit/Ambit control consumer is "
                    "corrupted",
                    stream.label, w, sid, row=r))
            s = st(r)
            if (s.origin == "result" and not s.read_since_write
                    and r < reserved0 and op is not PuDOp.FRAC):
                out.append(Diagnostic(
                    "PL106", "warning",
                    f"{op.value} overwrites row {r}, a compute result "
                    "nothing has read (double-buffer park collision?)",
                    stream.label, w, sid, row=r))
            if op is PuDOp.FRAC:
                # the Frac'd row is the neutral APA member: reading it
                # is defined regardless of its previous content
                s.written, s.origin = True, "frac"
            elif op in (PuDOp.TRA, PuDOp.APA, PuDOp.AND, PuDOp.OR,
                        PuDOp.NOT):
                s.written, s.origin = True, "result"
            elif op is PuDOp.WRITE:
                s.written, s.origin = True, "host"
            elif op in _CLONE_OPS:
                # relocation / replication: destination is initialized
                # even when this stream never wrote the source (bulk
                # moves and cross-group clones carry foreign payloads)
                s.written, s.origin = True, "copy"
            else:   # ROWCOPY
                s.written, s.origin = src_written, "copy"
            s.read_since_write = False
            s.stage_consumed = False
            if frac_row == r and op is not PuDOp.FRAC:
                frac_row = None   # overwriting the neutral row re-arms it

        if op is PuDOp.FRAC:
            r = int(rows[0])
            frac_row = r
            if arch is PuDArch.UNMODIFIED and num_rows is not None \
                    and r not in g_rows:
                out.append(Diagnostic(
                    "PL103", "error",
                    f"FRAC targets row {r}, outside the fixed activation "
                    f"group {sorted(g_rows)}",
                    stream.label, w, sid, row=r))


# --------------------------------------------------------------------- #
# Pass 2: hazard / race detection over the dependency graph
# --------------------------------------------------------------------- #
def _dep_graph(stream, out: list[Diagnostic]):
    """Ancestor bitmasks over the segment + host-event node graph.

    Returns ``(seg_anc, ok)`` where ``seg_anc[sid]`` is an int bitmask
    of ancestor *node* indices (segments at their sid, host events
    offset by the segment count).  ``ok`` is False when the graph is
    unusable (cycle or dangling references) -- callers skip the
    pairwise hazard check then."""
    n_seg = len(stream.segments)
    hid_index = {h.hid: n_seg + i for i, h in enumerate(stream.host_events)}
    n = n_seg + len(stream.host_events)
    parents: list[list[int]] = [[] for _ in range(n)]
    ok = True

    def resolve(after, after_host, node: int, what: str) -> None:
        nonlocal ok
        for d in after:
            if not 0 <= d < n_seg:
                out.append(Diagnostic(
                    "PL205", "error",
                    f"{what} references unknown segment {d}",
                    stream.label, seg=d))
                ok = False
                continue
            parents[node].append(d)
        for hd in after_host:
            hi = hid_index.get(hd)
            if hi is None:
                out.append(Diagnostic(
                    "PL205", "error",
                    f"{what} references unknown host event {hd}",
                    stream.label))
                ok = False
                continue
            parents[node].append(hi)

    for s in stream.segments:
        resolve(s.after, s.after_host, s.sid, f"segment {s.sid}")
    for h in stream.host_events:
        resolve(h.after, h.after_host, hid_index[h.hid],
                f"host event {h.hid}")
    if not ok:
        return None, False

    # Kahn topological order; leftovers == cycle.
    children: list[list[int]] = [[] for _ in range(n)]
    indeg = [0] * n
    for node, ps in enumerate(parents):
        for p in ps:
            children[p].append(node)
            indeg[node] += 1
    ready = [i for i in range(n) if indeg[i] == 0]
    order: list[int] = []
    while ready:
        node = ready.pop()
        order.append(node)
        for c in children[node]:
            indeg[c] -= 1
            if indeg[c] == 0:
                ready.append(c)
    if len(order) != n:
        stuck = [i for i in range(n) if indeg[i] > 0]
        out.append(Diagnostic(
            "PL206", "error",
            "dependency cycle in stream segments / host events "
            f"(nodes {stuck[:6]}): the scheduler would deadlock",
            stream.label, seg=stuck[0] if stuck and stuck[0] < n_seg
            else None))
        return None, False
    anc = [0] * n
    for node in order:
        m = 0
        for p in parents[node]:
            m |= anc[p] | (1 << p)
        anc[node] = m
    return anc, True


def _hazard_pass(stream, out: list[Diagnostic]) -> None:
    if not stream.rows:
        return
    anc, ok = _dep_graph(stream, out)

    # PL204: host events consuming readout bytes must reach a READ wave
    # through their dependency closure.
    n_seg = len(stream.segments)
    if ok:
        segs_with_read = set()
        for w, op in enumerate(stream.ops):
            if op is PuDOp.READ:
                segs_with_read.add(stream.segs[w])
        for i, h in enumerate(stream.host_events):
            if h.bytes_in <= 0:
                continue
            mask = anc[n_seg + i]
            if not any((mask >> s) & 1 for s in segs_with_read):
                out.append(Diagnostic(
                    "PL204", "error",
                    f"host event {h.hid} ({h.label or 'unlabeled'}) "
                    f"consumes {h.bytes_in:.0f} readout bytes but no READ "
                    "wave is in its dependency closure -- the scheduler "
                    "may start the merge before its data exists",
                    stream.label))
    if not ok:
        return

    def ordered(a: int, b: int) -> bool:
        return bool((anc[b] >> a) & 1) or bool((anc[a] >> b) & 1)

    # Per (row, segment) access summary.
    per_row: dict[int, dict[int, list]] = {}
    for w, (op, rows) in enumerate(zip(stream.ops, stream.rows)):
        sid = stream.segs[w]
        reads, writes = wave_accesses(op, rows)
        for r in reads:
            acc = per_row.setdefault(r, {}).setdefault(sid, [w, 0, 0])
            acc[1] = 1
        for r in writes:
            acc = per_row.setdefault(r, {}).setdefault(sid, [w, 0, 0])
            acc[2] = 1

    seen_pairs: set[tuple[int, int]] = set()
    for row, by_seg in per_row.items():
        if len(by_seg) < 2:
            continue
        sids = sorted(by_seg, key=lambda s: by_seg[s][0])
        for i in range(len(sids)):
            for j in range(i + 1, len(sids)):
                a, b = sids[i], sids[j]
                fa, ra, wa = by_seg[a]
                fb, rb, wb = by_seg[b]
                if not (wa or wb):
                    continue          # read/read never conflicts
                key = (a, b)
                if key in seen_pairs or ordered(a, b):
                    continue
                seen_pairs.add(key)
                if wa and rb:
                    code, kind = "PL201", "RAW"
                elif wa and wb:
                    code, kind = "PL203", "WAW"
                else:
                    code, kind = "PL202", "WAR"
                la = stream.segments[a].label or a
                lb = stream.segments[b].label or b
                out.append(Diagnostic(
                    code, "error",
                    f"{kind} hazard on row {row}: segments {la!r} (wave "
                    f"{fa}) and {lb!r} (wave {fb}) have no ordering edge "
                    "-- the scheduler may legally reorder them",
                    stream.label, wave=fb, seg=b, row=row))


# --------------------------------------------------------------------- #
# Streams / subarray / device entry points
# --------------------------------------------------------------------- #
def lint_stream(stream) -> LintReport:
    """Passes 1-2 over one :class:`~repro_torch.core.scheduler.GroupStream`."""
    out: list[Diagnostic] = []
    _row_pass(stream, out)
    _hazard_pass(stream, out)
    return LintReport(out)


def lint_streams(streams) -> LintReport:
    report = LintReport()
    for s in streams:
        report.extend(lint_stream(s))
    return report


def lint_subarray(sub, label: str = "subarray") -> LintReport:
    """Lint one :class:`~repro_torch.core.machine.BankedSubarray`'s recorded
    trace (passes 1-2; no placement, so no timeline checks)."""
    from repro_torch.core.scheduler import GroupStream

    stream = GroupStream.from_trace(
        label, sub.trace, {0: {0: sub.num_banks}}, sub.num_cols,
        machine=sub)
    return lint_stream(stream)


def clone_confinement_diags(device) -> list[Diagnostic]:
    """Device-level clone confinement (``PL302``): a cross-group
    RowClone/MRACT may only move rows between groups that share the
    same channel set -- clones ride a channel's internal bus and cannot
    cross channels."""
    out: list[Diagnostic] = []
    sub_channels = {}
    for g in device.groups:
        sub_channels[id(g.sub)] = frozenset(device.footprint(g))
    for gi, g in enumerate(device.groups):
        dst_ch = sub_channels[id(g.sub)]
        label = device._group_label(gi, g)
        for w, e in enumerate(g.sub.trace.entries):
            src = getattr(e, "xsrc", None)
            if src is None:
                continue
            src_ch = sub_channels.get(id(src))
            if src_ch is None:
                continue      # source group freed / on another device
            if src_ch != dst_ch:
                out.append(Diagnostic(
                    "PL302", "error",
                    f"cross-group {e.op.value} clones rows from a group "
                    f"on channels {sorted(src_ch)} into channels "
                    f"{sorted(dst_ch)}: in-DRAM clones cannot cross "
                    "channels (host-load the first replica per channel)",
                    label, wave=w, seg=e.seg))
    return out


def lint_device(device) -> LintReport:
    """Lint every placed group's stream (passes 1-2) plus the
    device-level clone confinement rule (``PL302``)."""
    report = lint_streams(device.streams())
    report.diagnostics.extend(clone_confinement_diags(device))
    return report


# --------------------------------------------------------------------- #
# Pass 4: serving-layer admission conformance
# --------------------------------------------------------------------- #
def serving_admission_diags(records) -> list[Diagnostic]:
    """``PL401``: a dispatched request whose admitted absolute deadline
    already precedes its predicted batch start -- the serving loop
    committed work that cannot possibly meet its SLO and should have
    shed it at admission instead.

    ``records`` are dicts the serving loop emits per *dispatched*
    request: ``{"rid", "start_ns"`` (predicted batch start on the
    simulated clock), ``"deadline_ns"`` (absolute; ``None`` = no SLO),
    optionally ``"cls"}``.  Requests without a deadline never
    diagnose."""
    out: list[Diagnostic] = []
    for rec in records:
        deadline = rec.get("deadline_ns")
        start = rec.get("start_ns", 0.0)
        if deadline is None or deadline >= start - _EPS:
            continue
        cls = rec.get("cls")
        who = f"request {rec.get('rid')}" + (f" [{cls}]" if cls else "")
        out.append(Diagnostic(
            "PL401", "error",
            f"{who}: absolute deadline {deadline:.0f}ns precedes its "
            f"predicted batch start {start:.0f}ns -- admission should "
            "have shed this request, not scheduled it", group="serving"))
    return out


# --------------------------------------------------------------------- #
# Pass 5: representation conformance
# --------------------------------------------------------------------- #
def representation_diags(engines, plans, group: str = "") -> list[Diagnostic]:
    """``PL501``: each engine's encoded LUT layout must match the
    :class:`~repro_torch.core.encoding.ColumnPlan` declared for its column.

    ``engines`` are the per-column :class:`~repro_torch.core.clutch
    .ClutchEngine`\\ s of one bank group, ``plans`` the session's
    declared per-column plans (zipped positionally).  A mismatch in bit
    width, chunk widths (and therefore LUT plane count), or complement-
    plane presence is the signature of a stale representation: a
    ``recode_column`` whose evict/reload rebuild was skipped, so the
    banks still hold the OLD planes while the session prices and plans
    against the new ones."""
    out: list[Diagnostic] = []
    for i, (eng, plan) in enumerate(zip(engines, plans)):
        want = plan.chunk_plan
        got = eng.layout.plan
        if got != want:
            out.append(Diagnostic(
                "PL501", "error",
                f"column {i}: encoded LUT layout has chunk widths "
                f"{got.widths} ({got.rows_required} plane rows), but the "
                f"declared ColumnPlan(n_bits={plan.n_bits}, num_chunks="
                f"{plan.num_chunks}) requires widths {want.widths} "
                f"({want.rows_required} plane rows) -- stale planes from "
                "a recode that skipped the rebuild?", group))
            continue
        lc = getattr(eng, "layout_c", None)
        if lc is not None and lc.plan != want:
            out.append(Diagnostic(
                "PL501", "error",
                f"column {i}: complement LUT layout has chunk widths "
                f"{lc.plan.widths}, but the declared ColumnPlan requires "
                f"{want.widths} -- native and complement planes disagree "
                "after a partial re-encode", group))
    return out


class TraceCollector:
    """Drop-in sink for ``repro_torch.core.machine._LINT_REGISTRY``.

    Holds no strong reference to the subarrays themselves (their state
    tensors can be gigabytes on the card): each registration installs a
    ``weakref.finalize`` that lints the subarray's trace -- small and
    kept alive by the finalizer -- the moment the subarray dies, so
    short-lived subarrays built deep inside a benchmark or test are
    still swept.  :meth:`drain` force-lints whatever is still alive and
    returns the combined report.
    """

    def __init__(self) -> None:
        self._finalizers: list = []
        self._reports: list[LintReport] = []
        self._serving: list[dict] = []
        self.count = 0

    def add_serving(self, record: dict) -> None:
        """Record one dispatched serving request (see
        :func:`serving_admission_diags`); linted at :meth:`drain`."""
        self._serving.append(dict(record))

    def add(self, sub) -> None:
        self.count += 1
        meta = types.SimpleNamespace(
            num_rows=sub.num_rows, arch=sub.arch,
            multi_row_act=sub.multi_row_act)
        self._finalizers.append(weakref.finalize(
            sub, self._lint, f"sub#{self.count}", sub.trace,
            sub.num_banks, sub.num_cols, meta))

    def _lint(self, label, trace, num_banks, num_cols, meta) -> None:
        from repro_torch.core.scheduler import GroupStream

        stream = GroupStream.from_trace(
            label, trace, {0: {0: num_banks}}, num_cols, machine=meta)
        self._reports.append(lint_stream(stream))

    def drain(self) -> LintReport:
        for fin in self._finalizers:
            fin()   # idempotent: lints survivors now, no-op for the dead
        self._finalizers.clear()
        report = LintReport()
        for r in self._reports:
            report.extend(r)
        self._reports.clear()
        report.diagnostics.extend(serving_admission_diags(self._serving))
        self._serving.clear()
        return report


# --------------------------------------------------------------------- #
# Pass 3: scheduled-timeline conformance
# --------------------------------------------------------------------- #
def _timeline_dep_check(timeline, streams, out: list[Diagnostic]) -> None:
    """PL305/PL307: the scheduled placement must respect the streams'
    effective dependency structure (mirrors the scheduler's own
    ``expand_deps`` / merged-host-node derivation)."""
    by_label = {s.label: s for s in streams}
    # scheduled waves per (group, sid), in start order
    waves: dict[tuple[str, int], list] = {}
    for w in timeline.waves:
        waves.setdefault((w.group, w.seg), []).append(w)
    for ws in waves.values():
        ws.sort(key=lambda w: w.start_ns)
    host_end: dict[str, float] = {}
    for h in timeline.host_spans:
        host_end[h.label] = max(host_end.get(h.label, 0.0), h.end_ns)

    for s in streams:
        wave_sids = set(s.segs)
        node_key = {h.hid: h.label or f"{s.label}#h{h.hid}"
                    for h in s.host_events}

        def expand(after, after_host):
            segs, hosts = [], list(after_host)
            seen, stack = set(), list(after)
            while stack:
                d = stack.pop()
                if d in seen or not 0 <= d < len(s.segments):
                    continue
                seen.add(d)
                if d in wave_sids:
                    segs.append(d)
                else:
                    hosts.extend(s.segments[d].after_host)
                    stack.extend(s.segments[d].after)
            return segs, hosts

        # record-order ops per sid, to cross-check against the timeline
        rec_ops: dict[int, list] = {}
        for w, sid in enumerate(s.segs):
            rec_ops.setdefault(sid, []).append(s.ops[w])
        for sid, ops in rec_ops.items():
            placed = waves.get((s.label, sid), [])
            if [w.op for w in placed] != ops:
                out.append(Diagnostic(
                    "PL307", "error",
                    f"segment {sid}: scheduled waves "
                    f"{[w.op.value for w in placed]} do not match the "
                    f"recorded stream {[o.value for o in ops]}",
                    s.label, seg=sid))
                continue
            # chain order within the segment
            for prev, nxt in zip(placed, placed[1:]):
                if nxt.start_ns < prev.end_ns - _EPS:
                    out.append(Diagnostic(
                        "PL305", "error",
                        f"segment {sid}: wave at {nxt.start_ns:.1f}ns "
                        f"starts before its in-segment predecessor ends "
                        f"({prev.end_ns:.1f}ns)",
                        s.label, seg=sid))
            # cross-segment / host-barrier ordering
            seg = s.segments[sid]
            dep_segs, dep_hosts = expand(seg.after, seg.after_host)
            t0 = placed[0].start_ns
            for d in dep_segs:
                dep_end = max((w.end_ns
                               for w in waves.get((s.label, d), [])),
                              default=0.0)
                if t0 < dep_end - _EPS:
                    out.append(Diagnostic(
                        "PL305", "error",
                        f"segment {sid} starts at {t0:.1f}ns, before its "
                        f"dependency segment {d} completed at "
                        f"{dep_end:.1f}ns",
                        s.label, seg=sid))
            for hd in dep_hosts:
                key = node_key.get(hd)
                end = host_end.get(key, None) if key else None
                if end is not None and t0 < end - _EPS:
                    out.append(Diagnostic(
                        "PL305", "error",
                        f"segment {sid} starts at {t0:.1f}ns, before its "
                        f"host barrier {key!r} completed at {end:.1f}ns",
                        s.label, seg=sid))
    # groups on the timeline that no stream describes
    for (label, sid) in waves:
        if label not in by_label:
            out.append(Diagnostic(
                "PL307", "error",
                f"timeline contains waves for group {label!r} absent "
                "from the supplied streams", label, seg=sid))


def lint_timeline(timeline, sys_cfg=None, streams=None) -> LintReport:
    """Pass 3 over a scheduled :class:`~repro_torch.core.scheduler.Timeline`
    (protocol/capability conformance), plus passes 1-2 when the
    scheduled ``streams`` are supplied.  ``sys_cfg`` enables the
    capability checks (MRACT span) and the tFAW/tRRD duration audit."""
    report = LintReport()
    out = report.diagnostics
    if streams is not None:
        report.extend(lint_streams(streams))

    sched = None
    by_label = {}
    if sys_cfg is not None and streams is not None:
        from repro_torch.core.scheduler import ChannelScheduler

        sched = ChannelScheduler(sys_cfg)
        by_label = {s.label: s for s in streams}

    for w in timeline.waves:
        if w.op not in (PuDOp.READ, PuDOp.WRITE) and w.io_bytes:
            out.append(Diagnostic(
                "PL306", "error",
                f"in-DRAM {w.op.value} wave reports io_bytes="
                f"{w.io_bytes:.0f}; clone/compute waves never move bytes "
                "over the pins", w.group, seg=w.seg))
        if (w.op is PuDOp.MRACT and sys_cfg is not None
                and len(w.rows) >= 3):
            span = int(w.rows[2])
            if not 1 <= span <= sys_cfg.multi_row_act:
                out.append(Diagnostic(
                    "PL301", "error",
                    f"scheduled MRACT span {span} exceeds "
                    f"SystemConfig.multi_row_act={sys_cfg.multi_row_act}",
                    w.group, seg=w.seg))
        if sched is not None:
            s = by_label.get(w.group)
            if s is not None:
                want = sched.wave_duration_ns(w.op, s)
                if w.duration_ns < want - _EPS:
                    out.append(Diagnostic(
                        "PL304", "error",
                        f"{w.op.value} wave runs {w.duration_ns:.2f}ns, "
                        f"shorter than the {want:.2f}ns its tFAW/tRRD "
                        "stagger and op latency require",
                        w.group, seg=w.seg))

    # channel exclusivity
    per_channel: dict[int, list] = {}
    for w in timeline.waves:
        for c in w.channels:
            per_channel.setdefault(c, []).append(w)
    for c, ws in per_channel.items():
        ws.sort(key=lambda w: (w.start_ns, w.end_ns))
        for prev, nxt in zip(ws, ws[1:]):
            if nxt.start_ns < prev.end_ns - _EPS:
                out.append(Diagnostic(
                    "PL303", "error",
                    f"channel {c}: {nxt.group}/{nxt.op.value} wave at "
                    f"{nxt.start_ns:.1f}ns overlaps {prev.group}/"
                    f"{prev.op.value} ending {prev.end_ns:.1f}ns (waves "
                    "hold their channels exclusively)",
                    nxt.group, seg=nxt.seg))

    if streams is not None:
        _timeline_dep_check(timeline, streams, out)
    return report
