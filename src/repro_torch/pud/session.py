"""`PudSession`: the port's front door, with the reference's two backends.

    from repro_torch.pud import PudSession, Q1, Q2

    session = PudSession(num_devices=2)          # device="cuda"
    table = session.create_table(t)              # loaded into bank state
    job = session.query(table, Q2(fi=0, x0=1, x1=9, fj=1, y0=2, y1=8))
    job.result                                   # == NumPy reference
    job.stats.overlapped_ns                      # modeled DRAM time
    fast = session.query(table, Q1(fi=0, x0=1, x1=9), backend="fused")
    fast.wallclock_ns                            # the card's kernels

Two backends, one contract (the reference package's ``pud/session.py``):

* ``backend="machine"`` (the default) runs each job on the command-level
  PuD model (:mod:`repro_torch.core`) whose bank state lives on the
  card: :class:`~repro_torch.core.device.PuDDevice` fleets, the
  :class:`~repro_torch.pud.planner.Planner`'s bank lifetimes (a
  placement that does not fit is ``"queued"``; cold resources are
  evicted and rebuilt on use; defragmentation relocates groups by
  RowClone), and the executors of :mod:`repro_torch.pud.executors`.  A
  job returns its barrier-aware ``stats`` and scheduled ``timeline``:
  modeled DRAM time for ``sys_cfg`` (DDR4 on ``cost.DESKTOP``), never a
  measurement of the card.
* ``backend="fused"`` runs the same jobs through the card's hand-written
  kernels (:class:`~repro_torch.kernels.fused_session.FusedTableExec`,
  :class:`~repro_torch.kernels.fused_session.FusedGbdtExec`) and returns
  the measured ``wallclock_ns`` (clock stopped after
  ``torch.cuda.synchronize()``) with ``stats`` and ``timeline`` None.

Results are bit-exact between the backends.  ``backend=`` on a job
overrides the session's.  A machine session admits every resource
through the planner at creation, and its fused jobs build from the
machine executor's ``fused_config()``; a fused session lays resources
out for the kernels alone (same shard count and chunk plans, no bank
capacity) and admits one to the planner only at its first machine job,
which raises the planner's queued or ``MemoryError`` text when it does
not fit.

``device`` is the card unless the caller names another; with no CUDA
and no ``device`` the constructor raises.  ``device="cpu"`` runs the
model's state and every kernel's plain version on the host (what the
CPU tests use).

Adaptive representation: ``create_table(..., representation="auto")``
and ``load_forest``'s counterpart let
:func:`~repro_torch.pud.planner.choose_representation` give each column
its own ``(n_bits, num_chunks)``; ``handle.representation`` reports the
plans; :meth:`PudSession.recode_column` re-encodes one column by
evicting the resource, whose next job rebuilds it.

Verification: ``verify`` runs :mod:`repro_torch.analysis.pudlint` over
every machine job's trimmed streams and scheduled timeline, each
device's clone confinement (PL302) and each engine's LUT layout against
its declared plans (PL501): ``"strict"`` raises
:class:`~repro_torch.analysis.PudLintError`, ``"warn"`` warns, ``"off"``
skips.  ``None`` takes :attr:`PudSession.DEFAULT_VERIFY` (``"off"``;
the port's tests flip it to ``"strict"``).  Fused jobs record no
streams and are not linted, as in the reference.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.apps.gbdt import PAPER_GBDT_CHUNKS
from repro_torch.apps.predicate import PAPER_PREDICATE_CHUNKS, Table, fit_chunks
from repro_torch.core import cost
from repro_torch.core.device import PuDDevice
from repro_torch.core.encoding import ColumnPlan, column_footprint_rows
from repro_torch.core.machine import NUM_RESERVED, PuDArch
from repro_torch.core.scheduler import (
    ChannelScheduler,
    Timeline,
    rekey_stream,
)
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.fused_session import FusedGbdtExec, FusedTableExec

from .executors import GbdtBatchExecutor, QueryBatchExecutor
from .planner import (
    Planner,
    _default_uniform_chunks,
    choose_forest_plan,
    choose_representation,
)
from .queries import Q1, Q2, Q3, Q4, Q5, Compound

BACKENDS = ("machine", "fused")


@dataclass
class JobResult:
    """One job's outcome: the merged result, plus the cost accounting of
    the backend that ran it.  Machine jobs carry the modeled pipeline
    ``stats`` (:class:`~repro_torch.apps.pipeline.PipelineStats`) and
    the scheduled ``timeline``; fused jobs carry the measured
    ``wallclock_ns`` instead -- ``backend`` says which."""

    result: Any
    stats: Any = None
    timeline: Timeline | None = None
    wallclock_ns: float | None = None
    backend: str = "machine"

    @property
    def makespan_ns(self) -> float:
        """Modeled makespan of a machine job; the measured wall-clock of
        a fused one."""
        if self.stats is not None:
            return self.stats.makespan_ns
        return self.wallclock_ns


@dataclass
class ResourceHandle:
    """Handle to a session resource.  ``status``: on a machine session
    the planner's ``"ready"`` / ``"queued"`` / ``"evicted"`` /
    ``"failed"``; on a fused session ``"ready"`` (device tensors built)
    or ``"evicted"`` (rebuilt on next use); ``"dropped"`` once
    released."""

    name: str
    session: "PudSession" = field(repr=False)

    @property
    def status(self) -> str:
        return self.session._status(self.name)


@dataclass
class TableHandle(ResourceHandle):
    num_records: int = 0
    n_bits: int = 0

    @property
    def representation(self) -> dict:
        """The table's per-column plans and LUT rows beside the fixed
        default's (:meth:`PudSession.representation_report`)."""
        return self.session.representation_report(self)


@dataclass
class ForestHandle(ResourceHandle):
    num_trees: int = 0
    depth: int = 0


@dataclass
class _Recipe:
    """How to build a resource for each backend: ``machine`` places
    bank groups and returns the executor; ``fused`` returns the kernel
    layout (the keyword arguments of the fused executor, without the
    device)."""

    kind: str                       # "table" | "forest"
    machine: Callable[[], Any]
    fused: Callable[[], dict]
    pinned: bool = False


class PudSession:
    """Declarative tables and forests over a fleet of PuD devices, run on
    the machine model or on the card's kernels (see the module
    docstring).  ``num_devices``, ``arch``, ``num_rows`` and ``seed``
    describe the modeled fleet (``seed + 1000 * i`` seeds device ``i``'s
    power-up state); ``hosts`` is its host model (``"shared"`` or
    ``"per-device"``); ``verify`` the lint mode of machine jobs."""

    #: Session-wide default for the ``verify`` knob (``None`` in a
    #: constructor call resolves to this): the port's tests set it to
    #: ``"strict"`` so every machine job they run is linted.
    DEFAULT_VERIFY: str = "off"

    def __init__(self, sys_cfg=cost.DESKTOP, devices=None,
                 num_devices: int = 1, arch: PuDArch = PuDArch.MODIFIED,
                 num_rows: int = 1024, seed: int | None = 0,
                 hosts: str = "shared", backend: str = "machine",
                 verify: str | None = None, device=None) -> None:
        if hosts not in ("shared", "per-device"):
            raise ValueError(
                f"hosts must be 'shared' or 'per-device', got {hosts!r}")
        if backend not in BACKENDS:
            raise ValueError(
                f"backend must be 'machine' or 'fused', got {backend!r}")
        if verify is None:
            verify = self.DEFAULT_VERIFY
        if verify not in ("strict", "warn", "off"):
            raise ValueError(
                f"verify must be 'strict', 'warn' or 'off', got {verify!r}")
        if devices is None and num_devices < 1:
            raise ValueError("need at least one device")
        self.verify = verify
        self.device = resolve_device(device)
        self.sys_cfg = sys_cfg
        #: default backend of jobs; ``backend=`` on a job overrides it
        self.backend = backend
        self.hosts = hosts
        if devices is not None:
            self.devices = list(devices)
            archs = {d.arch for d in self.devices}
            if len(archs) != 1:
                raise ValueError(f"devices disagree on arch: {archs}")
            self.arch = next(iter(archs))
        else:
            self.arch = arch
            self.devices = [
                PuDDevice.from_system(sys_cfg, arch, num_rows=num_rows,
                                      device=self.device)
                for _ in range(num_devices)
            ]
            for i, d in enumerate(self.devices):
                d._seed = None if seed is None else seed + 1000 * i
        if not self.devices:
            raise ValueError("need at least one device")
        self.num_devices = len(self.devices)
        self.num_rows = min(d.num_rows for d in self.devices)
        self.planner = Planner(self.devices)
        self._recipes: dict[str, _Recipe] = {}
        # fused executors by resource name (dropped on drop/evict)
        self._fused: dict[str, Any] = {}
        self._auto = 0
        # Adaptive representation, by resource name: a table's data, its
        # per-column ColumnPlans (a list recode_column edits in place;
        # absent for a fixed table until its first recode) and an auto
        # forest's threshold plan.  Build closures read the plans LATE,
        # so the rebuild after a recode lays the new ones out.
        self._tables: dict[str, Any] = {}
        self._plans: dict[str, list] = {}
        self._forest_plans: dict[str, ColumnPlan] = {}

    def _auto_name(self, prefix: str) -> str:
        self._auto += 1
        return f"{prefix}{self._auto}"

    def _status(self, name: str) -> str:
        if name not in self._recipes:
            return "dropped"
        if self.backend == "machine":
            return self.planner.resources[name].state
        return "ready" if name in self._fused else "evicted"

    # ------------------------------------------------------------------ #
    # Resources
    # ------------------------------------------------------------------ #
    def create_table(self, data, name: str | None = None,
                     n_bits: int | None = None,
                     shards_per_device: int = 2, method: str = "clutch",
                     num_chunks: int | None = None,
                     cols_per_bank: int = 65536, channels="auto",
                     representation: str = "fixed", headroom: int = 0,
                     pinned: bool = False) -> TableHandle:
        """Register a table.  ``data`` is a :class:`~repro_torch.apps.
        predicate.Table`, or a ``[records, features]`` integer array with
        ``n_bits`` giving the width.  Records shard across devices, then
        across ``shards_per_device`` channel-spread bank groups per
        device (``method``: ``"clutch"`` or ``"bitserial"`` engines).

        ``representation="auto"`` (clutch only) gives each column the
        ``(n_bits, num_chunks)`` with the least probed makespan for its
        observed values (plus ``headroom`` guard bits), never slower or
        larger than the fixed default; ``"fixed"`` keeps the declared
        width and one chunk count (``num_chunks`` or the paper's)."""
        if representation not in ("fixed", "auto"):
            raise ValueError(
                f"representation must be 'fixed' or 'auto', "
                f"got {representation!r}")
        if shards_per_device < 1:
            raise ValueError("need at least one shard per device")
        if not isinstance(data, Table):
            arr = np.asarray(data)
            if n_bits is None:
                raise ValueError(
                    "n_bits is required when data is a raw array")
            data = Table(n_bits=n_bits,
                         features=[np.ascontiguousarray(arr[:, f],
                                                        dtype=np.uint64)
                                   for f in range(arr.shape[1])])
        name = name or self._auto_name("table")
        self._check_new(name)
        if representation == "auto":
            if method != "clutch":
                raise ValueError(
                    "representation='auto' requires method='clutch' "
                    "(bit-serial tables have no chunk plan to optimize)")
            self._plans[name] = choose_representation(
                data, self.arch, num_rows=self.num_rows,
                sys_cfg=self.sys_cfg, headroom=headroom,
                num_chunks=num_chunks)
        self._tables[name] = data

        def machine():
            # the plan set is read here, not captured: recode_column
            # changes it and rebuilds through this closure
            plans = self._plans.get(name)
            return QueryBatchExecutor(
                data, self.arch, self.devices,
                shards_per_device=shards_per_device, method=method,
                num_chunks=num_chunks, cols_per_bank=cols_per_bank,
                channels=channels, hosts=self.hosts,
                plans=tuple(plans) if plans is not None else None)

        def fused() -> dict:
            # QueryBatchExecutor.fused_config without placing anything
            if method != "clutch":
                raise TypeError(
                    "the fused backend supports the clutch method only "
                    "(bit-serial tables have no chunk plan)")
            plans = self._plans.get(name)
            cfg = {"table": data,
                   "num_shards": self.num_devices * shards_per_device}
            if plans is None:
                cfg["num_chunks"] = fit_chunks(
                    data.n_bits, len(data.features), self.arch,
                    num_chunks or PAPER_PREDICATE_CHUNKS[(data.n_bits,
                                                          self.arch)],
                    self.num_rows)
            else:
                cfg["num_chunks"] = max(p.num_chunks for p in plans)
                cfg["plans"] = tuple(plans)
            return cfg

        self._admit(name, _Recipe("table", machine, fused, pinned))
        return TableHandle(name=name, session=self,
                           num_records=data.num_records, n_bits=data.n_bits)

    def load_forest(self, forest, name: str | None = None,
                    groups_per_device: int = 2, banks_per_group: int = 4,
                    num_chunks: int | None = None,
                    channels="auto", replicate: str = "rowclone",
                    representation: str = "fixed", headroom: int = 0,
                    pinned: bool = False) -> ForestHandle:
        """Register an oblivious forest: thresholds and one-hot masks
        replicated into ``groups_per_device`` channel-spread groups of
        ``banks_per_group`` banks on every device (``replicate=
        "rowclone"`` host-loads each channel's first replica and clones
        the rest in-DRAM; ``"host"`` loads every replica).
        ``representation="auto"`` sizes the threshold LUT to the
        observed thresholds (:func:`~repro_torch.pud.planner.
        choose_forest_plan`)."""
        if representation not in ("fixed", "auto"):
            raise ValueError(
                f"representation must be 'fixed' or 'auto', "
                f"got {representation!r}")
        name = name or self._auto_name("forest")
        self._check_new(name)
        if representation == "auto":
            self._forest_plans[name] = choose_forest_plan(
                forest, self.arch, num_rows=self.num_rows,
                sys_cfg=self.sys_cfg, headroom=headroom,
                num_chunks=num_chunks)

        def machine():
            return GbdtBatchExecutor(
                forest, self.arch, self.devices,
                groups_per_device=groups_per_device,
                banks_per_group=banks_per_group, num_chunks=num_chunks,
                channels=channels, hosts=self.hosts,
                replicate=replicate,
                plan=self._forest_plans.get(name))

        def fused() -> dict:
            # GbdtBatchExecutor.fused_config without placing anything
            plan = self._forest_plans.get(name)
            cfg = {"forest": forest, "num_chunks": plan.num_chunks
                   if plan is not None
                   else num_chunks or PAPER_GBDT_CHUNKS[forest.n_bits]}
            if plan is not None:
                cfg["plan"] = plan
            return cfg

        self._admit(name, _Recipe("forest", machine, fused, pinned))
        return ForestHandle(name=name, session=self,
                            num_trees=forest.num_trees, depth=forest.depth)

    def _check_new(self, name: str) -> None:
        if name in self._recipes:
            raise ValueError(f"resource {name!r} already exists")

    def _admit(self, name: str, recipe: _Recipe) -> None:
        """A machine session hands the resource to the planner (placed,
        or queued for capacity); a fused session builds its kernel
        layout now."""
        self._recipes[name] = recipe
        try:
            if self.backend == "machine":
                self.planner.admit(name, recipe.kind, recipe.machine,
                                   pinned=recipe.pinned)
            else:
                self._fused_exec(name, recipe.kind)
        except Exception:
            # a recipe that cannot build is the caller's error: forget
            # it, so the name stays usable
            self._forget(name)
            raise

    def _forget(self, name: str) -> None:
        for d in (self._recipes, self._fused, self._tables, self._plans,
                  self._forest_plans):
            d.pop(name, None)

    def drop(self, handle: ResourceHandle) -> None:
        """Release a resource: its banks coalesce back into each
        device's free map (the admission queue then drains FIFO) and its
        device tensors are freed."""
        if self.backend == "machine" or \
                handle.name in self.planner.resources:
            self.planner.release(handle.name)
        self._forget(handle.name)

    def evict(self, handle: ResourceHandle) -> None:
        """Reclaim a resource's banks and device tensors now; its next
        job rebuilds them."""
        r = self.planner.resources.get(handle.name)
        if self.backend == "machine" or (r is not None
                                         and r.state == "ready"):
            self.planner.evict(handle.name)
        self._fused.pop(handle.name, None)

    # ------------------------------------------------------------------ #
    # Adaptive representation
    # ------------------------------------------------------------------ #
    def recode_column(self, handle: TableHandle, column: int,
                      n_bits: int | None = None,
                      num_chunks: int | None = None) -> ColumnPlan:
        """Re-encode one column under a new ``(n_bits, num_chunks)``
        (omitted arguments keep the column's current value) and evict
        the table: its next job rebuilds it with the new plan.  A fixed
        table first gets declared-width plans for every column.
        Returns the new :class:`ColumnPlan`."""
        name = handle.name
        table = self._tables.get(name)
        if table is None:
            raise KeyError(f"unknown table {handle.name!r} "
                           "(dropped, or from another session?)")
        n_feat = len(table.features)
        if not 0 <= column < n_feat:
            raise IndexError(
                f"column {column} out of range for {n_feat}-feature table")
        plans = self._plans.get(name)
        if plans is None:
            c_def = _default_uniform_chunks(
                table.n_bits, self.arch, n_feat, self.num_rows)
            plans = [ColumnPlan(table.n_bits, c_def)
                     for _ in range(n_feat)]
            self._plans[name] = plans
        old = plans[column]
        bits = old.n_bits if n_bits is None else int(n_bits)
        vals = table.features[column]
        if vals.size and int(vals.max()) >= (1 << bits):
            raise ValueError(
                f"column {column}: values reach {int(vals.max())}, which "
                f"overflows a {bits}-bit recode "
                f"(representable range [0, {(1 << bits) - 1}])")
        chunks = (min(old.num_chunks, bits) if num_chunks is None
                  else int(num_chunks))
        new = ColumnPlan(bits, chunks)
        plans[column] = new
        # the subarray's row budget, checked here so a recode that
        # cannot fit fails now, with the plan set rolled back
        mult = 2 if self.arch is PuDArch.UNMODIFIED else 1
        need = 2 + 4 + 2 + mult * sum(p.rows_required for p in plans)
        budget = self.num_rows - NUM_RESERVED
        if need > budget:
            plans[column] = old
            raise MemoryError(
                f"recode to {new} needs {need} rows > budget {budget} "
                f"({self.num_rows}-row subarray); pick more chunks or "
                "fewer bits")
        r = self.planner.resources.get(name)
        if r is not None and r.state == "ready":
            self.planner.evict(name)
        self._fused.pop(name, None)
        return new

    def representation_report(self, handle: TableHandle) -> dict:
        """A table's active plans (``mode="auto"`` after the optimizer or
        a recode, ``"fixed"`` otherwise) and its LUT rows beside the
        fixed uniform default's, in subarray rows (complements counted
        on Unmodified PuD); ``saved_rows`` is the difference."""
        name = handle.name
        table = self._tables.get(name)
        if table is None:
            raise KeyError(f"unknown table {handle.name!r} "
                           "(dropped, or from another session?)")
        n_feat = len(table.features)
        mult = 2 if self.arch is PuDArch.UNMODIFIED else 1
        c_def = _default_uniform_chunks(
            table.n_bits, self.arch, n_feat, self.num_rows)
        fixed_col = column_footprint_rows(table.n_bits, c_def) * mult
        plans = self._plans.get(name)
        columns = []
        total = 0
        for i in range(n_feat):
            if plans is not None:
                p = plans[i]
                rows = p.rows_required * mult
                columns.append({"column": i, "n_bits": p.n_bits,
                                "num_chunks": p.num_chunks,
                                "lut_rows": rows})
            else:
                rows = fixed_col
                columns.append({"column": i, "n_bits": table.n_bits,
                                "num_chunks": c_def, "lut_rows": rows})
            total += rows
        fixed_total = n_feat * fixed_col
        return {"mode": "auto" if plans is not None else "fixed",
                "columns": columns, "lut_rows": total,
                "fixed_lut_rows": fixed_total,
                "saved_rows": fixed_total - total}

    # ------------------------------------------------------------------ #
    # Serving hooks (autoscaler knobs)
    # ------------------------------------------------------------------ #
    def set_host_lanes(self, k: int) -> None:
        """Re-provision the modeled host's merge lanes; takes effect on
        the next scheduled job."""
        from dataclasses import replace

        if k < 1:
            raise ValueError(f"host_lanes must be >= 1, got {k}")
        self.sys_cfg = replace(self.sys_cfg, host_lanes=k)

    def set_hosts(self, mode: str) -> None:
        """Switch the fleet host model (``"shared"`` / ``"per-device"``)
        for later jobs; ready executors are re-pointed in place."""
        if mode not in ("shared", "per-device"):
            raise ValueError(
                f"hosts must be 'shared' or 'per-device', got {mode!r}")
        self.hosts = mode
        for r in self.planner.resources.values():
            if r.executor is not None:
                r.executor.hosts = mode

    # ------------------------------------------------------------------ #
    # Executors
    # ------------------------------------------------------------------ #
    def resource_kind(self, name: str) -> str | None:
        """``"table"`` or ``"forest"`` for a resource of this session;
        ``None`` for a name it does not hold (unknown or dropped)."""
        recipe = self._recipes.get(name)
        return None if recipe is None else recipe.kind

    def _recipe(self, name: str, kind: str | None) -> _Recipe:
        recipe = self._recipes.get(name)
        if recipe is None:
            raise KeyError(f"unknown resource {name!r} "
                           "(dropped, or from another session?)")
        if kind is not None and recipe.kind != kind:
            raise TypeError(
                f"resource {name!r} is a {recipe.kind}, not a {kind}")
        return recipe

    def _machine_exec(self, name: str, kind: str | None = None):
        """The resource's machine executor: admitted to the planner on
        first use in a fused session, reloaded if evicted; raises the
        planner's text while it is queued or cannot be placed."""
        recipe = self._recipe(name, kind)
        if name not in self.planner.resources:
            self.planner.admit(name, recipe.kind, recipe.machine,
                               pinned=recipe.pinned)
        return self.planner.ensure_ready(name)

    def _fused_exec(self, name: str, kind: str | None = None, ex=None):
        """The resource's fused executor, built on first use: from the
        machine executor ``ex``'s ``fused_config()`` on a machine
        session (the same layout both backends evaluate), from the
        recipe's layout on a fused one."""
        recipe = self._recipe(name, kind)
        fx = self._fused.get(name)
        if fx is None:
            if self.backend == "machine":
                ex = ex if ex is not None else self._machine_exec(name)
                cfg = ex.fused_config()
            else:
                cfg = recipe.fused()
            cls = FusedTableExec if recipe.kind == "table" else FusedGbdtExec
            fx = self._fused[name] = cls(**cfg, device=self.device)
        return fx

    def executor(self, handle: ResourceHandle):
        """The resource's executor for the session's backend (rebuilt
        if evicted): the machine executor (engines, ``wave_width``,
        ``placements``, ``fused_config()``) or the fused one (LUT
        tensors, ``launch_counts`` and, for forests, ``leaf_addrs``)."""
        if self.backend == "machine":
            return self._machine_exec(handle.name)
        return self._fused_exec(handle.name)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _job_fused_exec(self, name: str, kind: str):
        """A fused job's executor.  On a machine session the job first
        readies the machine resource, as the reference's does (the
        planner's use clock ticks; an evicted resource reloads; a queued
        one raises)."""
        ex = self._machine_exec(name, kind) if self.backend == "machine" \
            else None
        return self._fused_exec(name, kind, ex)

    def _backend(self, backend: str | None) -> str:
        backend = backend or self.backend
        if backend not in BACKENDS:
            raise ValueError(
                f"backend must be 'machine' or 'fused', got {backend!r}")
        return backend

    def _lint_job(self, ex, timeline: Timeline) -> None:
        """Run pudlint over a machine job's trimmed streams and scheduled
        timeline (plus each device's clone-confinement rule and the
        PL501 audit of every engine's LUT layout against the declared
        plans), applying the session's ``verify`` mode."""
        if self.verify == "off":
            return
        from repro_torch.analysis import pudlint

        report = pudlint.lint_timeline(
            timeline, sys_cfg=self.sys_cfg, streams=ex._job_streams())
        for dev in dict.fromkeys(d for d, _ in ex.placements):
            report.diagnostics.extend(
                pudlint.clone_confinement_diags(dev))
        plans = getattr(ex, "plans", None)
        if plans is not None:
            for eng in ex.engines:
                report.diagnostics.extend(pudlint.representation_diags(
                    eng.engines, plans, group=eng.label))
        plan = getattr(ex, "plan", None)
        if plan is not None:
            for eng in ex.engines:
                report.diagnostics.extend(pudlint.representation_diags(
                    [eng.engine], [plan], group=eng.label))
        pudlint.enforce(report, self.verify, where="PudSession job")

    # ------------------------------------------------------------------ #
    # Jobs
    # ------------------------------------------------------------------ #
    def query(self, table: TableHandle,
              queries: "Q1 | Q2 | Q3 | Q4 | Q5 | Compound | Sequence",
              backend: str | None = None) -> JobResult:
        """Run one query, or a batch in order, against a table.  For a
        single query ``result`` is its value, for a batch the list of
        values; each equals the query's NumPy ``reference`` on either
        backend."""
        single = isinstance(queries, (Q1, Q2, Q3, Q4, Q5, Compound))
        batch = [q.to_tuple() for q in ([queries] if single
                                        else list(queries))]
        if self._backend(backend) == "fused":
            fx = self._job_fused_exec(table.name, "table")
            t0 = time.perf_counter()
            results = fx.run(batch)
            self._sync()
            wall = (time.perf_counter() - t0) * 1e9
            return JobResult(result=results[0] if single else results,
                             wallclock_ns=wall, backend="fused")
        ex = self._machine_exec(table.name, "table")
        results = ex.run(batch)
        timeline = ex.schedule(self.sys_cfg)
        self._lint_job(ex, timeline)
        stats = ex.last_stats(self.sys_cfg, timeline=timeline)
        return JobResult(result=results[0] if single else results,
                         stats=stats, timeline=timeline)

    def predict(self, forest: ForestHandle, X: np.ndarray,
                backend: str | None = None) -> JobResult:
        """Batched GBDT inference; ``result`` is the [B] float32
        predictions in input order (one kernel launch for the batch on
        the fused backend)."""
        if self._backend(backend) == "fused":
            fx = self._job_fused_exec(forest.name, "forest")
            t0 = time.perf_counter()
            preds = fx.infer(np.asarray(X))
            self._sync()
            wall = (time.perf_counter() - t0) * 1e9
            return JobResult(result=preds, wallclock_ns=wall,
                             backend="fused")
        ex = self._machine_exec(forest.name, "forest")
        preds = ex.infer(np.asarray(X))
        timeline = ex.schedule(self.sys_cfg)
        self._lint_job(ex, timeline)
        stats = ex.last_stats(self.sys_cfg, timeline=timeline)
        return JobResult(result=preds, stats=stats, timeline=timeline)

    # ------------------------------------------------------------------ #
    # Introspection (the machine model)
    # ------------------------------------------------------------------ #
    def clear_traces(self, handle: ResourceHandle) -> None:
        """Forget a resource's recorded command streams (e.g. LUT
        loading, before reading raw traces or device schedules; job
        timelines are already job-scoped).  A fused session's resource
        that no machine job has placed has recorded nothing: nothing is
        built for it."""
        self._recipe(handle.name, None)
        if handle.name not in self.planner.resources:
            return
        for eng in self._machine_exec(handle.name).engines:
            eng.sub.trace.clear()

    def schedule(self) -> Timeline:
        """Jointly scheduled timeline of every device's full recorded
        streams (LUT loads and every job), device channels re-keyed into
        per-device namespaces, host events on the session's host
        model."""
        stride = max(d.channels for d in self.devices)
        streams = [
            rekey_stream(st, di, stride,
                         host=di if self.hosts == "per-device" else 0)
            for di, d in enumerate(self.devices)
            for st in d.streams()]
        return ChannelScheduler(self.sys_cfg).schedule(streams)

    def cost_summary(self) -> dict:
        """Per-device cost summaries plus the federated makespan
        (modeled for ``sys_cfg``)."""
        per_dev = [d.cost_summary(self.sys_cfg) for d in self.devices]
        fed = self.schedule()
        return {
            "devices": per_dev,
            "time_scheduled_ns": fed.makespan_ns,
            "time_device_ns": fed.device_span_ns,
            "energy_nj": sum(s["energy_nj"] for s in per_dev),
        }

    def planner_stats(self) -> dict:
        """Placement-planner counters (resource states, queue, defrag,
        evictions, free-map shape per device)."""
        return self.planner.stats()
