"""`PudSession`: the port's front door, running every job on the card.

    from repro_torch.pud import PudSession, Q1, Q2

    session = PudSession()                       # device="cuda"
    table = session.create_table(t)              # LUTs built on the card
    job = session.query(table, Q2(fi=0, x0=1, x1=9, fj=1, y0=2, y1=8))
    job.result                                   # == NumPy reference
    preds = session.predict(session.load_forest(f), X).result

The reference package's session drives a NumPy DRAM simulator, a
placement planner and a trace verifier, and hands its fused backend a
layout recipe.  This session has one backend, the card: it lays each
resource out as the reference's executors would (same shard count, same
chunk plans, same LUT bytes) and runs jobs through
:class:`~repro_torch.kernels.fused_session.FusedTableExec` and
:class:`~repro_torch.kernels.fused_session.FusedGbdtExec`.

``num_devices``, ``arch`` and ``num_rows`` describe the reference's
PuD fleet and are kept only as layout parameters: tables get
``num_devices * shards_per_device`` record shards, and a fixed table's
chunk count is the paper's (:data:`~repro_torch.apps.predicate.
PAPER_PREDICATE_CHUNKS`, :data:`~repro_torch.apps.gbdt.
PAPER_GBDT_CHUNKS`), raised until the LUTs fit a ``num_rows``-row
subarray.  The session runs on one card.

Adaptive representation: ``create_table(..., representation="auto")``
and ``load_forest``'s counterpart let
:func:`~repro_torch.pud.planner.choose_representation` give each column
its own ``(n_bits, num_chunks)``, priced on the DRAM model under
``sys_cfg`` (which is used for nothing else) and never slower or larger
than the fixed default.  ``handle.representation`` reports the plans and
the LUT rows saved; :meth:`PudSession.recode_column` re-encodes one
column by evicting the table, whose next job rebuilds its LUT on the
card.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.apps.gbdt import PAPER_GBDT_CHUNKS
from repro_torch.apps.predicate import PAPER_PREDICATE_CHUNKS, Table, fit_chunks
from repro_torch.core import cost
from repro_torch.core.encoding import ColumnPlan, column_footprint_rows
from repro_torch.core.machine import NUM_RESERVED, PuDArch
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.fused_session import FusedGbdtExec, FusedTableExec

from .planner import (
    _default_uniform_chunks,
    choose_forest_plan,
    choose_representation,
)
from .queries import Q1, Q2, Q3, Q4, Q5, Compound


@dataclass
class JobResult:
    """One job's outcome: the result, and the measured wall-clock from
    submission to the card's last kernel (clock stopped after
    ``torch.cuda.synchronize()``)."""

    result: Any
    wallclock_ns: float


@dataclass
class ResourceHandle:
    """Handle to a session resource; ``status`` is ``"ready"`` (device
    tensors built), ``"evicted"`` (rebuilt on next use) or
    ``"dropped"``."""

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


class PudSession:
    """Declarative tables and forests whose jobs run on one card.

    ``device`` defaults to the card; with no CUDA and no ``device`` the
    constructor raises.  ``device="cpu"`` runs every kernel's plain
    PyTorch version (what the CPU tests use)."""

    def __init__(self, sys_cfg=cost.DESKTOP, num_devices: int = 1,
                 arch: PuDArch = PuDArch.MODIFIED, num_rows: int = 1024,
                 device=None) -> None:
        if num_devices < 1:
            raise ValueError("need at least one device")
        self.device = resolve_device(device)
        #: the DRAM platform ``representation="auto"`` prices plans on
        self.sys_cfg = sys_cfg
        self.num_devices = num_devices
        self.arch = arch
        self.num_rows = num_rows
        # name -> (kind, build closure); name -> built executor
        self._recipes: dict[str, tuple[str, Any]] = {}
        self._execs: dict[str, Any] = {}
        self._auto = 0
        # Adaptive representation, by resource name: a table's data, its
        # per-column ColumnPlans (a list recode_column edits in place;
        # absent for a fixed table until its first recode) and an auto
        # forest's threshold plan.  A table's build closure reads its
        # plans LATE, so the rebuild after a recode lays the new ones out.
        self._tables: dict[str, Any] = {}
        self._plans: dict[str, list] = {}
        self._forest_plans: dict[str, ColumnPlan] = {}

    def _auto_name(self, prefix: str) -> str:
        self._auto += 1
        return f"{prefix}{self._auto}"

    def _status(self, name: str) -> str:
        if name not in self._recipes:
            return "dropped"
        return "ready" if name in self._execs else "evicted"

    # ------------------------------------------------------------------ #
    # Resources
    # ------------------------------------------------------------------ #
    def create_table(self, data, name: str | None = None,
                     n_bits: int | None = None,
                     shards_per_device: int = 2,
                     num_chunks: int | None = None,
                     representation: str = "fixed",
                     headroom: int = 0) -> TableHandle:
        """Build a table's stacked LUT on the device.  ``data`` is a
        :class:`~repro_torch.apps.predicate.Table`, or a ``[records,
        features]`` integer array with ``n_bits`` giving the width.
        Records split into ``num_devices * shards_per_device`` shards.

        ``representation="auto"`` gives each column the ``(n_bits,
        num_chunks)`` with the least probed makespan for its observed
        values (plus ``headroom`` guard bits), never slower or larger
        than the fixed default; ``"fixed"`` keeps the declared width and
        one chunk count (``num_chunks`` or the paper's)."""
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
            plans = choose_representation(
                data, self.arch, num_rows=self.num_rows,
                sys_cfg=self.sys_cfg, headroom=headroom,
                num_chunks=num_chunks)
            chunks = max(p.num_chunks for p in plans)
        else:
            plans = None
            chunks = fit_chunks(
                data.n_bits, len(data.features), self.arch,
                num_chunks or PAPER_PREDICATE_CHUNKS[(data.n_bits,
                                                      self.arch)],
                self.num_rows)
        shards = self.num_devices * shards_per_device

        def build():
            # the plan set is read here, not captured: recode_column
            # changes it and rebuilds through this closure
            plans = self._plans.get(name)
            return FusedTableExec(
                data, num_shards=shards,
                num_chunks=chunks if plans is None
                else max(p.num_chunks for p in plans),
                plans=plans, device=self.device)

        self._tables[name] = data
        if plans is not None:
            self._plans[name] = plans
        self._admit(name, "table", build)
        return TableHandle(name=name, session=self,
                           num_records=data.num_records, n_bits=data.n_bits)

    def load_forest(self, forest, name: str | None = None,
                    num_chunks: int | None = None,
                    representation: str = "fixed",
                    headroom: int = 0) -> ForestHandle:
        """Put a forest's threshold LUT and one-hot masks on the device,
        at ``num_chunks`` or the paper's chunk count.
        ``representation="auto"`` sizes the threshold LUT to the
        observed thresholds (:func:`~repro_torch.pud.planner.
        choose_forest_plan`, priced with the ``>``-only probe inference
        issues)."""
        if representation not in ("fixed", "auto"):
            raise ValueError(
                f"representation must be 'fixed' or 'auto', "
                f"got {representation!r}")
        name = name or self._auto_name("forest")
        self._check_new(name)
        plan = None
        if representation == "auto":
            plan = choose_forest_plan(
                forest, self.arch, num_rows=self.num_rows,
                sys_cfg=self.sys_cfg, headroom=headroom,
                num_chunks=num_chunks)
        chunks = plan.num_chunks if plan is not None else (
            num_chunks or PAPER_GBDT_CHUNKS[forest.n_bits])

        def build():
            return FusedGbdtExec(forest, num_chunks=chunks, plan=plan,
                                 device=self.device)

        if plan is not None:
            self._forest_plans[name] = plan
        self._admit(name, "forest", build)
        return ForestHandle(name=name, session=self,
                            num_trees=forest.num_trees, depth=forest.depth)

    def _check_new(self, name: str) -> None:
        if name in self._recipes:
            raise ValueError(f"resource {name!r} already exists")

    def _admit(self, name: str, kind: str, build) -> None:
        self._recipes[name] = (kind, build)
        try:
            self._execs[name] = build()
        except Exception:
            # a recipe that cannot build is the caller's error: forget
            # it, so the name stays usable
            self.drop(ResourceHandle(name, self))
            raise

    def drop(self, handle: ResourceHandle) -> None:
        """Release a resource and free its device tensors."""
        for d in (self._recipes, self._execs, self._tables, self._plans,
                  self._forest_plans):
            d.pop(handle.name, None)

    def evict(self, handle: ResourceHandle) -> None:
        """Free a resource's device tensors now; the next job rebuilds
        them."""
        self._execs.pop(handle.name, None)

    # ------------------------------------------------------------------ #
    # Adaptive representation
    # ------------------------------------------------------------------ #
    def recode_column(self, handle: TableHandle, column: int,
                      n_bits: int | None = None,
                      num_chunks: int | None = None) -> ColumnPlan:
        """Re-encode one column under a new ``(n_bits, num_chunks)``
        (omitted arguments keep the column's current value) and evict
        the table: its next job rebuilds the LUT on the card with the
        new plan.  A fixed table first gets declared-width plans for
        every column.  Returns the new :class:`ColumnPlan`."""
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
        # the reference subarray's row budget, checked here so a recode
        # that cannot fit fails now, with the plan set rolled back
        mult = 2 if self.arch is PuDArch.UNMODIFIED else 1
        need = 2 + 4 + 2 + mult * sum(p.rows_required for p in plans)
        budget = self.num_rows - NUM_RESERVED
        if need > budget:
            plans[column] = old
            raise MemoryError(
                f"recode to {new} needs {need} rows > budget {budget} "
                f"({self.num_rows}-row subarray); pick more chunks or "
                "fewer bits")
        self.evict(handle)
        return new

    def representation_report(self, handle: TableHandle) -> dict:
        """A table's active plans (``mode="auto"`` after the optimizer or
        a recode, ``"fixed"`` otherwise) and its LUT rows beside the
        fixed uniform default's, in the reference subarray's rows
        (complements counted on Unmodified PuD); ``saved_rows`` is the
        difference."""
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

    def executor(self, handle: ResourceHandle):
        """The resource's executor (rebuilt if evicted): LUT tensors,
        ``launch_counts`` and, for forests, ``leaf_addrs``."""
        recipe = self._recipes.get(handle.name)
        if recipe is None:
            raise KeyError(f"unknown resource {handle.name!r} "
                           "(dropped, or from another session?)")
        ex = self._execs.get(handle.name)
        if ex is None:
            ex = self._execs[handle.name] = recipe[1]()
        return ex

    def _typed(self, handle: ResourceHandle, kind: str):
        recipe = self._recipes.get(handle.name)
        if recipe is not None and recipe[0] != kind:
            raise TypeError(
                f"resource {handle.name!r} is a {recipe[0]}, not a {kind}")
        return self.executor(handle)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------ #
    # Jobs
    # ------------------------------------------------------------------ #
    def query(self, table: TableHandle,
              queries: "Q1 | Q2 | Q3 | Q4 | Q5 | Compound | Sequence"
              ) -> JobResult:
        """Run one query, or a batch in order, against a table.  For a
        single query ``result`` is its value, for a batch the list of
        values; each equals the query's NumPy ``reference``."""
        single = isinstance(queries, (Q1, Q2, Q3, Q4, Q5, Compound))
        batch = [queries] if single else list(queries)
        ex = self._typed(table, "table")
        t0 = time.perf_counter()
        results = ex.run([q.to_tuple() for q in batch])
        self._sync()
        wall = (time.perf_counter() - t0) * 1e9
        return JobResult(result=results[0] if single else results,
                         wallclock_ns=wall)

    def predict(self, forest: ForestHandle, X: np.ndarray) -> JobResult:
        """Batched GBDT inference: one kernel launch for the batch;
        ``result`` is the [B] float32 predictions."""
        ex = self._typed(forest, "forest")
        t0 = time.perf_counter()
        preds = ex.infer(np.asarray(X))
        self._sync()
        wall = (time.perf_counter() - t0) * 1e9
        return JobResult(result=preds, wallclock_ns=wall)
