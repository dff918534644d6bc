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
chunk count, same LUT bytes) and runs jobs through
:class:`~repro_torch.kernels.fused_session.FusedTableExec` and
:class:`~repro_torch.kernels.fused_session.FusedGbdtExec`.

``num_devices``, ``arch`` and ``num_rows`` describe the reference's
PuD fleet and are kept only as layout parameters: tables get
``num_devices * shards_per_device`` record shards, and the chunk count
is the paper's (:data:`~repro_torch.apps.predicate.
PAPER_PREDICATE_CHUNKS`, :data:`~repro_torch.apps.gbdt.
PAPER_GBDT_CHUNKS`), raised until the LUTs fit a ``num_rows``-row
subarray.  The session runs on one card.

Not ported yet: ``representation="auto"`` and :meth:`recode_column`
need the reference's planner and scheduler (ROADMAP, Queue 1, item 2)
and raise ``NotImplementedError``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.apps.gbdt import PAPER_GBDT_CHUNKS
from repro_torch.apps.predicate import PAPER_PREDICATE_CHUNKS, Table, fit_chunks
from repro_torch.core.machine import PuDArch
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.fused_session import FusedGbdtExec, FusedTableExec

from .queries import Q1, Q2, Q3, Q4, Q5, Compound

_AUTO_TODO = ("representation='auto' and recode_column need the planner "
              "and scheduler, which are not ported yet (ROADMAP, Queue 1, "
              "item 2)")


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


@dataclass
class ForestHandle(ResourceHandle):
    num_trees: int = 0
    depth: int = 0


class PudSession:
    """Declarative tables and forests whose jobs run on one card.

    ``device`` defaults to the card; with no CUDA and no ``device`` the
    constructor raises.  ``device="cpu"`` runs every kernel's plain
    PyTorch version (what the CPU tests use)."""

    def __init__(self, num_devices: int = 1,
                 arch: PuDArch = PuDArch.MODIFIED, num_rows: int = 1024,
                 device=None) -> None:
        if num_devices < 1:
            raise ValueError("need at least one device")
        self.device = resolve_device(device)
        self.num_devices = num_devices
        self.arch = arch
        self.num_rows = num_rows
        # name -> (kind, build closure); name -> built executor
        self._recipes: dict[str, tuple[str, Any]] = {}
        self._execs: dict[str, Any] = {}
        self._auto = 0

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
                     representation: str = "fixed") -> TableHandle:
        """Build a table's stacked LUT on the device.  ``data`` is a
        :class:`~repro_torch.apps.predicate.Table`, or a ``[records,
        features]`` integer array with ``n_bits`` giving the width.
        Records split into ``num_devices * shards_per_device`` shards."""
        if representation == "auto":
            raise NotImplementedError(_AUTO_TODO)
        if representation != "fixed":
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
        chunks = fit_chunks(
            data.n_bits, len(data.features), self.arch,
            num_chunks or PAPER_PREDICATE_CHUNKS[(data.n_bits, self.arch)],
            self.num_rows)
        shards = self.num_devices * shards_per_device
        name = name or self._auto_name("table")

        def build():
            return FusedTableExec(data, num_shards=shards,
                                  num_chunks=chunks, device=self.device)

        self._admit(name, "table", build)
        return TableHandle(name=name, session=self,
                           num_records=data.num_records, n_bits=data.n_bits)

    def load_forest(self, forest, name: str | None = None,
                    num_chunks: int | None = None, plan=None,
                    representation: str = "fixed") -> ForestHandle:
        """Put a forest's threshold LUT and one-hot masks on the device.
        ``plan`` (a :class:`~repro_torch.core.encoding.ColumnPlan`)
        narrows the threshold representation, as the reference's
        optimizer would; otherwise the chunk count is ``num_chunks`` or
        the paper's."""
        if representation == "auto":
            raise NotImplementedError(_AUTO_TODO)
        if representation != "fixed":
            raise ValueError(
                f"representation must be 'fixed' or 'auto', "
                f"got {representation!r}")
        chunks = plan.num_chunks if plan is not None else (
            num_chunks or PAPER_GBDT_CHUNKS[forest.n_bits])
        name = name or self._auto_name("forest")

        def build():
            return FusedGbdtExec(forest, num_chunks=chunks, plan=plan,
                                 device=self.device)

        self._admit(name, "forest", build)
        return ForestHandle(name=name, session=self,
                            num_trees=forest.num_trees, depth=forest.depth)

    def _admit(self, name: str, kind: str, build) -> None:
        if name in self._recipes:
            raise ValueError(f"resource {name!r} already exists")
        self._recipes[name] = (kind, build)
        self._execs[name] = build()

    def drop(self, handle: ResourceHandle) -> None:
        """Release a resource and free its device tensors."""
        self._recipes.pop(handle.name, None)
        self._execs.pop(handle.name, None)

    def evict(self, handle: ResourceHandle) -> None:
        """Free a resource's device tensors now; the next job rebuilds
        them."""
        self._execs.pop(handle.name, None)

    def recode_column(self, handle: TableHandle, column: int,
                      n_bits: int | None = None,
                      num_chunks: int | None = None):
        raise NotImplementedError(_AUTO_TODO)

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
