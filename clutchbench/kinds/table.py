"""A table of columns in a fused ``PudSession``, one query a call.

Inputs: the ``lineitem`` columns made from the seed (``data.lineitem``).
The system under test: ``repro_torch``'s ``PudSession`` on the fused
backend, holding the table as the configuration lays it out; a call
runs one query of the mix and returns its answer.  The answers are
judged against ``reference/predicates.py`` (``check.queries``); the
control cuts every value and scalar to 16 bits.
"""

from __future__ import annotations

import numpy as np
import torch

from clutchbench import check, data, work
from clutchbench.data import derive
from clutchbench.reference.predicates import Columns

CONTROL_BITS = 16


def _query(req: tuple, Q):
    kind = req[0]
    if kind == "q1":
        return Q.Q1(*req[1:])
    if kind in ("q2", "q3", "q4", "q5"):
        return getattr(Q, kind.upper())(*req[1:])
    if kind == "compound":
        _, count, ops, terms = req
        return Q.Compound(tuple(_query(t, Q) for t in terms), tuple(ops),
                          count=count)
    raise ValueError(f"unknown query {kind!r}")


class System:
    """A table in a fused session; :meth:`call` runs one query."""

    def __init__(self, cfg: dict, columns: list[np.ndarray], device) -> None:
        from repro_torch.apps.predicate import Table as PortTable
        from repro_torch.pud import PudSession
        from repro_torch.pud import queries as Q

        self.Q = Q
        self.session = PudSession(backend="fused", device=device)
        self.handle = self.session.create_table(
            PortTable(n_bits=cfg["n_bits"], features=columns),
            name=cfg["name"], shards_per_device=cfg["shards"],
            num_chunks=cfg["num_chunks"],
            representation=cfg["representation"])
        ex = self.session.executor(self.handle)
        if (ex.num_chunks, ex.num_shards) != (cfg["num_chunks"],
                                              cfg["shards"]):
            raise RuntimeError(
                f"the session laid the table out with {ex.num_chunks} "
                f"chunks over {ex.num_shards} shards, not the "
                f"configuration's {cfg['num_chunks']} over {cfg['shards']}")

    def prepare(self, requests: list[tuple]) -> list:
        return [_query(r, self.Q) for r in requests]

    def wants(self) -> int:
        return 1

    def call(self, batch: list, first: int) -> list:
        return [(first, self.session.query(self.handle, batch[0]).result)]

    def drain(self) -> list:
        return []

    def close(self) -> None:
        self.session.drop(self.handle)
        del self.session, self.handle


class Control:
    """The plain reference one precision below the configuration's, in
    the system's place: values and scalars cut to 16 bits of the
    declared 32, averages in float32."""

    def __init__(self, cfg: dict, columns: list[np.ndarray], device) -> None:
        self.cols = Columns(columns, cfg["n_bits"], device,
                            bits=CONTROL_BITS)

    def answer(self, req: tuple):
        out = self.cols.answer(req)
        return out.cpu().numpy() if isinstance(out, torch.Tensor) else out


def build(cell):
    """(the columns, a maker of the system under test)."""
    columns = data.lineitem(cell.cfg, derive(cell.seed, 0), cell.device)
    return columns, lambda: System(cell.cfg, columns, cell.device)


def label(taken: list) -> str:
    """The request kind of a call, for the latency-by-kind line."""
    req = taken[0]
    if req[0] == "compound":
        return f"compound{len(req[3])}{'count' if req[1] else 'bitmap'}"
    return req[0]


def values(cell, w) -> dict:
    """The end-to-end values of a window ``w``."""
    return {"scan_qps": w.n / w.window_s, "count_qps": w.n / w.window_s,
            "scan_p95_ms": w.p95_s * 1e3}


def facts(cell, w) -> dict:
    """What the traced summary adds for the readers: the least time the
    chip could take for the traced calls' queries."""
    cfg, (a, b) = cell.cfg, w.traced
    nbytes = sum(work.query_bytes(r, cfg["records"], cfg["n_bits"],
                                  cfg["num_chunks"]) for r in w.plain[a:b])
    return {"least_s": work.least_seconds(nbytes, 0.0)}


def judge(cell, columns, plain: list, sample: list) -> tuple[dict, dict]:
    """(the numbers compared, each beside its limit; everything the
    comparison found)."""
    limits = dict(cell.cfg["limits"])
    cols = Columns(columns, cell.cfg["n_bits"], cell.device)
    found = check.queries([(plain[i], out) for i, out in sample], cols,
                          cell.device)
    if not any(e["query"] == "Q4" for e in cell.spec["mix"]):
        limits.pop("avg_rel_gap", None)
    return check.judged(found, limits), found


def control(cell, seconds: float) -> dict:
    from clutchbench.control import stand_in

    columns = data.lineitem(cell.cfg, derive(cell.seed, 0), cell.device)
    return stand_in(cell, seconds, columns,
                    Control(cell.cfg, columns, cell.device))
