"""The system under test: ``repro_torch``'s ``PudSession`` on the fused
backend, built from the harness's inputs and driven one request at a
time.  This is the only file of the harness that imports the program.
"""

from __future__ import annotations

import numpy as np


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


class Table:
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

    def call(self, prepared):
        return self.session.query(self.handle, prepared).result

    def close(self) -> None:
        self.session.drop(self.handle)
        del self.session, self.handle


class Forest:
    """A forest in a fused session; :meth:`call` scores one batch."""

    def __init__(self, cfg: dict, arrays: dict, device) -> None:
        from repro_torch.apps.gbdt import ObliviousForest
        from repro_torch.pud import PudSession

        self.session = PudSession(backend="fused", device=device)
        forest = ObliviousForest(
            feature_idx=arrays["feature_idx"],
            thresholds=arrays["thresholds"], leaves=arrays["leaves"],
            n_bits=cfg["n_bits"], num_features=cfg["features"])
        self.handle = self.session.load_forest(
            forest, name=cfg["name"], num_chunks=cfg["num_chunks"])

    def prepare(self, requests: list) -> list:
        return requests

    def call(self, x: np.ndarray):
        return self.session.predict(self.handle, x).result

    def close(self) -> None:
        self.session.drop(self.handle)
        del self.session, self.handle
