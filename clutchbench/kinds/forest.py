"""An oblivious forest in a fused ``PudSession``, one batch of instances
a call.

Inputs: the forest made from the seed (``data.forest``); each request
is a fresh batch of instances.  The system under test: ``repro_torch``'s
``PudSession`` on the fused backend; a call scores one batch.  The
predictions are judged against ``reference/forest.py``
(``check.predictions``); the control casts the leaves to bfloat16.
"""

from __future__ import annotations

import numpy as np

from clutchbench import check, data, work
from clutchbench.data import derive
from clutchbench.reference.forest import Forest as RefForest


class System:
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

    def wants(self) -> int:
        return 1

    def call(self, batch: list, first: int) -> list:
        return [(first, self.session.predict(self.handle, batch[0]).result)]

    def drain(self) -> list:
        return []

    def close(self) -> None:
        self.session.drop(self.handle)
        del self.session, self.handle


class Control:
    """The plain reference one precision below the configuration's, in
    the system's place: the float32 leaves cast to bfloat16, summed in
    float32."""

    def __init__(self, arrays: dict, device) -> None:
        self.forest = RefForest(arrays["feature_idx"], arrays["thresholds"],
                                arrays["leaves"], device, control=True)

    def answer(self, x: np.ndarray):
        return self.forest.predict(x).cpu().numpy().astype(np.float32)


def build(cell):
    """(the forest's arrays, a maker of the system under test)."""
    arrays = data.forest(cell.cfg, derive(cell.seed, 0), cell.device)
    return arrays, lambda: System(cell.cfg, arrays, cell.device)


def label(taken: list) -> str:
    """The request kind of a call, for the latency-by-kind line."""
    return "predict"


def values(cell, w) -> dict:
    """The end-to-end values of a window ``w``."""
    return {"predict_rows_per_s": w.n * cell.spec["batch"] / w.window_s}


def facts(cell, w) -> dict:
    """What the traced summary adds for the readers: the instances the
    traced calls scored and the least time the chip could take for
    them."""
    cfg, batch = cell.cfg, cell.spec["batch"]
    n = w.traced[1] - w.traced[0]
    nbytes, ops = work.predict_work(batch, cfg["trees"], cfg["depth"],
                                    cfg["features"], cfg["n_bits"])
    return {"rows": n * batch,
            "least_s": work.least_seconds(n * nbytes, n * ops)}


def judge(cell, arrays: dict, plain: list, sample: list
          ) -> tuple[dict, dict]:
    """(the numbers compared, each beside its limit; everything the
    comparison found)."""
    ref = RefForest(arrays["feature_idx"], arrays["thresholds"],
                    arrays["leaves"], cell.device)
    found = check.predictions([(plain[i], out) for i, out in sample], ref)
    return check.judged(found, dict(cell.cfg["limits"])), found


def control(cell, seconds: float) -> dict:
    from clutchbench.control import stand_in

    arrays = data.forest(cell.cfg, derive(cell.seed, 0), cell.device)
    return stand_in(cell, seconds, arrays, Control(arrays, cell.device))
