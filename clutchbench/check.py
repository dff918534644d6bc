"""The comparison that decides ``correct``: answers the timed path gave,
held against the plain reference once the window has closed.

Numbers compared, each beside its limit from the configuration's
``limits``:

* ``wrong_answers``: answers that must be exact (bitmaps, counts, the
  shape of a batch of predictions) and differ from the reference's, or
  never came; limit 0.
* ``avg_rel_gap`` (query cells whose mix holds ``Q4``): the widest gap
  of an average from the exact mean, relative to the mean.
* ``pred_max_gap`` (predict cells): the widest gap of a prediction from
  the exact sum of its leaves.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .reference.forest import Forest
from .reference.predicates import Columns


def _gap(got, want: float, relative: bool) -> float:
    if not isinstance(got, float) or not math.isfinite(got):
        return math.inf
    d = abs(got - want)
    return d / abs(want) if relative and want != 0 else d


def queries(answers: list, columns: Columns, device) -> dict:
    """``answers``: ``(request, answer)`` pairs, ``None`` for an answer
    that never came."""
    wrong, avg_gap, q4s = 0, 0.0, 0
    for req, got in answers:
        want = columns.answer(req)
        if isinstance(want, torch.Tensor):
            ok = (isinstance(got, np.ndarray) and got.dtype == np.bool_
                  and got.shape == tuple(want.shape)
                  and bool(torch.equal(torch.from_numpy(got).to(device),
                                       want)))
            wrong += not ok
        elif isinstance(want, float):
            q4s += 1
            avg_gap = max(avg_gap, _gap(got, want, relative=True))
        else:
            wrong += not (isinstance(got, (int, np.integer))
                          and int(got) == want)
    return {"wrong_answers": wrong, "avg_rel_gap": avg_gap,
            "checked": len(answers), "averages": q4s}


def predictions(answers: list, forest: Forest) -> dict:
    """``answers``: ``(instances, predictions)`` pairs, ``None`` for
    predictions that never came."""
    wrong, gap, rows = 0, 0.0, 0
    for x, got in answers:
        want = forest.predict(x)
        rows += x.shape[0]
        if not isinstance(got, np.ndarray) or got.shape != (x.shape[0],):
            wrong += 1
            continue
        g = torch.from_numpy(np.asarray(got, np.float64)).to(want.device)
        d = (g - want.to(torch.float64)).abs()
        worst = float(d.max()) if d.numel() else 0.0
        gap = max(gap, worst if math.isfinite(worst) and bool(
            torch.isfinite(g).all()) else math.inf)
    return {"wrong_answers": wrong, "pred_max_gap": gap,
            "checked": len(answers), "rows": rows}


def judged(found: dict, limits: dict) -> dict:
    """``{name: {"value": v, "limit": l}}`` for each number compared."""
    return {k: {"value": found[k], "limit": limits[k]}
            for k in limits if k in found}


def passed(numbers: dict) -> bool:
    return all(v["value"] <= v["limit"] for v in numbers.values())
