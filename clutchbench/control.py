"""The control of the comparison that decides ``correct``: the plain
reference computed one precision below the configuration's, put in the
program's place, and judged as a run judges the program.  Each kind
says how (``kinds/<kind>.py``, ``control``):

* ``table``: every value and scalar cut to 16 bits (the configuration
  declares 32), averages taken in float32 (the exact mean is float64);
* ``forest``: the float32 leaves cast to bfloat16, summed in float32;
* ``lm``: the reference's forward with every weight rounded to float8
  e4m3 (a scale a weight tensor, the configuration's weights are
  bfloat16), over the prompts and tokens a short window of the program
  served; at each position the token its min-p sampler draws.

The table and forest controls answer as many requests as a run checks
(the mix's ``check_sample``), drawn from the seed out of the requests a
window of ``--seconds`` would draw.  Each seed prints the numbers
compared beside the configuration's limits, one JSON line:

    python3 clutchbench/control.py --workload <cell> --seeds 1,2,3 --seconds 10
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
for _p in (str(ROOT), str(ROOT / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from clutchbench import check  # noqa: E402
from clutchbench.data import derive  # noqa: E402
from clutchbench.manifest import Manifest  # noqa: E402
from clutchbench.run import Cell, Requests  # noqa: E402


class _Answers:
    """A pool of requests with no system behind it."""

    def prepare(self, requests: list) -> list:
        return requests


def stand_in(cell: Cell, seconds: float, inputs, control) -> dict:
    """The numbers compared when ``control.answer`` answers a sample of
    the requests a window of ``seconds`` would draw."""
    reqs = Requests(cell.generator(), cell.spec, seconds, _Answers())
    reqs.extend()
    rng = np.random.default_rng(derive(cell.seed, 3))
    k = min(cell.spec["check_sample"], len(reqs.plain))
    picks = sorted(rng.choice(len(reqs.plain), k, replace=False).tolist())
    sample = [(i, control.answer(reqs.plain[i])) for i in picks]
    del control
    numbers, _ = cell.kind.judge(cell, inputs, reqs.plain, sample)
    return numbers


def readings(manifest: Manifest, name: str, seed: int, seconds: float,
             device: str = "cuda", overrides: dict | None = None) -> dict:
    """The control's numbers, each beside its limit, for one seed."""
    cell = Cell(manifest, name, seed, device, overrides)
    return cell.kind.control(cell, seconds)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    manifest = Manifest(ROOT / "BENCHMARK.json")
    for seed in (int(s) for s in args.seeds.split(",")):
        numbers = readings(manifest, args.workload, seed, args.seconds)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": numbers,
                          "fails": not check.passed(numbers)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
