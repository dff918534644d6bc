"""The control of the comparison that decides ``correct``: the plain
reference put in the program's place, computed one precision below the
configuration's, and judged as a run judges the program.

* query cells: every value and scalar cut to 16 bits (the configuration
  declares 32), averages taken in float32 (the exact mean is float64);
* predict cells: the float32 leaves cast to bfloat16, summed in float32.

It answers as many requests as a run checks (the mix's
``check_sample``), drawn from the seed out of the requests a window of
``--seconds`` would draw, and prints the numbers compared beside the
configuration's limits, one JSON line a seed:

    python3 clutchbench/control.py --workload <cell> --seeds 1,2,3 --seconds 10
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from clutchbench import check, data  # noqa: E402
from clutchbench.manifest import Manifest  # noqa: E402
from clutchbench.reference.forest import Forest  # noqa: E402
from clutchbench.reference.predicates import Columns  # noqa: E402
from clutchbench.run import Requests, derive, judge  # noqa: E402

CONTROL_BITS = 16


class Control:
    """Stands where the system under test stands in a run."""

    def __init__(self, cfg: dict, inputs, device) -> None:
        if cfg["kind"] == "table":
            self.cols = Columns(inputs, cfg["n_bits"], device,
                                bits=CONTROL_BITS)
        else:
            self.forest = Forest(inputs["feature_idx"],
                                 inputs["thresholds"], inputs["leaves"],
                                 device, control=True)
        self.kind = cfg["kind"]

    def prepare(self, requests: list) -> list:
        return requests

    def call(self, req):
        if self.kind == "forest":
            return self.forest.predict(req).cpu().numpy().astype(np.float32)
        out = self.cols.answer(req)
        return out.cpu().numpy() if isinstance(out, torch.Tensor) else out


def readings(manifest: Manifest, name: str, seed: int, seconds: float,
             device: str = "cuda", overrides: dict | None = None) -> dict:
    """The control's numbers, each beside its limit, for one seed."""
    overrides = overrides or {}
    cell = manifest.cell(name)
    cfg = {**manifest.config(cell["config"]), **overrides.get("config", {})}
    spec = {**manifest.mix(cell["traffic"]), **overrides.get("mix", {})}
    gen = manifest.generator(spec, cfg, seed, device)
    if cfg["kind"] == "table":
        inputs = data.lineitem(cfg, derive(seed, 0), device)
    else:
        inputs = data.forest(cfg, derive(seed, 0), device)
    control = Control(cfg, inputs, device)
    reqs = Requests(gen, spec, seconds, control)
    reqs.extend()
    rng = np.random.default_rng(derive(seed, 3))
    k = min(spec["check_sample"], len(reqs.plain))
    picks = sorted(rng.choice(len(reqs.plain), k, replace=False).tolist())
    sample = [(i, control.call(reqs.plain[i])) for i in picks]
    del control
    numbers, _ = judge(cfg, spec, inputs, reqs, sample, device)
    return numbers


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
