#!/usr/bin/env python3
"""Decode-step and prefill wall-clock of ``chip_smoke.py``'s phases 6-7
(LM serving at full width) across source trees, on one NVIDIA GPU.

    python3 tools/time_lm.py TREE [TREE ...] [--rounds N]

Each TREE is the root of a checkout of this repository (its
``chip_smoke.py`` and ``src`` are imported; its kernels are built into
its own ``build`` directory).  For each round the trees run in order and
then in reverse order (A B ... B A), one process each, so a drift of the
card or the host falls on every tree alike.  A process runs the tree's
own ``run_lm_path`` (``minitron-8b``, 16 requests, 64 decode steps) and
``run_arch_paths`` (granite-moe, rwkv6, one jamba period, whisper-base),
with every check they make.  A JSON object per process goes to standard
error; the last line of standard output holds, per tree and number, the
median over the tree's processes.  The host sets the pace of a decode
step, so the numbers spread from process to process.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np


def child(tree: Path) -> dict:
    sys.path[:0] = [str(tree / "src"), str(tree)]
    import torch

    import chip_smoke as C
    from repro_torch.kernels import _build

    _build.build_all()
    report: dict = {}
    C.run_lm_path(torch, report)
    C.run_arch_paths(torch, report)
    lm = report["lm"]
    out = {"minitron-8b decode_ms": lm["decode_step_ms_median"],
           "minitron-8b decode_min_ms": lm["decode_step_ms_min_max"][0],
           "minitron-8b prefill_ms": lm["prefill_ms_median"],
           "minitron-8b tok_per_s": lm["tok_per_s"],
           "minitron-8b profiled_step_ms": lm["device_busy"]["step_wall_ms"],
           "minitron-8b device_ms": lm["device_busy"]["device_ms"]}
    for a in report["archs"]:
        out[f"{a['arch']} decode_ms"] = a["decode_step_ms_median"]
        out[f"{a['arch']} prefill_ms"] = a["prefill_ms_median"]
    out["whisper-base decode_ms"] = report["whisper"]["decode_step_ms_median"]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+", type=Path)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.trees[0].resolve())))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    trees = [t.resolve() for t in args.trees]
    runs = {str(t): [] for t in trees}
    for _ in range(args.rounds):
        for t in trees + trees[::-1]:
            got = subprocess.run(
                [sys.executable, __file__, "--child", str(t)],
                capture_output=True, text=True, timeout=600)
            if got.returncode:
                print(got.stderr[-4000:], file=sys.stderr)
                return 1
            res = json.loads(got.stdout.strip().splitlines()[-1])
            print(json.dumps({"tree": str(t), **res}), file=sys.stderr)
            runs[str(t)].append(res)
    summary = {t: {k: float(np.median([r[k] for r in rs])) for k in rs[0]}
               for t, rs in runs.items()}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
