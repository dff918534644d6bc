#!/usr/bin/env python3
"""The operations and launches of one batch-1 prefill of the Jamba2
Mini cut (``clutchbench/configs/jamba2-mini-16l.json``: 16 layers at
full width, bf16) on the card, as ``ServeEngine.add_request`` runs it,
at two prompt lengths.

    python3 tools/trace_prefill.py [--tokens 4999 1249] [--out PATH]

Weights are the port's own random init (``init_params``, seed 0), the
prompt ids uniform over the vocabulary (NumPy seed 1).  For each length:
every device kernel the profiler sees, by name and count; from a
dispatch mode over the prefill (it sees the kernel wrappers' outputs
too), the number of operations the host issues, the largest tensor they
make, and the largest with the scan's trailing dimensions (d_inner,
d_state); the prefill's time (CUDA events, median of 3 after a warm
one).  The same number of operations at both lengths shows that nothing
loops over time on the host (the libraries pick their sort and product
kernels by size, so the launches may differ); a scan-shaped tensor under
B * S * d_inner * d_state elements, that no [B, S, din, N] tensor is
built.  Prints one JSON line and writes the per-kernel counts to
``--out`` (``chiprun_out/trace_prefill.json``).
"""

from __future__ import annotations

import argparse
import collections
import json
import math
import statistics
import sys
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = Path(__file__).resolve().parents[1]
for _p in (str(ROOT), str(ROOT / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from clutchbench.kinds.lm import model_config  # noqa: E402
from repro_torch.models import lm as M  # noqa: E402

CONFIG = ROOT / "clutchbench" / "configs" / "jamba2-mini-16l.json"
MAX_LEN = 5500


class _Made(TorchDispatchMode):
    """The number of operations, the largest tensor they make and the
    largest whose trailing dimensions are ``scan``: views and results
    written into an input (the weights' own storage, the cache) are not
    made."""

    def __init__(self, scan: tuple[int, int]) -> None:
        super().__init__()
        self.scan, self.ops = scan, 0
        self.largest, self.scan_shaped = (0, ()), (0, ())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops += 1
        held = {a.untyped_storage().data_ptr()
                for a in [*args, *(kwargs or {}).values()]
                if isinstance(a, torch.Tensor)}
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if (not isinstance(t, torch.Tensor) or t._is_view()
                    or t.untyped_storage().data_ptr() in held):
                continue
            made = (t.numel(), tuple(t.shape))
            self.largest = max(self.largest, made)
            if tuple(t.shape[-2:]) == self.scan:
                self.scan_shaped = max(self.scan_shaped, made)
        return out


def _kernels(prof) -> collections.Counter:
    return collections.Counter(
        e.name for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tokens", type=int, nargs=2, default=(4999, 1249))
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"
                                         / "trace_prefill.json"))
    args = ap.parse_args(argv)
    cfg = model_config(json.loads(CONFIG.read_text())["model"])
    dev = torch.device("cuda")
    params = M.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    rng = np.random.default_rng(1)
    report = {"card": torch.cuda.get_device_name(0), "lengths": {}}
    for s in args.tokens:
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (1, s))).to(dev)

        def run():
            return M.prefill(cfg, params, {"tokens": tokens},
                             max_len=MAX_LEN)

        with torch.no_grad():
            run()
            times = []
            for _ in range(3):
                a, b = (torch.cuda.Event(enable_timing=True)
                        for _ in range(2))
                a.record()
                run()
                b.record()
                b.synchronize()
                times.append(a.elapsed_time(b))
            cuda = torch.profiler.ProfilerActivity.CUDA
            with torch.profiler.profile(activities=[cuda]) as prof:
                run()
                torch.cuda.synchronize()
            with _Made((cfg.d_inner_ssm, cfg.ssm_d_state)) as made:
                run()
            torch.cuda.synchronize()
        kernels = _kernels(prof)
        bsdn = s * cfg.d_inner_ssm * cfg.ssm_d_state
        report["lengths"][s] = {
            "ms": statistics.median(times), "launches": sum(kernels.values()),
            "scan_launches": sum(n for k, n in kernels.items()
                                 if "selective_scan" in k),
            "ops": made.ops, "largest": made.largest,
            "scan_shaped": made.scan_shaped, "b_s_din_n": bsdn,
            "kernels": dict(kernels.most_common())}
    lens = list(report["lengths"].values())
    mamba = cfg.block_pattern.count("mamba") * (
        cfg.num_layers // len(cfg.block_pattern))
    report["ok"] = (len({r["ops"] for r in lens}) == 1
                    and all(r["scan_launches"] == mamba
                            and 0 < r["scan_shaped"][0] < r["b_s_din_n"]
                            for r in lens))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(report, indent=1) + "\n")
    print(json.dumps({k: v for k, v in report.items() if k != "lengths"}
                     | {"lengths": {s: {k: v for k, v in r.items()
                                        if k != "kernels"}
                                    for s, r in report["lengths"].items()}}))
    return 0 if report["ok"] and not math.isnan(lens[0]["ms"]) else 1


if __name__ == "__main__":
    sys.exit(main())
