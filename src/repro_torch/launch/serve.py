"""Serving launcher: batched requests through the continuous-batching
engine with Clutch threshold sampling, on the card unless ``--device``
names another.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch minitron-8b \\
        --reduced --requests 8 --max-new 16 [--device cpu]

Weights are random, drawn from a ``torch.Generator`` seeded 0 on the
serving device; prompts are 8 tokens drawn by NumPy from seed 0, as in
the reference's launcher.  Prints the reference's JSON keys.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.common import resolve_device
from repro_torch.models import lm as M
from repro_torch.serve.engine import Request, SamplerConfig, ServeEngine


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--greedy", action="store_true")
    ap.add_argument("--no-clutch-mask", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device to serve on (default: the card; "
                         "'cpu' runs the kernels' plain versions)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = M.init_params(cfg, torch.Generator(device).manual_seed(0),
                           device)
    sc = SamplerConfig(greedy=args.greedy,
                       use_clutch_mask=not args.no_clutch_mask)
    eng = ServeEngine(cfg, params, num_slots=args.slots,
                      max_len=args.max_len, sc=sc, device=device)
    rng = np.random.default_rng(0)
    reqs = [
        Request(rid=i,
                prompt=rng.integers(0, cfg.vocab, 8).astype(np.int32),
                max_new_tokens=args.max_new)
        for i in range(args.requests)
    ]
    t0 = time.time()
    done = eng.run(reqs)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    total_toks = sum(len(r.out_tokens) for r in done)
    print(json.dumps({
        "requests": len(done),
        "generated_tokens": total_toks,
        "seconds": round(dt, 2),
        "tok_per_s": round(total_toks / dt, 1),
        "sampler": "clutch-minp" if sc.use_clutch_mask else "torch-minp",
    }, indent=1))
    for r in done[:4]:
        print(f"  req {r.rid}: {r.out_tokens}")


if __name__ == "__main__":
    main()
