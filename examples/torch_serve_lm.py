"""Batched LM serving with the Clutch threshold sampler on the
PyTorch/CUDA port: the min-p logit mask (the paper's vector-scalar
comparison, the ``minp_mask`` kernel on the card) in the sampler of the
continuous-batching engine, against the plain float mask.

    PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.configs import ARCHS
from repro_torch.kernels.common import resolve_device
from repro_torch.models import lm as M
from repro_torch.serve.engine import Request, SamplerConfig, ServeEngine


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = ARCHS["rwkv6-3b"].reduced()   # attention-free: O(1)-state decode
    params = M.init_params(cfg, torch.Generator(device).manual_seed(0),
                           device)
    outs = []
    for use_clutch in (True, False):
        rng = np.random.default_rng(0)
        eng = ServeEngine(cfg, params, num_slots=4, max_len=96,
                          sc=SamplerConfig(min_p=0.05,
                                           use_clutch_mask=use_clutch),
                          seed=7, device=device)
        reqs = [Request(rid=i,
                        prompt=rng.integers(0, cfg.vocab, 12
                                            ).astype(np.int32),
                        max_new_tokens=24)
                for i in range(10)]
        t0 = time.perf_counter()
        done = eng.run(reqs)
        dt = time.perf_counter() - t0
        toks = sum(len(r.out_tokens) for r in done)
        outs.append({r.rid: r.out_tokens for r in done})
        label = "clutch-minp" if use_clutch else "float-minp "
        print(f"{label}: {len(done)} requests, {toks} tokens, "
              f"{toks / dt:7.1f} tok/s on {device}")
    assert outs[0] == outs[1], "the two samplers drew different tokens"
    print("\nthe two samplers drew the same tokens")
    return 0


if __name__ == "__main__":
    sys.exit(main())
