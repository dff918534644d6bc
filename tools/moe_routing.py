#!/usr/bin/env python3
"""Decode against forward for a full-width MoE arch of ``repro_torch``,
in bf16 and on a float32 copy of the same weights, with the tokens whose
experts differ between the two computations, layer by layer.

    python3 tools/moe_routing.py [--arch ARCH] [--device cpu --reduced]

(``--arch`` defaults to ``granite-moe-3b-a800m``.)

Weights are random from ``torch.Generator(device).manual_seed(0)``, the
MoE on its no-drop capacity factor (``num_experts``), 2 prompts of 256
tokens from NumPy seed 1, as ``chip_smoke.py`` phase 7 checks them: the
forward's logits at position 255 against a prefill of 255 tokens and
one decode step.  Per MoE layer it counts the prompt tokens (prefill
against forward) and the last tokens (decode against forward) whose set
of top-k experts differs, and gives the smallest gap between the k-th
and (k+1)-th router logit among the prompt tokens that part.  Prints
one JSON object per dtype.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm as M  # noqa: E402

PROMPT = 256


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-moe-3b-a800m")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.num_experts)))
    k = cfg.moe.top_k
    params = M.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, PROMPT))).to(dev)

    routes = []
    dispatch = L.moe_dispatch

    def record(cfg_, router, xf, capacity_factor):
        out = dispatch(cfg_, router, xf, capacity_factor)
        logits = torch.sort(xf.float() @ router, -1, descending=True).values
        routes.append((out[1].view(-1, k).sort(-1).values.cpu(),
                       (logits[:, k - 1] - logits[:, k]).cpu()))
        return out

    L.moe_dispatch = record
    for dtype in (cfg.param_dtype, "float32"):
        c = dataclasses.replace(cfg, param_dtype=dtype, compute_dtype=dtype)
        p = params if dtype == cfg.param_dtype else _cast(params)
        routes.clear()
        full = M.forward_logits(c, p, {"tokens": toks})[:, -1, :cfg.vocab]
        fwd = list(routes)
        routes.clear()
        _, cache = M.prefill(c, p, {"tokens": toks[:, :-1]}, max_len=512)
        pre = list(routes)
        routes.clear()
        step, _ = M.decode_step(c, p, cache, toks[:, -1:], PROMPT - 1)
        step = step[:, 0, :cfg.vocab]
        prompt_flips, last_flips, margins = [], [], []
        for (f, fm), (q, _), (d, _) in zip(fwd, pre, routes):
            f = f.view(2, PROMPT, k)
            part = (f[:, :-1].reshape(-1, k) != q).any(-1)
            prompt_flips.append(int(part.sum()))
            last_flips.append(int((f[:, -1] != d).any(-1).sum()))
            if part.any():
                fm = fm.view(2, PROMPT)[:, :-1].reshape(-1)
                margins.append(float(fm[part].min()))
        diff = (step - full).abs()
        print(json.dumps({
            "arch": args.arch, "dtype": dtype, "device": str(dev),
            "card": (torch.cuda.get_device_name(0) if dev.type == "cuda"
                     else None),
            "decode_vs_forward_max": float(diff.max()),
            "decode_vs_forward_mean": float(diff.mean()),
            "largest_logit": float(full.abs().max()),
            "prompt_tokens_routed_otherwise": prompt_flips,
            "last_tokens_routed_otherwise": last_flips,
            "smallest_margin_where_routed_otherwise":
                min(margins) if margins else None}), flush=True)
        del cache, full, step


def _cast(tree: dict) -> dict:
    return {n: _cast(v) if isinstance(v, dict) else v.float()
            for n, v in tree.items()}


if __name__ == "__main__":
    main()
