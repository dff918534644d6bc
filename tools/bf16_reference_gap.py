#!/usr/bin/env python3
"""The bf16 gap between the port's and the reference's forward logits,
on reduced archs on the CPU, with XLA's excess precision on (as the
reference runs) and off.

    JAX_PLATFORMS=cpu python3 tools/bf16_reference_gap.py [ARCH ...]

The reference's ``init_params`` (key 5) draws bf16 weights, which
``repro_torch.convert.lm_params`` carries across bit for bit; 2 prompts
of 12 tokens (NumPy seed 5) go through both forwards, MoE layers on the
no-drop capacity factor.  XLA on the CPU may keep f32 between fused
bf16 ops; the port rounds after each op.  Each arch runs in a child
process per setting of ``--xla_allow_excess_precision``; one JSON line
per run: the largest and the mean absolute logit gap, and the largest
logit.  Imports both packages, like the tests.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["granite-moe-3b-a800m", "rwkv6-3b", "jamba-v0.1-52b"]


def gap(arch: str) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from repro.configs import get_config
    from repro.models import lm as JM
    from repro_torch import convert
    from repro_torch.models import lm as M

    cfg = dataclasses.replace(get_config(arch).reduced(),
                              param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.num_experts)))
    jp = JM.init_params(cfg, jax.random.PRNGKey(5))
    tp = convert.lm_params(jax.tree.map(np.asarray, jp))
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (2, 12)
                                             ).astype(np.int32)
    want = np.asarray(JM.forward_logits(cfg, jp,
                                        {"tokens": jnp.asarray(toks)}))
    got = M.forward_logits(cfg, tp, {"tokens": torch.from_numpy(toks)})
    d = np.abs(got.numpy() - want)
    return {"arch": arch, "max": float(d.max()), "mean": float(d.mean()),
            "largest_logit": float(np.abs(want).max())}


def main() -> None:
    if os.environ.get("BF16_GAP_CHILD"):
        out = gap(sys.argv[1])
        out["xla_flags"] = os.environ.get("XLA_FLAGS", "")
        print(json.dumps(out), flush=True)
        return
    for arch in sys.argv[1:] or ARCHS:
        for flags in ("", "--xla_allow_excess_precision=false"):
            env = dict(os.environ, BF16_GAP_CHILD="1", XLA_FLAGS=flags,
                       JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
            subprocess.run([sys.executable, __file__, arch], env=env,
                           check=True)


if __name__ == "__main__":
    main()
