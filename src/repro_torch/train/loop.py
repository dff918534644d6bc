"""Training loop: data prefetch, the train step, checkpoint/restart,
straggler watchdog, metrics log.

Counterpart of the reference package's ``train/loop.py`` on one card:
there is no mesh, ``run_training`` takes ``device=`` (the card unless
another is named).  Resume, checkpoint cadence, log rows, straggler
injection and the summary's keys are the reference's.  Each step's
prefetched NumPy batch goes to the device once.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.data.pipeline import Prefetcher, SyntheticLM
from repro_torch.kernels.common import resolve_device
from repro_torch.models.lm import init_params

from . import optimizer as O
from . import train_step as T
from .checkpoint import CheckpointManager
from .straggler import StragglerWatchdog


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    microbatches: int = 1
    checkpoint_every: int = 50
    checkpoint_dir: str = "checkpoints"
    keep_checkpoints: int = 3
    log_every: int = 10
    seed: int = 0
    resume: bool = True


def run_training(cfg: ModelConfig, shape: ShapeConfig, tcfg: TrainConfig,
                 opt_cfg: O.OptConfig | None = None,
                 inject_delay_at: int | None = None, device=None) -> dict:
    """Returns summary metrics.  Parameters are drawn from a
    ``torch.Generator`` on ``device`` seeded ``tcfg.seed``.
    ``inject_delay_at`` simulates a straggler at that step (used by the
    fault-tolerance test)."""
    device = resolve_device(device)
    opt_cfg = opt_cfg or O.OptConfig(total_steps=tcfg.steps,
                                     warmup_steps=max(tcfg.steps // 20, 1),
                                     opt_dtype=cfg.opt_dtype)
    params = init_params(cfg, torch.Generator(device).manual_seed(tcfg.seed),
                         device)
    opt_state = O.init_opt_state(opt_cfg, params)

    ckpt = CheckpointManager(tcfg.checkpoint_dir, keep=tcfg.keep_checkpoints)
    start_step = 0
    if tcfg.resume and ckpt.latest_step() is not None:
        start_step = ckpt.latest_step()
        state = ckpt.restore(start_step, {"params": params, "opt": opt_state})
        params, opt_state = state["params"], state["opt"]

    if start_step >= tcfg.steps:
        return {"first_loss": float("nan"), "last_loss": float("nan"),
                "steps": 0, "straggler_events": [], "log": [],
                "note": f"checkpoint at step {start_step} >= steps "
                        f"{tcfg.steps}; nothing to do"}
    step_fn = T.make_train_step(cfg, opt_cfg)
    src = SyntheticLM(cfg, shape, seed=tcfg.seed,
                      microbatches=tcfg.microbatches)
    pf = Prefetcher(src, start_step=start_step)
    dog = StragglerWatchdog()
    losses, log = [], []
    try:
        for step in range(start_step, tcfg.steps):
            data_step, batch = pf.next()
            if data_step != step:
                raise RuntimeError(f"prefetched step {data_step}, "
                                   f"expected {step}")
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in batch.items()}
            dog.step_begin()
            params, opt_state, stats = step_fn(params, opt_state, batch)
            loss = float(stats["loss"])
            if inject_delay_at is not None and step == inject_delay_at:
                time.sleep(1.0)
            dog.step_end(step)
            losses.append(loss)
            if step % tcfg.log_every == 0 or step == tcfg.steps - 1:
                log.append({"step": step, "loss": loss,
                            "grad_norm": float(stats["grad_norm"])})
            if (step + 1) % tcfg.checkpoint_every == 0 or \
                    step == tcfg.steps - 1:
                ckpt.save(step + 1, {"params": params, "opt": opt_state})
    finally:
        pf.close()
        ckpt.wait()
    return {
        "first_loss": losses[0],
        "last_loss": losses[-1],
        "steps": len(losses),
        "straggler_events": dog.events,
        "log": log,
    }
