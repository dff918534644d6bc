"""End-to-end training on the PyTorch/CUDA port: a ~100M-parameter
qwen2.5-family model trained for a few hundred steps on one device with
the port's stack -- train step, AdamW, async checkpoints, straggler
watchdog, deterministic restart.

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 300] [--device cpu]

(On the card this takes minutes; on the CPU use ``--steps 20`` for a
quick check.)
"""

import argparse
import dataclasses
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs import ARCHS
from repro_torch.configs.base import ShapeConfig
from repro_torch.train import optimizer as O
from repro_torch.train.loop import TrainConfig, run_training


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory (default: a temporary one)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    # ~100M-param qwen-family config (12 layers, d=512, 32k vocab)
    cfg = dataclasses.replace(
        ARCHS["qwen2.5-32b"],
        num_layers=12, d_model=512, n_heads=8, n_kv_heads=4, d_head=64,
        d_ff=2048, vocab=32000, param_dtype="float32",
        compute_dtype="float32", remat=False,
    )
    n_params = (cfg.vocab * cfg.d_model * 2 +
                cfg.num_layers * (cfg.d_model * (cfg.n_heads +
                                                 2 * cfg.n_kv_heads) *
                                  cfg.d_head + cfg.n_heads * cfg.d_head *
                                  cfg.d_model + 3 * cfg.d_model * cfg.d_ff))
    print(f"model: ~{n_params/1e6:.0f}M params")
    shape = ShapeConfig("train", seq_len=256, global_batch=8, kind="train")
    with tempfile.TemporaryDirectory() as tmp:
        out = run_training(
            cfg, shape,
            TrainConfig(steps=args.steps, microbatches=2,
                        checkpoint_every=100,
                        checkpoint_dir=args.ckpt or tmp, log_every=20),
            O.OptConfig(lr=1e-3, warmup_steps=min(20, args.steps // 2 or 1),
                        total_steps=args.steps),
            device=args.device)
    for row in out["log"]:
        print(f"  step {row['step']:4d}  loss {row['loss']:.4f}  "
              f"|g| {row['grad_norm']:.3f}")
    print(f"loss: {out['first_loss']:.3f} -> {out['last_loss']:.3f} over "
          f"{out['steps']} steps")
    assert out["last_loss"] < out["first_loss"]
    return 0


if __name__ == "__main__":
    sys.exit(main())
