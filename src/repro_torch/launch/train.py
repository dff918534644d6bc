"""Training launcher, on the card unless ``--device`` names another.

    PYTHONPATH=src python -m repro_torch.launch.train --arch minitron-8b \\
        --steps 200 --reduced [--device cpu] --checkpoint-dir /tmp/ckpt

``--reduced`` runs the smoke-scale config and shape on the host mesh,
``(1, world_size)`` over whatever process group there is, as the
reference does: one made here for this process alone (NCCL on the card,
gloo with ``--device cpu``) unless ``torchrun`` started several.
Without it the full config and shape run on the one device, with no
mesh (the reference's production mesh needs 256 ranks:
``python -m repro_torch.launch.dryrun`` models it).  Prints the
reference's JSON summary and log rows.
"""

from __future__ import annotations

import argparse
import json
import os

from repro_torch.configs import SHAPES, get_config
from repro_torch.train import optimizer as O
from repro_torch.train.loop import TrainConfig, run_training


def _on_host_mesh(fn, device):
    """``fn(make_host_mesh())``, with a process group made for it when
    none is up: the environment's (``torchrun``) if it names a world,
    else this process alone over a local store; one made here is
    destroyed after."""
    import torch.distributed as dist

    from repro_torch.kernels.common import resolve_device
    from repro_torch.launch.mesh import make_host_mesh

    made = not dist.is_initialized()
    if made:
        backend = "nccl" if resolve_device(device).type == "cuda" \
            else "gloo"
        if "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend)
        else:
            dist.init_process_group(backend, store=dist.HashStore(),
                                    rank=0, world_size=1)
    try:
        return fn(make_host_mesh())
    finally:
        if made:
            dist.destroy_process_group()


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--checkpoint-dir", default="checkpoints")
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None,
                    help="torch device to train on (default: the card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    shape = SHAPES[args.shape]
    if args.reduced:
        cfg = cfg.reduced()
        shape = shape.reduced()

    tcfg = TrainConfig(
        steps=args.steps,
        microbatches=args.microbatches,
        checkpoint_every=args.checkpoint_every,
        checkpoint_dir=args.checkpoint_dir,
        resume=not args.no_resume,
    )
    opt_cfg = O.OptConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=max(args.steps // 20, 1),
                          opt_dtype=cfg.opt_dtype)
    if args.reduced:
        summary = _on_host_mesh(lambda mesh: run_training(
            cfg, shape, tcfg, opt_cfg, device=args.device, mesh=mesh),
            args.device)
    else:
        summary = run_training(cfg, shape, tcfg, opt_cfg, device=args.device)
    print(json.dumps({k: v for k, v in summary.items() if k != "log"},
                     indent=1))
    for row in summary["log"]:
        print(row)


if __name__ == "__main__":
    main()
