"""Shared set-up of the port's mesh tests: ``run_ranks`` starts one
process per rank of a gloo group on the CPU
(``tests/_torch_mesh_worker.py``), each with a time limit, and returns
what each rank reported; ``start_python`` runs the reference in a
subprocess with forced host devices."""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).resolve().parent / "_torch_mesh_worker.py"


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env(extra: dict) -> dict:
    env = {**os.environ, **extra}
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    return env


def start_ranks(case: str, world: int, args: dict) -> list:
    """One worker process per rank of a ``world``-rank gloo group
    running ``case`` with ``args``."""
    port = free_port()
    return [subprocess.Popen(
        [sys.executable, str(WORKER), case, json.dumps(args)],
        env=_env({"RANK": str(r), "WORLD_SIZE": str(world),
                  "MASTER_ADDR": "localhost", "MASTER_PORT": str(port),
                  "OMP_NUM_THREADS": "1"}),
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(world)]


def finish(procs: list, timeout: float) -> list[dict]:
    """Each rank's last stdout line as JSON; every process is ended
    (killed past ``timeout`` seconds) and a failing rank fails the
    caller with its error output."""
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            if p.returncode != 0:
                raise AssertionError(
                    f"rank exited {p.returncode}:\n{err[-4000:]}")
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def run_ranks(case: str, world: int, args: dict, timeout: float
              ) -> list[dict]:
    return finish(start_ranks(case, world, args), timeout)


def save_params(arch: str, path) -> str:
    """The reference's initial parameters of the reduced ``arch``
    (``PRNGKey(0)``, as its ``run_training`` draws them) as a flat
    ``.npz``."""
    import jax
    import numpy as np

    from repro.configs import get_config
    from repro.models import lm
    from repro_torch.train.tree import flatten

    cfg = get_config(arch).reduced()
    jp = jax.tree.map(np.asarray, lm.init_params(cfg, jax.random.PRNGKey(0)))
    np.savez(path, **flatten(jp))
    return str(path)


def start_python(code: str, devices: int) -> subprocess.Popen:
    """``python -c code`` with ``devices`` forced JAX host devices (the
    reference on a multi-device mesh)."""
    return subprocess.Popen(
        [sys.executable, "-c", code],
        env=_env({"XLA_FLAGS":
                  f"--xla_force_host_platform_device_count={devices}",
                  "JAX_PLATFORMS": "cpu"}),
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
