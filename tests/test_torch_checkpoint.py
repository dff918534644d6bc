"""The port's asynchronous checkpoint against in-place training.

``CheckpointManager.save`` hands the tree to a writer thread and
returns; the train step then updates parameters and moments in place.
A save must therefore own a private host copy of every leaf before the
thread starts, or the files hold (part of) the next step's values: with
a crc32 that matches them, so the restore cannot tell.

Both tests hold the writer back as late as it may run -- until after
the caller has written the saved tensors -- and require the restore to
equal the values at save time bit for bit.
"""

import json
import os
import threading

import pytest
import torch

from _torch_train_util import one_torch_thread  # noqa: F401 (a fixture)
from repro_torch.configs import ARCHS
from repro_torch.configs.base import ShapeConfig
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.loop import TrainConfig, run_training
from repro_torch.train.tree import flatten, unflatten

STEPS = 4


def _bits(t: torch.Tensor) -> bytes:
    return t.detach().reshape(-1).view(torch.uint8).numpy().tobytes()


def _hold_writers_until_waited(monkeypatch) -> None:
    """Each writer thread starts writing only once its manager's
    ``wait()`` is called: at the next save, or at the end of a run,
    after the caller has gone on with its tensors."""
    write, wait = CheckpointManager._write, CheckpointManager.wait
    gates: dict[int, threading.Event] = {}

    def held_write(self, step, flat):
        gates.setdefault(id(self), threading.Event()).wait()
        write(self, step, flat)

    def opening_wait(self):
        gates.setdefault(id(self), threading.Event()).set()
        wait(self)
        gates[id(self)] = threading.Event()

    monkeypatch.setattr(CheckpointManager, "_write", held_write)
    monkeypatch.setattr(CheckpointManager, "wait", opening_wait)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_a_save_owns_its_leaves_while_the_writer_waits(tmp_path,
                                                       monkeypatch, dtype):
    """Saved CPU leaves (contiguous, a transposed view, a 0-d scalar)
    are each ``add_(1.0)``-ed before the writer runs; the restore holds
    the values of the save."""
    release = threading.Event()
    write = CheckpointManager._write

    def held_write(self, step, flat):
        release.wait()
        write(self, step, flat)

    monkeypatch.setattr(CheckpointManager, "_write", held_write)
    gen = torch.Generator().manual_seed(0)
    tree = {"w": torch.randn(64, 33, generator=gen).to(dtype),
            "opt": {"m": torch.randn(1000, generator=gen).to(dtype),
                    "t": torch.randn(5, 7, generator=gen).to(dtype).t(),
                    "count": torch.tensor(3.0, dtype=dtype)}}
    want = {k: _bits(v) for k, v in flatten(tree).items()}
    cm = CheckpointManager(str(tmp_path))
    cm.save(1, tree)
    for leaf in flatten(tree).values():
        leaf.add_(1.0)
    release.set()
    cm.wait()
    got = flatten(cm.restore(1, tree))
    assert list(got) == list(want)
    for k, v in got.items():
        assert v.dtype == dtype and _bits(v) == want[k], k


def test_training_with_a_save_every_step_restores_as_blocking_saves(
        tmp_path, monkeypatch):
    """``run_training`` on the CPU with ``checkpoint_every=1``: every
    step's checkpoint, written while the next step runs, restores bit
    for bit as the checkpoint of a run whose saves block."""
    cfg = ARCHS["minitron-8b"].reduced()
    shape = ShapeConfig("t", 16, 2, "train")

    def train(name: str) -> CheckpointManager:
        tc = TrainConfig(steps=STEPS, checkpoint_every=1,
                         keep_checkpoints=STEPS,
                         checkpoint_dir=str(tmp_path / name))
        run_training(cfg, shape, tc, device="cpu")
        return CheckpointManager(tc.checkpoint_dir, keep=STEPS)

    with monkeypatch.context() as m:
        save = CheckpointManager.save
        m.setattr(CheckpointManager, "save",
                  lambda self, step, tree, blocking=False:
                  save(self, step, tree, blocking=True))
        blocking = train("blocking")
    with monkeypatch.context() as m:
        _hold_writers_until_waited(m)
        late = train("late")
    assert late.all_steps() == blocking.all_steps() == \
        list(range(1, STEPS + 1))
    for step in blocking.all_steps():
        saved = blocking.restore(step, _like(blocking, step))
        want = {k: _bits(v) for k, v in flatten(saved).items()}
        got = flatten(late.restore(step, saved))
        assert list(got) == list(want)
        for k, v in got.items():
            assert _bits(v) == want[k], (step, k)


def _like(cm: CheckpointManager, step: int) -> dict:
    """A CPU tree of the manifest's leaf names, for ``restore``."""
    path = os.path.join(cm.dir, f"step_{step:08d}", "manifest.json")
    with open(path) as f:
        names = json.load(f)["leaves"]
    return unflatten({k: torch.empty(0) for k in names})
