"""The port's training loop, checkpoints and launcher: against the
reference's ``run_training`` on a one-device mesh with Auto axes, and
counterparts of every test of ``tests/test_train_system.py`` (the three
that fail in the reference under JAX 0.9.0, whose ``jax.make_mesh``
axes are Explicit, included).

Tolerances: the loop's losses within 1e-5 relative of the reference's
over 8 steps (the train step's own, ``test_torch_train_step.py``; the
largest seen is 4e-7); restart determinism within the reference's own
2e-3; checkpoints bit for bit.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from _torch_train_util import flat_np, one_torch_thread  # noqa: F401
from repro.configs import get_config as jget_config
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.models import lm as JM
from repro.train import checkpoint as JC
from repro.train import loop as JL
from repro.train import optimizer as JO
from repro_torch import convert
from repro_torch.configs import ARCHS
from repro_torch.configs.base import ShapeConfig
from repro_torch.serve.engine import SamplerConfig, sample, threshold_mask
from repro_torch.train import loop as TL
from repro_torch.train import optimizer as O
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.loop import TrainConfig, run_training

ROOT = Path(__file__).resolve().parents[1]


def small_cfg():
    return ARCHS["minitron-8b"].reduced()


def _train(tmp_path, name: str, steps: int, shape=(32, 8), oc=None,
           **kw) -> dict:
    tc = dict(steps=steps, checkpoint_every=100,
              checkpoint_dir=str(tmp_path / name), log_every=1)
    tc.update(kw.pop("tcfg", {}))
    return run_training(small_cfg(), ShapeConfig("t", *shape, "train"),
                        TrainConfig(**tc), oc, device="cpu", **kw)


def test_run_training_matches_the_reference_loss_for_loss(tmp_path,
                                                          monkeypatch):
    cfg = jget_config("minitron-8b").reduced()
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                ("data", "model"))
    oc = JO.OptConfig(lr=3e-4, warmup_steps=2, total_steps=8)
    want = JL.run_training(cfg, JShapeConfig("t", 32, 8, "train"), mesh,
                           JL.TrainConfig(steps=8, checkpoint_every=100,
                                          checkpoint_dir=str(tmp_path / "a"),
                                          log_every=1), oc)
    jp = jax.tree.map(np.asarray, JM.init_params(cfg, jax.random.PRNGKey(0)))
    monkeypatch.setattr(TL, "init_params",
                        lambda c, gen, device: convert.lm_params(jp, device))
    got = _train(tmp_path, "b", 8, oc=O.OptConfig(lr=3e-4, warmup_steps=2,
                                                  total_steps=8))
    assert [r["step"] for r in got["log"]] == list(range(8))
    np.testing.assert_allclose([r["loss"] for r in got["log"]],
                               [r["loss"] for r in want["log"]], rtol=1e-5)
    np.testing.assert_allclose([r["grad_norm"] for r in got["log"]],
                               [r["grad_norm"] for r in want["log"]],
                               rtol=1e-4)
    assert sorted(got) == sorted(want)


def test_training_loss_decreases(tmp_path):
    out = _train(tmp_path, "ck", 40, tcfg={"log_every": 10})
    assert out["last_loss"] < out["first_loss"] - 0.5, out


def test_checkpoint_restart_is_deterministic(tmp_path):
    """Train 20 steps; vs train 10, 'crash', resume to 20 -- the data
    pipeline is keyed by step, so the loss trajectory must agree."""
    oc = O.OptConfig(lr=3e-4, warmup_steps=2, total_steps=20)
    full = _train(tmp_path, "a", 20, oc=oc)
    _train(tmp_path, "b", 10, oc=oc, tcfg={"checkpoint_every": 10})
    resumed = _train(tmp_path, "b", 20, oc=oc, tcfg={"checkpoint_every": 10})
    assert resumed["steps"] == 10
    want = [r["loss"] for r in full["log"] if r["step"] >= 10]
    got = [r["loss"] for r in resumed["log"] if r["step"] >= 10]
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


def test_nothing_to_do_past_the_last_step(tmp_path):
    _train(tmp_path, "c", 3, shape=(16, 2))
    out = _train(tmp_path, "c", 3, shape=(16, 2))
    assert out["steps"] == 0 and "note" in out


def test_checkpoint_corruption_detected(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2)
    tree = {"w": torch.arange(64, dtype=torch.float32)}
    cm.save(5, tree, blocking=True)
    path = tmp_path / "step_00000005"
    fn = [f for f in os.listdir(path) if f.endswith(".npy")][0]
    arr = np.load(path / fn)
    arr[0] += 1
    np.save(path / fn, arr)
    with pytest.raises(OSError, match="checksum"):
        cm.restore(5, tree)


def test_checkpoint_gc_and_latest(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2)
    tree = {"w": torch.zeros(8)}
    for s in (1, 2, 3, 4):
        cm.save(s, tree, blocking=True)
    assert cm.all_steps() == [3, 4]
    assert cm.latest_step() == 4


def test_checkpoint_torn_write_ignored(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=3)
    tree = {"w": torch.zeros(8)}
    cm.save(7, tree, blocking=True)
    # a crashed writer leaves a .tmp dir, empty or whole but for the
    # rename: neither is listed
    os.makedirs(tmp_path / "step_00000009.tmp")
    shutil.copytree(tmp_path / "step_00000007", tmp_path / "step_00000011.tmp")
    assert cm.all_steps() == [7]


def test_straggler_watchdog_flags_injected_delay(tmp_path):
    out = _train(tmp_path, "ck", 16, shape=(32, 4), inject_delay_at=12,
                 tcfg={"log_every": 10})
    assert any(e["step"] == 12 for e in out["straggler_events"]), \
        out["straggler_events"]


def test_elastic_restore_onto_another_device_and_layout(tmp_path):
    """Checkpoints hold logical arrays: a leaf restores exactly onto the
    device of ``like`` (the meta device stands in for another one here),
    whatever that leaf's memory layout."""
    cm = CheckpointManager(str(tmp_path), keep=2)
    w = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    tree = {"w": w.t(), "b": torch.arange(8, dtype=torch.bfloat16)}
    cm.save(1, tree, blocking=True)
    out = cm.restore(1, {"w": torch.empty(8, 8), "b": torch.empty(8)})
    assert torch.equal(out["w"], w.t()) and out["w"].is_contiguous()
    assert out["b"].dtype == torch.bfloat16
    assert torch.equal(out["b"], tree["b"])
    meta = cm.restore(1, {"w": torch.empty(8, 8, device="meta"),
                          "b": torch.empty(8, device="meta")})
    assert meta["w"].device.type == "meta" and meta["w"].shape == (8, 8)


def test_clutch_sampler_equals_torch_sampler():
    cfg = small_cfg()
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.normal(size=(4, 512)).astype(np.float32)
                              * 5)
    clutch, plain = (SamplerConfig(use_clutch_mask=True),
                     SamplerConfig(use_clutch_mask=False))
    a = sample(cfg, logits, torch.Generator().manual_seed(0), clutch)
    b = sample(cfg, logits, torch.Generator().manual_seed(0), plain)
    assert torch.equal(a, b)
    assert torch.equal(threshold_mask(logits, clutch)[1],
                       threshold_mask(logits, plain)[1])


def test_optimizer_schedule():
    oc = O.OptConfig(lr=1.0, warmup_steps=10, total_steps=100)
    assert float(O.schedule(oc, 0)) < 0.2
    assert abs(float(O.schedule(oc, 10)) - 1.0) < 0.1
    assert float(O.schedule(oc, 99)) < 0.01


def _tree(seed: int, dtype=jnp.float32) -> dict:
    rng = np.random.default_rng(seed)
    return {"params": {"a": jnp.asarray(rng.normal(size=(4, 6)), dtype),
                       "b": {"c": jnp.asarray(rng.normal(size=(3,)), dtype)}},
            "opt": {"count": jnp.int32(7)}}


def _port(tree) -> dict:
    return convert.lm_params(jax.tree.map(np.asarray, tree))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_a_reference_checkpoint_restores_bit_equal_in_the_port(tmp_path,
                                                               dtype):
    tree = _tree(0, dtype)
    JC.CheckpointManager(str(tmp_path), keep=2).save(3, tree, blocking=True)
    cm = CheckpointManager(str(tmp_path))
    assert cm.latest_step() == 3
    got = cm.restore(3, _port(tree))
    want = _port(tree)
    for k, v in flat_np(want).items():
        g = flat_np(got)[k]
        assert g.dtype == v.dtype and g.tobytes() == v.tobytes(), k


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_port_writes_the_reference_files_byte_for_byte(tmp_path, dtype):
    jtree = _tree(1, jnp.float32 if dtype == torch.float32 else jnp.bfloat16)
    JC.CheckpointManager(str(tmp_path / "ref")).save(2, jtree, blocking=True)
    CheckpointManager(str(tmp_path / "port")).save(2, _port(jtree),
                                                   blocking=True)
    a, b = tmp_path / "ref" / "step_00000002", tmp_path / "port" / "step_00000002"
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for fn in os.listdir(a):
        assert (a / fn).read_bytes() == (b / fn).read_bytes(), fn
    if dtype == torch.float32:
        back = JC.CheckpointManager(str(tmp_path / "port")).restore(2, jtree)
        for k, v in flat_np(jtree).items():
            assert flat_np(back)[k].tobytes() == v.tobytes(), k


def test_launch_train_prints_the_reference_summary(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "minitron-8b", "--reduced", "--device", "cpu", "--steps", "3",
         "--checkpoint-dir", str(tmp_path / "ck")],
        env=env, capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    summary = json.loads(out.stdout[:out.stdout.index("}") + 1])
    assert sorted(summary) == ["first_loss", "last_loss", "steps",
                               "straggler_events"]
    assert summary["steps"] == 3 and np.isfinite(summary["last_loss"])
    assert "{'step': 2, 'loss':" in out.stdout
    assert os.listdir(tmp_path / "ck") == ["step_00000003"]
