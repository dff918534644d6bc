"""The port stands alone and never falls back silently.

* importing every ``repro_torch`` module loads neither ``jax`` nor any
  module of the reference package ``repro``;
* no source of the port (nor ``chip_smoke.py``) imports them;
* with no CUDA and no ``device`` given, entry points raise;
* a kernel wrapper given CPU tensors runs its plain version and leaves
  its launch count at 0 (``minp_mask`` included); the serving slice's
  entry points are covered in ``test_torch_serve.py``.
"""

import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.kernels as K
from repro_torch.apps.gbdt import ObliviousForest
from repro_torch.apps.predicate import Table
from repro_torch.core.encoding import make_plan
from repro_torch.kernels import fused_session, ops, ref
from repro_torch.pud import PudSession

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_importing_every_module_loads_no_jax_and_no_reference():
    mods = list(_modules())
    for m in ("kernels.fused_session", "kernels.clutch_merge",
              "kernels.bitserial_cmp", "kernels.leaf_gather",
              "kernels.fused_query", "kernels.ops", "kernels.minp_mask",
              "configs.registry", "models.layers", "models.lm",
              "serve.engine", "launch.serve", "data.pipeline",
              "train.tree", "train.optimizer", "train.train_step",
              "train.checkpoint", "train.straggler", "train.loop",
              "launch.train", "dist.compression", "dist.ddp",
              "core.machine", "core.clutch", "core.cost", "core.scheduler",
              "core.encoding", "core.bitserial", "core.device",
              "apps.pipeline", "apps.predicate", "apps.gbdt",
              "pud.executors", "pud.session",
              "pud.planner", "serve.pud_service", "serve.arrivals",
              "serve.admission", "serve.batcher", "serve.loop"):
        assert f"repro_torch.{m}" in mods
    code = textwrap.dedent(f"""
        import importlib, sys
        for m in {mods!r}:
            importlib.import_module(m)
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "repro" or m.startswith("repro."))
        print("LOADED", bad)
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) +
                         [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_no_jax_and_no_reference(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, name)


def test_entry_points_raise_without_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    t = Table.generate(100, 8, num_features=2, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PudSession(backend="fused")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fused_session.FusedTableExec(t, num_shards=1, num_chunks=2)
    f = ObliviousForest.random(4, 2, 2, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fused_session.FusedGbdtExec(f, num_chunks=1)
    assert PudSession(backend="fused", device="cpu").device.type == "cpu"
    logits = np.zeros((2, 5), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ops.sample_threshold_mask(logits, np.zeros(2, np.float32))
    assert ops.sample_threshold_mask(logits, np.zeros(2, np.float32),
                                     device="cpu").device.type == "cpu"


def test_training_entry_points_raise_without_cuda_unless_cpu_is_asked(
        monkeypatch, tmp_path):
    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import train as launch_train
    from repro_torch.train.loop import TrainConfig, run_training

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ARCHS["minitron-8b"].reduced()
    tc = TrainConfig(steps=1, checkpoint_dir=str(tmp_path / "a"))
    shape = ShapeConfig("t", 8, 2, "train")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_training(cfg, shape, tc)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(["--arch", "minitron-8b", "--reduced", "--steps",
                           "1", "--checkpoint-dir", str(tmp_path / "b")])
    assert run_training(cfg, shape, tc, device="cpu")["steps"] == 1


def test_wrappers_on_cpu_take_the_plain_version_and_count_nothing():
    K.reset_launch_counts()
    rng = np.random.default_rng(0)
    v = torch.from_numpy(rng.integers(0, 16, (128, 32)).astype(np.int32))
    assert torch.equal(K.temporal_encode(v, 4),
                       ref.temporal_encode_ref(v.reshape(-1), 4))
    lut = ops.encode_lut(v.reshape(-1), make_plan(8, 2))[None]
    idx = rng.integers(0, lut.shape[1], 8).astype(np.int32)
    bm, cnt = K.fused_predicate_banked(lut, idx, 2, 1)
    want = ref.fused_predicate_banked_ref(lut, idx, 2, 1)
    assert torch.equal(bm, want[0]) and torch.equal(cnt, want[1])
    bm, _ = K.fused_compound_banked(lut, np.concatenate([idx, idx]), 2,
                                    (1, 1), (False, False), (True,))
    assert torch.equal(bm, want[0])
    masks = lut[0, :8]
    gidx = torch.from_numpy(rng.integers(0, lut.shape[1], (3, 4))
                            .astype(np.int32))
    assert torch.equal(
        K.gbdt_leafbits_banked(lut[0], masks, gidx, 1, 2),
        ref.gbdt_leafbits_banked_ref(lut[0], masks, gidx, 1, 2))
    logits = torch.from_numpy(rng.normal(size=(3, 7)).astype(np.float32))
    tau = logits[:, 2].contiguous()
    assert torch.equal(K.minp_mask(logits, tau),
                       ref.minp_mask_ref(logits, tau))
    assert "minp_mask" in K.KERNELS
    assert K.launch_counts() == dict.fromkeys(K.KERNELS, 0)


def test_wrappers_reject_out_of_range_and_misshapen_indices():
    lut = torch.zeros((1, 16, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="outside"):
        K.fused_predicate_banked(lut, np.array([0, 1, 2, 16], np.int32), 1, 1)
    with pytest.raises(ValueError, match="outside"):
        K.fused_predicate_banked(lut, np.array([0, -1, 2, 3], np.int32), 1, 1)
    with pytest.raises(ValueError, match="idx must be"):
        K.fused_predicate_banked(lut, np.zeros(5, np.int32), 1, 1)
    with pytest.raises(ValueError, match="idx must be"):
        K.gbdt_leafbits_banked(lut[0], lut[0, :8], np.zeros((2, 3), np.int32),
                               1, 2)
    with pytest.raises(TypeError):
        K.temporal_encode(torch.zeros((4, 32), dtype=torch.int64), 4)
