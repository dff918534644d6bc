"""The dry run on a fake mesh: ``torch.distributed``'s fake process
group and meta-device tensors in this process (one rank standing for
sixteen), and the CLI in a subprocess on the fake 256-rank production
mesh.

Checks: ``run_cell`` on reduced configs of one arch per block kind
(attention + MoE, dense decode, RWKV, mamba hybrid, encoder-decoder)
writes the reference's fields with finite, positive counts; the
per-device FLOPs of a step whose every product shards evenly, times the
16 ranks, equal ``FlopCounterMode``'s count of the unsharded step
(exactly: the same products, split); the reference's own case, a
[512, 512] x [512, 512] product over 4 ranks counting 2 * 512^3 / 4;
the collective counter on one known all-gather (bf16 [8, 128], 2,048
bytes, as the reference's parser test states it); ``RooflineTerms``'
bottleneck with the card's peaks, as ``tests/test_dist.py`` checks the
reference's.
"""

import dataclasses
import json
import math
import subprocess
import sys

import pytest
import torch

from _torch_mesh_util import ROOT, _env
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun as D
from repro_torch.launch import roofline as R
from repro_torch.models import loops
from repro_torch.train import optimizer as O
from repro_torch.train import train_step as T

#: the reference's record fields (src/repro/launch/dryrun.py run_cell)
FIELDS = {"arch", "shape", "variant", "mesh", "chips", "microbatches",
          "memory_analysis", "full_step_cost", "full_step_collectives",
          "compile_s", "n_params", "n_params_active", "roofline",
          "components", "model_flops", "model_flops_ratio", "total_s"}


@pytest.fixture(scope="module")
def mesh44():
    """A fake 16-rank default group (this process rank 0) and a (4, 4)
    ("data", "model") mesh; the group is destroyed after."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    D.ensure_fake_group(16)
    try:
        yield init_device_mesh("cpu", (4, 4),
                               mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


CELLS = [("granite-moe-3b-a800m", "train_4k"), ("minitron-8b", "decode_32k"),
         ("rwkv6-3b", "long_500k"), ("jamba-v0.1-52b", "prefill_32k"),
         ("whisper-base", "train_4k")]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_run_cell_on_reduced_configs(mesh44, arch, shape, monkeypatch):
    full = SHAPES[shape]
    small = ShapeConfig(shape, min(full.seq_len, 128),
                        min(full.global_batch, 16), full.kind)
    monkeypatch.setitem(SHAPES, shape, small)
    cfg = ARCHS[arch].reduced()
    r = D.run_cell(arch, shape, False, cfg=cfg, mesh=mesh44)
    assert FIELDS <= set(r), FIELDS - set(r)
    assert r["mesh"] == "4x4" and r["chips"] == 16
    assert r["full_step_cost"]["flops"] > 0
    assert r["full_step_cost"]["bytes"] > 0
    assert sum(r["full_step_collectives"].values()) > 0
    assert all(v > 0 for v in r["memory_analysis"].values())
    rf = r["roofline"]
    assert rf["bottleneck"] in ("compute", "memory", "collective")
    assert math.isfinite(r["model_flops_ratio"]) and \
        r["model_flops_ratio"] > 0
    names = {"train": {"period_grad", "head_grad", "embed_grad",
                       "opt_update"},
             "prefill": {"period_fwd", "head_fwd"},
             "decode": {"period_decode", "head_decode"}}[small.kind]
    if cfg.enc_dec and small.kind == "train":
        names.add("enc_period_grad")
    assert set(r["components"]) == names
    for c in r["components"].values():
        assert c["mult"] >= 1 and c["bytes"] > 0
    # each leaf is split over at most the 16 ranks, never lost
    for k, v in r["per_device_bytes"].items():
        assert v * 16 >= r["unsharded_bytes"][k] and \
            v <= r["unsharded_bytes"][k]


def test_per_device_flops_times_ranks_equal_the_unsharded_count(mesh44):
    """A dense model whose heads, widths and batch all divide the (4, 4)
    mesh: every product of its train step shards evenly, so each rank
    counts 1/16 of the unsharded step's FLOPs."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg = dataclasses.replace(ARCHS["minitron-8b"].reduced(), n_kv_heads=4,
                              remat=False)
    shape = ShapeConfig("t", 32, 8, "train")
    got = D.lower_full_step(cfg, shape, mesh44, micro=2)["flops"]
    oc = O.OptConfig(opt_dtype=cfg.opt_dtype)
    with torch.device("meta"):
        params = D._fake(D.abstract_params(cfg))
        opt = O.init_opt_state(oc, params)
        batch = D.input_sds(cfg, shape, 2)
        with FlopCounterMode(display=False) as fc, \
                D._MetaHostReads():
            T.make_train_step(cfg, oc)(params, opt, batch)
    assert got * 16 == fc.get_total_flops(), (got * 16,
                                              fc.get_total_flops())


def _unsampled(fn):
    """``fn()`` with every step of every loop run (no sampler)."""
    import contextlib

    orig = D.counted

    @contextlib.contextmanager
    def unsampled(mesh):
        with orig(mesh) as c:
            token = loops.STEP_SAMPLER.set(None)
            try:
                yield c
            finally:
                loops.STEP_SAMPLER.reset(token)

    D.counted = unsampled
    try:
        return fn()
    finally:
        D.counted = orig


@pytest.mark.parametrize("arch,kind,micro", [
    ("rwkv6-3b", "prefill", 1),          # a time-step recurrence
    ("jamba-v0.1-52b", "prefill", 1),    # mamba's scan
    ("minitron-8b", "train", 4),         # a train step's microbatches
])
def test_sampled_loops_count_every_step(mesh44, arch, kind, micro):
    """Counted from one sampled step, a loop's FLOPs, bytes and
    collectives equal those of running every step.  (A recurrence's
    backward runs outside the sampled step and is counted once: train
    cells of the RWKV and mamba archs undercount it.)"""
    cfg = ARCHS[arch].reduced()
    shape = ShapeConfig("t", 16, 8, kind)
    sampled = D.lower_full_step(cfg, shape, mesh44, micro=micro)
    every = _unsampled(lambda: D.lower_full_step(cfg, shape, mesh44,
                                                 micro=micro))
    assert sampled["flops"] == every["flops"] > 0
    assert sampled["collectives"] == every["collectives"]
    assert math.isclose(sampled["bytes"], every["bytes"], rel_tol=1e-12)


def test_a_512_matmul_over_four_ranks_counts_a_quarter(mesh44):
    """The reference's statement of per-device terms: a [512, 512] x
    [512, 512] product over 4 ranks counts 2 * 512^3 / 4."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    mesh = init_device_mesh("cpu", (4, 4), mesh_dim_names=("a", "b"))["a"]
    with torch.device("meta"):
        a = distribute_tensor(torch.empty(512, 512), mesh, [Shard(0)],
                              src_data_rank=None)
        b = distribute_tensor(torch.empty(512, 512), mesh, [Replicate()],
                              src_data_rank=None)
        with R.StepCounter() as c:
            a @ b
    assert c.flops == 2 * 512 ** 3 / 4
    assert c.collectives == {}


def test_collective_bytes_of_one_all_gather(mesh44):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    mesh = init_device_mesh("cpu", (4, 4), mesh_dim_names=("a", "b"))["a"]
    x = distribute_tensor(torch.zeros(8, 128, dtype=torch.bfloat16), mesh,
                          [Shard(0)], src_data_rank=None)
    got = R.collective_bytes(lambda: x.redistribute(mesh, [Replicate()]))
    assert got == {"all-gather": 8 * 128 * 2}
    got = R.collective_bytes(lambda: x.full_tensor() * 2)
    assert got == {"all-gather": 8 * 128 * 2}


def test_roofline_terms_bottleneck():
    t = R.RooflineTerms(flops=989e12, bytes_hbm=1e9, bytes_collective=1e9,
                        chips=256)
    assert abs(t.t_compute - 1.0) < 1e-9
    assert t.bottleneck == "compute"
    t2 = R.RooflineTerms(flops=1e12, bytes_hbm=3.35e12, bytes_collective=0,
                         chips=256)
    assert t2.bottleneck == "memory" and abs(t2.t_memory - 1.0) < 1e-9
    t3 = R.RooflineTerms(flops=0, bytes_hbm=0, bytes_collective=450e9,
                         chips=256)
    assert t3.bottleneck == "collective" and t3.t_bound == 1.0
    assert set(t.as_dict()) == {"flops", "bytes_hbm", "bytes_collective",
                                "chips", "t_compute_s", "t_memory_s",
                                "t_collective_s", "bottleneck"}


def test_the_cli_on_the_fake_256_rank_production_mesh(tmp_path):
    """``python -m repro_torch.launch.dryrun`` at full width; 60-s
    limit (about 20 s here)."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "granite-moe-3b-a800m", "--shape", "train_4k", "--skip-components",
         "--out", str(tmp_path)], env=_env({}), cwd=ROOT,
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads((tmp_path / "granite-moe-3b-a800m_train_4k_pod1.json"
                    ).read_text())
    assert FIELDS - {"components"} <= set(r)
    assert r["mesh"] == "16x16" and r["chips"] == 256
    assert r["microbatches"] == 8
    assert r["n_params"] == 3_374_679_552
    for k, v in r["per_device_bytes"].items():
        assert v * 256 >= r["unsharded_bytes"][k]
    assert r["model_flops_ratio"] > 0
