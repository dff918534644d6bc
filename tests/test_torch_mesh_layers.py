"""The port's distributed layers on a real multi-rank mesh: four gloo
ranks on the CPU (``tests/_torch_mesh_worker.py``), each launch with a
time limit of its own.

Tolerances: the compressed DDP step's losses within 1e-5 relative of
the reference's ``make_ddp_step`` on a four-device Auto-axes mesh (run
in a subprocess with forced host devices), parameters within the
criteria ``tests/test_torch_dist.py`` holds the one-card step to;
``sp_decode`` within the reference's own 2e-2 of the full forward
(``tests/test_dist.py``) and within 1e-5 in float32, the largest seen
being 5e-6; the MoE layer within 1e-5 of the reference's.
"""

import json

import jax
import numpy as np
import pytest

from _torch_mesh_util import run_ranks, save_params, start_python
from repro.configs import get_config as jget_config

TIMEOUT = 240


REF_DDP = """
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.configs import get_config
from repro.configs.base import ShapeConfig
from repro.data.pipeline import SyntheticLM
from repro.dist import ddp
from repro.models import lm as M
from repro.train import optimizer as O
mesh = Mesh(np.array(jax.devices()[:4]), ("data",))
cfg = get_config(%(arch)r).reduced()
params = M.init_params(cfg, jax.random.PRNGKey(0))
oc = O.OptConfig(lr=%(lr)r, warmup_steps=2, total_steps=20)
opt = O.init_opt_state(oc, params)
err = ddp.init_error_state(params)
step = ddp.make_ddp_step(cfg, oc, mesh, "data", compress=True)
src = SyntheticLM(cfg, ShapeConfig("t", %(seq)d, %(batch)d, "train"), seed=1)
losses = []
for i in range(%(steps)d):
    b = src.batch_at(i)
    params, opt, err, loss = step(params, opt, err,
                                  {k: jnp.asarray(v[0]) for k, v in b.items()})
    losses.append(float(loss))
flat = {"/".join(str(getattr(k, "key", k)) for k in p): np.asarray(v)
        for tree, name in ((params, "params"), (err, "err"))
        for p, v in jax.tree_util.tree_flatten_with_path({name: tree})[0]}
np.savez(%(out)r, **flat)
print(losses)
"""


def test_compressed_ddp_on_a_data_mesh_matches_the_reference(tmp_path):
    arch, lr = "minitron-8b", 1e-3
    args = {"arch": arch, "lr": lr, "seq": 32, "batch": 8, "steps": 3}
    ref = start_python(REF_DDP % {**args, "out": str(tmp_path / "j.npz")},
                       devices=4)
    got = run_ranks("ddp", 4, {**args, "params": save_params(
        arch, tmp_path / "p.npz"), "out": str(tmp_path / "t.npz")}, TIMEOUT)
    out, err = ref.communicate(timeout=TIMEOUT)
    assert ref.returncode == 0, err[-3000:]
    want = json.loads(out.strip().splitlines()[-1])
    for rank in got:
        np.testing.assert_allclose(rank["losses"], want, rtol=1e-5)
    w, g = np.load(tmp_path / "j.npz"), np.load(tmp_path / "t.npz")
    assert sorted(w.files) == sorted(g.files)
    far = total = 0
    for k in w.files:
        if k.startswith("params/"):
            d = np.abs(g[k] - w[k])
            assert d.max() <= 2 * lr * args["steps"], (k, d.max())
            far += int((d > 1e-5).sum())
            total += d.size
        else:   # error feedback: within one quantization step
            quantum = 2.01 * float(np.abs(w[k]).max())
            assert np.abs(g[k] - w[k]).max() <= quantum + 1e-12, k
    assert far <= 1e-3 * total, (far, total)


def test_sp_decode_on_a_mesh_matches_the_full_forward(tmp_path):
    """``tests/test_dist.py::test_sp_flash_decode_subprocess`` on four
    gloo ranks: the cache sequence-sharded over ("data", "model"), each
    rank holding 8 of its 32 positions."""
    arch = "qwen2.5-32b"
    cfg = jget_config(arch).reduced()
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 24), 0,
                                         cfg.vocab)).tolist()
    out = run_ranks("sp_decode", 4, {
        "arch": arch, "params": save_params(arch, tmp_path / "p.npz"),
        "mesh": [2, 2], "tokens": toks, "max_len": 32}, TIMEOUT)
    for r in out:
        assert r["err"] < 2e-2 and r["err2"] < 2e-2, r
        assert r["err"] < 1e-5 and r["err2"] < 1e-5, r
        assert r["placements"] == ["S(2)", "S(2)"] and r["local_rows"] == 8


@pytest.mark.parametrize("moe_dp", [False, True])
def test_moe_on_a_mesh_drops_the_reference_tokens(tmp_path, moe_dp):
    """granite's MoE (4 experts top-2, reduced) at capacity factor 0.5,
    so tokens are dropped: on a batch-sharded DTensor over a (2, 2) mesh,
    with and without ``moe_dp_sharding``, its output equals the
    reference's ``layers.moe`` on the whole batch within 1e-5 (routing,
    capacity and slot order are the whole batch's) and the port's plain
    run within 1e-6."""
    import dataclasses

    from repro.models import layers as JL

    cfg = dataclasses.replace(jget_config("granite-moe-3b-a800m").reduced(),
                              moe_dp_sharding=moe_dp)
    jp = jax.tree.map(np.asarray, JL.moe_init(cfg, jax.random.PRNGKey(4)))
    x = np.random.default_rng(5).normal(size=(4, 16, cfg.d_model)
                                        ).astype(np.float32)
    want = np.asarray(JL.moe(cfg, jp, x, capacity_factor=0.5))
    np.savez(tmp_path / "moe.npz", **jp)
    np.save(tmp_path / "x.npy", x)
    out = run_ranks("moe", 4, {
        "arch": "granite-moe-3b-a800m", "moe_dp": moe_dp, "cf": 0.5,
        "moe": str(tmp_path / "moe.npz"), "x": str(tmp_path / "x.npy"),
        "out": str(tmp_path / "got.npy")}, TIMEOUT)
    for r in out:
        assert r["dropped"] > 0 and r["err"] < 1e-6, r
    np.testing.assert_allclose(np.load(tmp_path / "got.npy"), want,
                               atol=1e-5, rtol=1e-5)
