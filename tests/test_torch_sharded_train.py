"""The port's training on a real multi-rank mesh: four gloo ranks on the
CPU (``tests/_torch_mesh_worker.py``), against the reference on a
four-device Auto-axes ``jax.sharding.Mesh`` in a subprocess with forced
host devices, and against the port's own one-device step.

Tolerances: losses within 1e-5 relative and gradient norms within 1e-4
of the reference's, as ``tests/test_torch_train_loop.py`` holds the
one-card loop (sums over shards run in another order in each package);
the sharded step against the port's unsharded one within the same
float32 tolerances; checkpoints bit for bit.  Each launch has a time
limit of its own.
"""

import json

import numpy as np
import pytest

from _torch_mesh_util import (
    finish,
    run_ranks,
    save_params,
    start_python,
    start_ranks,
)

ARCHS = ("qwen2.5-32b", "granite-moe-3b-a800m")
STEPS, SEQ, BATCH = 3, 32, 8
TIMEOUT = 240


REF_TRAIN = """
import json, sys, tempfile
import jax, numpy as np
from jax.sharding import Mesh
from repro.configs import get_config
from repro.configs.base import ShapeConfig
from repro.train import loop as L, optimizer as O
assert len(jax.devices()) == 4
mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
out = {}
for arch in %(archs)r:
    cfg = get_config(arch).reduced()
    r = L.run_training(
        cfg, ShapeConfig("t", %(seq)d, %(batch)d, "train"), mesh,
        L.TrainConfig(steps=%(steps)d, checkpoint_every=100, log_every=1,
                      checkpoint_dir=tempfile.mkdtemp(dir=%(tmp)r)),
        O.OptConfig(lr=3e-4, warmup_steps=2, total_steps=%(steps)d))
    out[arch] = [[x["loss"], x["grad_norm"]] for x in r["log"]]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Both archs trained by the reference and by the port's four ranks,
    the two launches running side by side."""
    tmp = tmp_path_factory.mktemp("sharded_train")
    ref = start_python(REF_TRAIN % {"archs": ARCHS, "seq": SEQ,
                                    "batch": BATCH, "steps": STEPS,
                                    "tmp": str(tmp)}, devices=4)
    jobs = {arch: start_ranks("train", 4, {
        "arch": arch, "params": save_params(arch, tmp / f"{i}.npz"),
        "mesh": [2, 2], "seq": SEQ, "batch": BATCH, "steps": STEPS,
        "ckdir": str(tmp / f"ck{i}")}) for i, arch in enumerate(ARCHS)}
    try:
        out, err = ref.communicate(timeout=TIMEOUT)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    got = {arch: finish(procs, TIMEOUT) for arch, procs in jobs.items()}
    assert ref.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1]), got


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_training_matches_the_reference_mesh(trained, arch):
    want, got = trained
    want = np.array(want[arch])
    for rank in got[arch]:
        have = np.array(rank["sharded"])
        assert have.shape == (STEPS, 2)
        np.testing.assert_allclose(have[:, 0], want[:, 0], rtol=1e-5)
        np.testing.assert_allclose(have[:, 1], want[:, 1], rtol=1e-4)
    assert want[-1, 0] < want[0, 0]


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_equals_the_unsharded_step(trained, arch):
    _, got = trained
    ranks = got[arch]
    plain = np.array(ranks[0]["plain"])
    for rank in ranks:
        np.testing.assert_allclose(np.array(rank["sharded"])[:, 0],
                                   plain[:, 0], rtol=1e-5)
        np.testing.assert_allclose(np.array(rank["sharded"])[:, 1],
                                   plain[:, 1], rtol=1e-4)


@pytest.mark.parametrize("save_mesh,load_mesh", [([2, 2], [2, 2]),
                                                 ([2, 2], [1, 4])])
def test_sharded_checkpoint_restores_onto_a_mesh(tmp_path, save_mesh,
                                                 load_mesh):
    out = run_ranks("checkpoint", 4, {
        "arch": "granite-moe-3b-a800m", "save_mesh": save_mesh,
        "load_mesh": load_mesh, "ckdir": str(tmp_path)}, TIMEOUT)
    assert [r["same"] for r in out] == [True] * 4
    assert [r["placed"] for r in out] == [True] * 4
