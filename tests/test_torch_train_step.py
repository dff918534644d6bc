"""The port's ``make_train_step`` against the reference's jitted one:
three steps of two microbatches from the same parameters and batches,
on six reduced archs (float32, the CPU).

Tolerances, and why: the first step's gradients agree within the
summation-order differences ``test_torch_train.py`` states.  Adam then
moves every element by about ``lr * sign(g)``, so an element whose
gradient is near zero may move 2 lr apart between the two, and later
gradients follow the parameters:

* loss within 1e-5 relative; ``grad_norm`` within 1e-4 relative
  (largest seen 2.1e-5, rwkv's third step); ``lr`` within 2^-22 lr;
* parameters: every element within 2 lr per step taken, and no more
  than 5e-4 of the elements beyond 1e-5 (largest share seen 1.4e-4,
  whisper's third step);
* moments within 3e-4 of the leaf's largest magnitude after the first
  step (largest seen 1.2e-4, jamba's ``nu``) and 5e-3 after the third
  (1.2e-3).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train_util import flat_np, one_torch_thread, setup  # noqa: F401
from repro.configs.base import ShapeConfig
from repro.data.pipeline import SyntheticLM
from repro.train import optimizer as JO
from repro.train import train_step as JT
from repro_torch import convert
from repro_torch.train import optimizer as O
from repro_torch.train import train_step as T

LR = 1e-3
MOMENT_TOL = {1: 3e-4, 3: 5e-3}


def _moments_close(jo, to, step: int):
    for name in ("mu", "nu"):
        w, g = flat_np(jo[name]), flat_np(to[name])
        for k in w:
            tol = MOMENT_TOL[step] * float(np.abs(w[k]).max())
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=tol + 1e-30,
                                       err_msg=f"{name}/{k} step {step}")


@pytest.mark.parametrize("arch", ["minitron-8b", "granite-moe-3b-a800m",
                                  "rwkv6-3b", "jamba-v0.1-52b",
                                  "whisper-base", "llava-next-34b"])
def test_three_train_steps_match_the_reference(arch):
    cfg, jp, tp = setup(arch)
    oc = JO.OptConfig(lr=LR, warmup_steps=1, total_steps=3)
    toc = O.OptConfig(**dataclasses.asdict(oc))
    jo = JO.init_opt_state(oc, jp)
    to = convert.opt_state(jax.tree.map(np.asarray, jo))
    src = SyntheticLM(cfg, ShapeConfig("t", 16, 4, "train"), seed=0,
                      microbatches=2)
    jstep = jax.jit(JT.make_train_step(cfg, oc))
    tstep = T.make_train_step(cfg, toc)
    for i in range(3):
        batch = src.batch_at(i)
        jp, jo, js = jstep(jp, jo, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tp, to, ts = tstep(tp, to, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
        np.testing.assert_allclose(float(ts["loss"]), float(js["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(ts["grad_norm"]),
                                   float(js["grad_norm"]), rtol=1e-4)
        assert abs(float(ts["lr"]) - float(js["lr"])) <= 2.0 ** -22 * LR
        assert int(to["count"]) == int(jo["count"]) == i + 1
        w, g = flat_np(jp), flat_np(tp)
        far = total = 0
        for k in w:
            d = np.abs(g[k] - w[k])
            assert d.max() <= 2 * LR * (i + 1), (k, d.max())
            far += int((d > 1e-5).sum())
            total += d.size
        assert far <= 5e-4 * total, (far, total)
        if i + 1 in MOMENT_TOL:
            _moments_close(jo, to, i + 1)
