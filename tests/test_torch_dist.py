"""Gradient compression, the compressed data-parallel step and the
GPipe ``pipeline_forward``: the port against the reference's, the step
on a one-device mesh with Auto axes (``jax.sharding.Mesh(devices[:1],
("data",))``), where the gradient all-reduce is the identity as it is
on one card; the pipeline against the reference's on a (4, 2) mesh of
host devices, in a subprocess as ``tests/test_dist.py`` runs it.

Tolerances, and why: ``quantize``/``dequantize`` bit for bit (one
float32 division, a round half to even, a clip).  Three steps from the
same parameters and batches: loss within 1e-5 relative; parameters
within 2 lr per step taken, with at most 1e-3 of the elements beyond
1e-5 (Adam's sign steps, as ``test_torch_train_step.py``; largest
share seen 8e-5).  The error-feedback residual ``err`` lies within half
a quantum (``scale / 2``) of zero; where the port's and the reference's
inputs to one rounding straddle a half, it flips by one quantum, so
every element is held within one quantum, ``2.01 * max|err|`` of its
leaf, and after the first step (identical parameters) at most 1e-3 of
the elements differ by more than a tenth of one.  ``pipeline_forward``
bit for bit against its stages run in order, one microbatch at a time,
and within 1e-6 of the reference's (float32 ``tanh(x @ W)`` stages of
16-term sums, in another framework).
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from _torch_train_util import flat_np, one_torch_thread, setup  # noqa: F401
from repro.configs.base import ShapeConfig
from repro.data.pipeline import SyntheticLM
from repro.dist import compression as JC
from repro.dist import ddp as JD
from repro.train import optimizer as JO
from repro_torch import convert
from repro_torch.dist import compression as C
from repro_torch.dist import ddp as D
from repro_torch.dist.pipeline import pipeline_forward
from repro_torch.train import optimizer as O

LR = 1e-3
ROOT = Path(__file__).resolve().parents[1]


def test_quantize_bit_for_bit_over_many_scales():
    """The scale is a float32 division by 127, as the reference's: a
    product with 1/127 rounds otherwise for some magnitudes."""
    rng = np.random.default_rng(1)
    for row in (rng.normal(size=(64, 300))
                * 10.0 ** rng.uniform(-6, 6, (64, 1))).astype(np.float32):
        jq, js = JC.quantize(jnp.asarray(row))
        q, s = C.quantize(torch.from_numpy(row))
        assert s.numpy().tobytes() == np.asarray(js).tobytes()
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))


@pytest.mark.parametrize("case", ["normal", "tiny", "zero", "one_value",
                                  "halves", "extremes"])
def test_quantize_and_dequantize_bit_for_bit(case):
    rng = np.random.default_rng(0)
    g = {"normal": rng.normal(size=(1000,)),
         "tiny": rng.normal(size=(64, 33)) * 1e-30,
         "zero": np.zeros((7, 5)),
         "one_value": np.full((9,), -3.5),
         # scale 1: values on k + 1/2 quanta round half to even
         "halves": np.array([127, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5]),
         "extremes": np.array([-2.0, 2.0, 1.0, -1.0, 1.9999999])}[case]
    g = g.astype(np.float32)
    jq, js = JC.quantize(jnp.asarray(g))
    q, s = C.quantize(torch.from_numpy(g))
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.dim() == 0
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.numpy().tobytes() == np.asarray(js).tobytes()
    back = C.dequantize(q, s)
    assert back.numpy().tobytes() == np.asarray(JC.dequantize(jq, js)).tobytes()
    assert int(q.abs().max()) <= 127
    if case == "zero":
        assert float(s) == 0.0 and not q.any()
    if case == "extremes":
        assert q.numpy().tolist()[:2] == [-127, 127]
    if case == "halves":
        assert q.numpy().tolist() == [127, 0, 2, 2, 0, -2, -2, 126]


@pytest.mark.parametrize("compress", [False, True])
def test_three_ddp_steps_match_the_reference(compress):
    cfg, jp, tp = setup("minitron-8b")
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    oc = JO.OptConfig(lr=LR, warmup_steps=2, total_steps=20)
    toc = O.OptConfig(lr=LR, warmup_steps=2, total_steps=20)
    jo = JO.init_opt_state(oc, jp)
    to = convert.opt_state(jax.tree.map(np.asarray, jo))
    je = JD.init_error_state(jp)
    te = convert.lm_params(jax.tree.map(np.asarray, je))
    jstep = JD.make_ddp_step(cfg, oc, mesh, "data", compress=compress)
    tstep = D.make_ddp_step(cfg, toc, compress=compress)
    src = SyntheticLM(cfg, ShapeConfig("t", 32, 4, "train"), seed=1)
    for i in range(3):
        b = src.batch_at(i)
        jp, jo, je, jl = jstep(jp, jo, je, {k: jnp.asarray(v[0])
                                            for k, v in b.items()})
        tp, to, te, tl = tstep(tp, to, te, {k: torch.from_numpy(v[0])
                                            for k, v in b.items()})
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
        w, g = flat_np(jp), flat_np(tp)
        far = total = 0
        for k in w:
            d = np.abs(g[k] - w[k])
            assert d.max() <= 2 * LR * (i + 1), (k, d.max())
            far += int((d > 1e-5).sum())
            total += d.size
        assert far <= 1e-3 * total, (far, total)
        ew, eg = flat_np(je), flat_np(te)
        if not compress:
            assert not any(v.any() for v in eg.values())
            continue
        flips = total = 0
        for k in ew:
            quantum = 2.01 * float(np.abs(ew[k]).max())
            d = np.abs(eg[k] - ew[k])
            assert d.max() <= quantum + 1e-12, (k, i, d.max(), quantum)
            flips += int((d > 0.1 * quantum).sum())
            total += d.size
        if i == 0:
            assert flips <= 1e-3 * total, (flips, total)


def test_init_error_state_is_float32_zeros_like_params():
    _, _, tp = setup("granite-moe-3b-a800m")
    err = D.init_error_state(tp)
    for (k, p), (k2, e) in zip(flat_np(tp).items(), flat_np(err).items()):
        assert k == k2 and e.shape == p.shape and e.dtype == np.float32
        assert not e.any()


def _stage(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(x @ w)


def _pipeline_inputs(stages: int, micro: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    ws = (rng.normal(size=(stages, 16, 16)) * .3).astype(np.float32)
    xs = rng.normal(size=(micro, 5, 16)).astype(np.float32)
    return ws, xs


@pytest.mark.parametrize("stages,micro", [(4, 6), (4, 8), (1, 3), (3, 1),
                                          (2, 2)])
def test_pipeline_forward_equals_the_stages_run_in_order(stages, micro):
    """Fill and drain with more, as many and fewer microbatches than
    stages; one stage; every stage on the CPU."""
    ws, xs = map(torch.from_numpy, _pipeline_inputs(stages, micro))
    got = pipeline_forward(_stage, ["cpu"] * stages, ws, xs)
    for m in range(micro):
        x = xs[m]
        for s in range(stages):
            x = _stage(ws[s], x)
        assert torch.equal(got[m], x), m


def test_pipeline_forward_equals_the_reference_subprocess(tmp_path):
    """The reference's pipeline over the "pod" axis of a (4, 2) mesh of
    8 host devices, as ``tests/test_dist.py`` runs it."""
    ws, xs = _pipeline_inputs(4, 6)
    np.save(tmp_path / "ws.npy", ws)
    np.save(tmp_path / "xs.npy", xs)
    code = textwrap.dedent(f"""
        import jax, jax.numpy as jnp, numpy as np
        from repro.dist.pipeline import pipeline_forward
        mesh = jax.make_mesh((4, 2), ("pod", "model"))
        ws = jnp.asarray(np.load({str(tmp_path / "ws.npy")!r}))
        xs = jnp.asarray(np.load({str(tmp_path / "xs.npy")!r}))
        got = pipeline_forward(lambda W, x: jnp.tanh(x @ W), mesh, "pod",
                               ws, xs)
        np.save({str(tmp_path / "want.npy")!r}, np.asarray(got))
    """)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
           "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    want = np.load(tmp_path / "want.npy")
    got = pipeline_forward(_stage, ["cpu"] * 4, torch.from_numpy(ws),
                           torch.from_numpy(xs))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_pipeline_forward_rejects_a_stage_count_mismatch():
    ws, xs = map(torch.from_numpy, _pipeline_inputs(3, 2))
    with pytest.raises(ValueError, match="3 stages vs 4 devices"):
        pipeline_forward(_stage, ["cpu"] * 4, ws, xs)
