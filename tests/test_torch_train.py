"""Training on the port, piece by piece, against the reference:
``forward_loss`` and the gradient of every leaf on all ten reduced archs
(float32, the CPU), remat, ``apply_updates`` and ``schedule``.

Tolerances, and why:

* loss within 1e-5 relative, and each gradient leaf within
  ``GRAD_RTOL`` of its largest magnitude: the two frameworks sum in
  other orders (float32 ulp 1.2e-7), and the order differences gather
  over the depth; the largest seen is jamba's embedding gradient,
  3.4e-4 on 14.3 (2.4e-5 of it), over 16 blocks;
* ``apply_updates`` on identical float32 inputs: parameters and moments
  within 2 float32 ulps of their value plus 2 ulps at the leaf's largest
  magnitude (``2.4e-7 * max|leaf|``): the global norm sums in another
  order, so the clip scale may differ by an ulp, and XLA's fused loop
  rounds ``p - lr * step`` otherwise than two eager ops; where a sum
  cancels, one rounding of its operands is large beside the result.
  bf16 parameters and moments within one bf16 ulp (the float32 results
  round to bf16 once);
* ``schedule``: warmup steps bit-equal; the cosine within ``2^-22 * lr``
  (``torch.cos`` and XLA's cos differ by an ulp at magnitude 1, scaled
  by ``lr / 2``; 2.44 * 2^-24 * lr is the largest seen, over 1,000
  steps).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train_util import (  # noqa: F401 (a fixture)
    flat_np, loss_batch, one_torch_thread, setup, to_jax, to_torch)
from repro.configs import ARCHS
from repro.models import lm as JM
from repro.train import optimizer as JO
from repro_torch import convert
from repro_torch.models import lm as M
from repro_torch.train import optimizer as O
from repro_torch.train.train_step import value_and_grad
from repro_torch.train.tree import flatten

GRAD_RTOL = 5e-5
LOSS_RTOL = 1e-5
ULPS2 = 2.4e-7


def _close_leafwise(got: dict, want: dict, rtol: float):
    assert list(got) == list(want)
    for k in want:
        scale = float(np.abs(want[k]).max())
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=rtol * scale + 1e-30, err_msg=k)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_forward_loss_and_every_gradient_match_the_reference(arch):
    cfg, jp, tp = setup(arch)
    batch = loss_batch(cfg)
    jl, jg = jax.value_and_grad(
        lambda p: JM.forward_loss(cfg, p, to_jax(batch)))(jp)
    tl, tg = value_and_grad(cfg, tp, to_torch(batch))
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    want = flat_np(jg)
    got = {k: np.zeros_like(want[k]) if g is None else g.numpy()
           for k, g in zip(want, tg)}
    _close_leafwise(got, want, GRAD_RTOL)
    assert all(not p.requires_grad for p in flatten(tp).values())


def test_forward_loss_counts_only_the_unmasked_labels():
    cfg, _, tp = setup("minitron-8b")
    batch = to_torch(loss_batch(cfg))
    logits = M.forward_logits(cfg, tp, batch)
    lab = batch["labels"].long()
    keep = lab >= 0
    nll = torch.logsumexp(logits, -1) - logits.gather(
        -1, lab.clamp(min=0)[..., None])[..., 0]
    torch.testing.assert_close(M.forward_loss(cfg, tp, batch),
                               nll[keep].mean(), rtol=1e-6, atol=0)
    none = dict(batch, labels=torch.full_like(batch["labels"], -100))
    assert float(M.forward_loss(cfg, tp, none)) == 0.0


def _saved_bytes(cfg, params, batch) -> int:
    total = 0

    def pack(t):
        nonlocal total
        total += t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        value_and_grad(cfg, params, batch)
    return total


@pytest.mark.parametrize("arch", ["minitron-8b", "granite-moe-3b-a800m",
                                  "jamba-v0.1-52b", "whisper-base"])
def test_remat_changes_memory_and_not_numbers(arch):
    cfg, _, tp = setup(arch)
    batch = to_torch(loss_batch(cfg))
    off = dataclasses.replace(cfg, remat=False)
    on_loss, on_grads = value_and_grad(cfg, tp, batch)
    off_loss, off_grads = value_and_grad(off, tp, batch)
    assert torch.equal(on_loss, off_loss)
    for a, b in zip(on_grads, off_grads):
        assert (a is None and b is None) or torch.equal(a, b)
    # remat keeps each period's input, not its activations
    assert _saved_bytes(cfg, tp, batch) < _saved_bytes(off, tp, batch) / 2


def _random_tree(like, rng, dtype=np.float32, scale=1.0, square=False):
    """Normal draws times ``scale`` shaped like ``like`` (squared, for a
    second moment of the size a first moment of ``scale`` goes with)."""
    def draw(shape):
        x = rng.normal(size=shape) * scale
        return (x * x if square else x).astype(dtype)

    return {k: _random_tree(v, rng, dtype, scale, square)
            if isinstance(v, dict) else draw(v.shape)
            for k, v in like.items()}


@pytest.mark.parametrize("count", [0, 7])
def test_apply_updates_matches_the_reference_on_float32_trees(count):
    cfg, jp, _ = setup("granite-moe-3b-a800m")
    rng = np.random.default_rng(count)
    params = _random_tree(jp, rng)
    grads = _random_tree(jp, rng)
    state = {"mu": _random_tree(jp, rng, scale=1e-2),
             "nu": _random_tree(jp, rng, scale=1e-2, square=True),
             "count": np.int32(count)}
    oc = JO.OptConfig(lr=1e-2, warmup_steps=3, total_steps=20)
    jnew, jstate, jstats = JO.apply_updates(
        oc, jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, grads),
        jax.tree.map(jnp.asarray, state))
    tnew, tstate, tstats = O.apply_updates(
        O.OptConfig(**dataclasses.asdict(oc)), convert.lm_params(params),
        convert.lm_params(grads), convert.opt_state(state))
    np.testing.assert_allclose(float(tstats["grad_norm"]),
                               float(jstats["grad_norm"]), rtol=1e-6)
    assert float(tstats["lr"]) == float(jstats["lr"])
    assert int(tstate["count"]) == count + 1
    for want, got in ((jnew, tnew), (jstate["mu"], tstate["mu"]),
                      (jstate["nu"], tstate["nu"])):
        w, g = flat_np(want), flat_np(got)
        for k in w:
            np.testing.assert_allclose(
                g[k], w[k], rtol=ULPS2,
                atol=ULPS2 * float(np.abs(w[k]).max()), err_msg=k)


def test_apply_updates_decays_by_the_whole_leafs_rank():
    """Period-stacked norm scales [P, D] are matrices to the decay rule;
    an unstacked [D] scale is not."""
    cfg, jp, tp = setup("minitron-8b")
    zero = convert.lm_params(jax.tree.map(lambda x: np.zeros(x.shape,
                                                             np.float32), jp))
    oc = O.OptConfig(lr=0.5, warmup_steps=0, total_steps=10,
                     weight_decay=0.1)
    before_p = tp["periods"]["block0"]["norm1"]["scale"].clone()
    before_f = tp["final_norm"]["scale"].clone()
    O.apply_updates(oc, tp, zero, O.init_opt_state(oc, tp))
    lr = float(O.schedule(oc, 0))
    torch.testing.assert_close(tp["periods"]["block0"]["norm1"]["scale"],
                               before_p * (1 - lr * 0.1))
    assert torch.equal(tp["final_norm"]["scale"], before_f)


def test_apply_updates_on_bf16_parameters_and_moments():
    cfg, jp, _ = setup("minitron-8b")
    rng = np.random.default_rng(5)
    bf16 = jnp.bfloat16
    params = jax.tree.map(lambda x: x.astype(bf16), jax.tree.map(
        jnp.asarray, _random_tree(jp, rng)))
    grads = jax.tree.map(lambda x: x.astype(bf16), jax.tree.map(
        jnp.asarray, _random_tree(jp, rng)))
    oc = JO.OptConfig(lr=1e-2, warmup_steps=2, total_steps=20,
                      opt_dtype="bfloat16")
    state = JO.init_opt_state(oc, params)
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    tp, tg = convert.lm_params(np_tree(params)), convert.lm_params(np_tree(grads))
    ts = convert.opt_state(np_tree(state))
    toc = O.OptConfig(**dataclasses.asdict(oc))
    for _ in range(2):
        params, state, _ = JO.apply_updates(oc, params, grads, state)
        tp, ts, _ = O.apply_updates(toc, tp, tg, ts)
    for want, got in ((params, tp), (state["mu"], ts["mu"]),
                      (state["nu"], ts["nu"])):
        w = flat_np(jax.tree.map(lambda x: x.astype(jnp.float32), want))
        for k, g in flatten(got).items():
            assert g.dtype == torch.bfloat16
            g = g.float().numpy()
            ulp = np.abs(w[k]) * 2.0 ** -7 + 1e-38   # one bf16 ulp, or less
            assert np.all(np.abs(g - w[k]) <= ulp), k


@pytest.mark.parametrize("total", [100, 1000])
def test_schedule_matches_the_reference_at_every_step(total):
    oc = JO.OptConfig(lr=3e-4, warmup_steps=10, total_steps=total)
    toc = O.OptConfig(**dataclasses.asdict(oc))
    f = jax.jit(lambda s: JO.schedule(oc, s))
    for step in range(0, total + 1):
        want = np.float32(f(jnp.int32(step)))
        got = O.schedule(toc, step)
        assert got.dtype == torch.float32 and got.dim() == 0
        got = np.float32(got.item())
        if step < 10:
            assert got == want, step
        else:
            assert abs(float(got) - float(want)) <= 2.0 ** -22 * oc.lr, step
