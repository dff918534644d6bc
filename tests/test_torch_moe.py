"""MoE: the port's ``layers.moe`` against JAX's.

The reference's ``moe_init`` draws the parameters (the float32 router,
the bf16-or-f32 experts), ``repro_torch.convert.lm_params`` carries them
across bit for bit, and the same NumPy-seeded input goes through both, in
float32 at reduced width.  Outputs agree within 1e-4, and the routing is
the reference's exactly: each assignment's expert, its slot in the
expert's queue and whether it is kept (slot < capacity).  The
reference's routing is read from its own statements (``_jax_routing``,
copied from ``src/repro/models/layers.py`` ``moe``), since ``moe``
returns only the output.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import layers as JL
from repro_torch import convert
from repro_torch.models import layers as L

MOE_ARCHS = ["mixtral-8x7b", "granite-moe-3b-a800m", "jamba-v0.1-52b"]
ATOL = 1e-4


def _cfg(arch: str, **moe):
    cfg = jget_config(arch).reduced()
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **moe))
    return cfg


def _params(cfg, seed: int):
    jp = JL.moe_init(cfg, jax.random.PRNGKey(seed))
    return jp, convert.lm_params(jax.tree.map(np.asarray, jp))


def _x(cfg, seed: int, b: int = 2, s: int = 32) -> np.ndarray:
    return np.random.default_rng(seed).normal(
        size=(b, s, cfg.d_model)).astype(np.float32)


def _jax_routing(cfg, x: np.ndarray, router, capacity_factor: float):
    """(flat_e, slot, keep) of the reference's ``moe``, its statements."""
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    xf = jnp.asarray(x).reshape(-1, x.shape[-1])
    n = xf.shape[0]
    logits = xf.astype(jnp.float32) @ router
    _, gate_idx = jax.lax.top_k(logits, k)
    cap = max(min(int(math.ceil(n * k / e * capacity_factor)), n * k), 8)
    flat_e = gate_idx.reshape(-1)
    nk = flat_e.shape[0]
    order = jnp.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = jnp.zeros((e,), jnp.int32).at[flat_e].add(1)
    offsets = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(counts)[:-1]])
    ranks_sorted = jnp.arange(nk, dtype=jnp.int32) - offsets[sorted_e]
    slot = jnp.zeros((nk,), jnp.int32).at[order].set(ranks_sorted)
    return np.asarray(flat_e), np.asarray(slot), np.asarray(slot < cap)


def _check(cfg, jp, tp, x: np.ndarray, capacity_factor: float
           ) -> np.ndarray:
    """Outputs within ATOL and the routing equal; returns ``keep``."""
    want = np.asarray(JL.moe(cfg, jp, jnp.asarray(x),
                             capacity_factor=capacity_factor))
    got = L.moe(cfg, tp, torch.from_numpy(x),
                capacity_factor=capacity_factor)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    je, js, jk = _jax_routing(cfg, x, jp["router"], capacity_factor)
    _, te, ts, tk, _ = L.moe_dispatch(
        cfg, tp["router"], torch.from_numpy(x).reshape(-1, cfg.d_model),
        capacity_factor)
    np.testing.assert_array_equal(te.numpy(), je)
    np.testing.assert_array_equal(ts.numpy(), js)
    np.testing.assert_array_equal(tk.numpy(), jk)
    return jk


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_without_drops_matches_jax(arch):
    """capacity_factor = num_experts: every assignment is kept."""
    cfg = _cfg(arch)
    jp, tp = _params(cfg, 0)
    keep = _check(cfg, jp, tp, _x(cfg, 0), float(cfg.moe.num_experts))
    assert keep.all()


@pytest.mark.parametrize("capacity_factor", [1.0, 0.5])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_dropping_tokens_matches_jax(arch, capacity_factor):
    """A capacity below the busiest expert's load: the reference drops
    assignments, and the port drops the same ones."""
    cfg = _cfg(arch)
    jp, tp = _params(cfg, 1)
    keep = _check(cfg, jp, tp, _x(cfg, 1), capacity_factor)
    assert not keep.all() and keep.any()


@pytest.mark.parametrize("capacity_factor", [1.25, 40.0])
def test_moe_at_granites_routing_matches_jax(capacity_factor):
    """granite's own 40 experts and top-8 at reduced width, at its
    serving capacity factor (which drops here) and with no drops."""
    cfg = _cfg("granite-moe-3b-a800m", num_experts=40, top_k=8)
    jp, tp = _params(cfg, 2)
    keep = _check(cfg, jp, tp, _x(cfg, 2), capacity_factor)
    assert keep.all() == (capacity_factor == 40.0)


def test_top_k_orders_ties_as_jax_does():
    """``jax.lax.top_k`` puts the lower index first among equal values;
    ``torch.topk`` does not promise that."""
    rng = np.random.default_rng(3)
    rows = np.concatenate([
        np.zeros((1, 40), np.float32),
        rng.integers(-2, 3, size=(64, 40)).astype(np.float32),
        rng.normal(size=(8, 40)).astype(np.float32)])
    for k in (1, 2, 8, 40):
        jv, ji = jax.lax.top_k(jnp.asarray(rows), k)
        tv, ti = L.top_k(torch.from_numpy(rows), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    _, ti = L.top_k(torch.zeros(40), 8)
    assert ti.tolist() == list(range(8))


@pytest.mark.parametrize("router", ["zeros", "duplicated_columns"])
def test_moe_with_tied_router_logits_matches_jax(router):
    """Tied router logits: all zeros (every token picks experts 0..k-1,
    so the capacity drops most of them), and small integers with
    duplicated expert columns (exact, order-free sums: ties between
    distinct experts at nonzero values).  The order of the k experts
    sets the slot ranking, so the kept set shows the tie order."""
    cfg = _cfg("granite-moe-3b-a800m", num_experts=40, top_k=8)
    jp, _ = _params(cfg, 4)
    e, d = cfg.moe.num_experts, cfg.d_model
    rng = np.random.default_rng(4)
    if router == "zeros":
        w = np.zeros((d, e), np.float32)
        x = _x(cfg, 4)
    else:
        w = rng.integers(-1, 2, size=(d, e)).astype(np.float32)
        w[:, 1::2] = w[:, 0::2]          # experts 2i and 2i+1 always tie
        x = rng.integers(-2, 3, size=(2, 32, d)).astype(np.float32)
    jp = dict(jp, router=jnp.asarray(w))
    tp = convert.lm_params(jax.tree.map(np.asarray, jp))
    keep = _check(cfg, jp, tp, x, 1.25)
    assert not keep.all()
