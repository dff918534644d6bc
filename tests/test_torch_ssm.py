"""RWKV-6 and Mamba blocks: the port's ``models/ssm.py`` against JAX's.

The reference's inits draw each block's parameters (period 0 of reduced
``rwkv6-3b`` and ``jamba-v0.1-52b``), ``repro_torch.convert.lm_params``
carries them across bit for bit, and the same NumPy-seeded inputs and
states go through both in float32.  Outputs and final states agree
within 1e-4.  The chunk-parallel RWKV form equals the port's own scan
within 1e-3, as ``tests/test_arch_smoke.py`` holds the reference's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import lm as JM
from repro.models import ssm as JS
from repro_torch import convert
from repro_torch.models import ssm as S

ATOL = 1e-4
# (sequence length, whether a state from earlier tokens is passed)
CASES = {"prompt": (24, False), "continued": (5, True), "decode": (1, True)}


def _block(arch: str, name: str, seed: int = 0, **over):
    cfg = dataclasses.replace(jget_config(arch).reduced(), **over)
    jp = JM.init_params(cfg, jax.random.PRNGKey(seed))
    jb = jax.tree.map(lambda a: np.asarray(a[0]),
                      jp["periods"]["block0"][name])
    return cfg, jax.tree.map(jnp.asarray, jb), convert.lm_params(jb)


def _normal(rng, *shape, scale=1.0) -> np.ndarray:
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _close(got, want, what):
    for g, w, name in zip(got, want, what):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("case", CASES)
def test_rwkv_time_mix_matches_jax(case):
    s, with_state = CASES[case]
    cfg, jp, tp = _block("rwkv6-3b", "rwkv")
    h, hd = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    rng = np.random.default_rng(1)
    x = _normal(rng, 2, s, cfg.d_model)
    kw_j, kw_t = {}, {}
    if with_state:
        st = _normal(rng, 2, h, hd, hd, scale=0.5)
        xl = _normal(rng, 2, cfg.d_model)
        kw_j = {"state": jnp.asarray(st), "x_last": jnp.asarray(xl)}
        kw_t = {"state": torch.from_numpy(st.copy()),
                "x_last": torch.from_numpy(xl.copy())}
    want = JS.rwkv_time_mix(cfg, jp, jnp.asarray(x), **kw_j)
    got = S.rwkv_time_mix(cfg, tp, torch.from_numpy(x), **kw_t)
    _close(got, want, ("y", "state", "x_last"))
    if with_state:     # the inputs are left as they were
        np.testing.assert_array_equal(kw_t["state"].numpy(), st)


def test_rwkv_chunked_time_mix_matches_jax_and_the_scan():
    """rwkv_chunk = 16 over 64 tokens takes the chunk-parallel form in
    both packages; the port's equals JAX's within 1e-4 and its own scan
    (rwkv_chunk unset) within 1e-3."""
    cfg, jp, tp = _block("rwkv6-3b", "rwkv", rwkv_chunk=16)
    x = _normal(np.random.default_rng(2), 2, 64, cfg.d_model)
    want = JS.rwkv_time_mix(cfg, jp, jnp.asarray(x))
    got = S.rwkv_time_mix(cfg, tp, torch.from_numpy(x))
    _close(got, want, ("y", "state", "x_last"))
    scan = S.rwkv_time_mix(dataclasses.replace(cfg, rwkv_chunk=None), tp,
                           torch.from_numpy(x))
    for a, b in zip(got[:2], scan[:2]):
        assert float((a - b).abs().max()) < 1e-3


def test_rwkv_chunked_equals_scan_on_random_decays():
    """``_rwkv_chunked`` on the inputs of ``tests/test_arch_smoke.py``'s
    check (decays 0.85-0.999): within 1e-3 of the step-by-step
    recurrence, and within 1e-4 of JAX's ``_rwkv_chunked``."""
    rng = np.random.default_rng(0)
    b, s, h, hd, chunk = 2, 96, 3, 8, 16
    rh, kh, vh = (_normal(rng, b, s, h, hd) for _ in range(3))
    wh = rng.uniform(0.85, 0.999, size=(b, s, h, hd)).astype(np.float32)
    u = _normal(rng, h, hd)
    t = [torch.from_numpy(a) for a in (rh, kh, vh, wh, u)]
    y_ch, st_ch = S._rwkv_chunked(*t, chunk)
    st = torch.zeros((b, h, hd, hd))
    ys = []
    for i in range(s):
        kv = t[1][:, i, :, :, None] * t[2][:, i, :, None, :]
        ys.append(torch.einsum("bhk,bhkv->bhv", t[0][:, i],
                               t[4][None, :, :, None] * kv + st))
        st = t[3][:, i, :, :, None] * st + kv
    assert float((torch.stack(ys, 1) - y_ch).abs().max()) < 1e-3
    assert float((st - st_ch).abs().max()) < 1e-3
    want = JS._rwkv_chunked(*(jnp.asarray(a) for a in (rh, kh, vh, wh, u)),
                            chunk)
    _close((y_ch, st_ch), want, ("y", "state"))


@pytest.mark.parametrize("with_last", [False, True])
def test_rwkv_channel_mix_matches_jax(with_last):
    cfg, jp, tp = _block("rwkv6-3b", "ffn")
    rng = np.random.default_rng(3)
    x = _normal(rng, 2, 7, cfg.d_model)
    xl = _normal(rng, 2, cfg.d_model) if with_last else None
    want = JS.rwkv_channel_mix(cfg, jp, jnp.asarray(x),
                               x_last=None if xl is None else jnp.asarray(xl))
    got = S.rwkv_channel_mix(cfg, tp, torch.from_numpy(x),
                             x_last=None if xl is None
                             else torch.from_numpy(xl))
    _close(got, want, ("y", "x_last"))


@pytest.mark.parametrize("case", CASES)
def test_mamba_block_matches_jax(case):
    s, with_state = CASES[case]
    cfg, jp, tp = _block("jamba-v0.1-52b", "mamba")
    din, n, dconv = cfg.d_inner_ssm, cfg.ssm_d_state, cfg.ssm_d_conv
    rng = np.random.default_rng(4)
    x = _normal(rng, 2, s, cfg.d_model)
    kw_j, kw_t = {}, {}
    if with_state:
        ssm = _normal(rng, 2, din, n, scale=0.1)
        conv = _normal(rng, 2, dconv - 1, din)
        kw_j = {"ssm_state": jnp.asarray(ssm), "conv_state": jnp.asarray(conv)}
        kw_t = {"ssm_state": torch.from_numpy(ssm.copy()),
                "conv_state": torch.from_numpy(conv.copy())}
    want = JS.mamba_block(cfg, jp, jnp.asarray(x), **kw_j)
    got = S.mamba_block(cfg, tp, torch.from_numpy(x), **kw_t)
    _close(got, want, ("y", "ssm_state", "conv_state"))
    if with_state:
        np.testing.assert_array_equal(kw_t["ssm_state"].numpy(), ssm)
        np.testing.assert_array_equal(kw_t["conv_state"].numpy(), conv)
