"""The LM stack (configs, layers, model composition): the port against JAX.

The same parameters go through both packages: ``repro``'s ``init_params``
draws them, ``jax.tree.map(np.asarray, ...)`` hands them over as NumPy,
and ``repro_torch.convert.lm_params`` carries them across bit for bit.
The reduced dense archs run in float32 on the CPU; the two frameworks sum
in different orders, so logits and caches agree within ``atol=1e-4``.
Decode against the full forward is held within 2e-2, as
``tests/test_arch_smoke.py`` holds JAX.
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
from repro.models import lm as JM
from repro_torch import convert
from repro_torch.configs import ARCHS, get_config
from repro_torch.models import layers as L
from repro_torch.models import lm as M

DENSE = ["minitron-8b", "nemotron-4-340b", "qwen2.5-32b", "gemma2-27b"]
NOT_PORTED = ["mixtral-8x7b", "granite-moe-3b-a800m", "rwkv6-3b",
              "jamba-v0.1-52b", "whisper-base", "llava-next-34b"]
ATOL = 1e-4


def _leaves(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _setup(arch: str, seed: int = 0):
    cfg = jget_config(arch).reduced()
    jp = JM.init_params(cfg, jax.random.PRNGKey(seed))
    tp = convert.lm_params(jax.tree.map(np.asarray, jp))
    return cfg, jp, tp


def _tokens(cfg, b: int, s: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, s)).astype(np.int32)


def test_configs_equal_the_reference_field_for_field():
    from repro.configs import ARCHS as JARCHS
    from repro.configs import cells as jcells
    from repro_torch.configs import cells

    assert sorted(ARCHS) == sorted(JARCHS)
    for arch in ARCHS:
        assert dataclasses.asdict(get_config(arch)) == \
            dataclasses.asdict(jget_config(arch))
        assert dataclasses.asdict(get_config(arch).reduced()) == \
            dataclasses.asdict(jget_config(arch).reduced())
    assert cells() == jcells()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_params_cross_bit_for_bit(dtype):
    cfg = dataclasses.replace(jget_config("minitron-8b").reduced(),
                              param_dtype=dtype, compute_dtype=dtype)
    np_tree = jax.tree.map(np.asarray, JM.init_params(cfg,
                                                      jax.random.PRNGKey(3)))
    tp = convert.lm_params(np_tree)
    want = dict(_leaves(np_tree))
    got = dict(_leaves(tp))
    assert sorted(got) == sorted(want)
    for name, arr in want.items():
        t = got[name]
        assert t.dtype == getattr(torch, dtype), name
        assert tuple(t.shape) == arr.shape, name
        np.testing.assert_array_equal(t.view(torch.int16).numpy()
                                      if dtype == "bfloat16"
                                      else t.numpy().view(np.int32),
                                      arr.view(np.int16)
                                      if dtype == "bfloat16"
                                      else arr.view(np.int32), name)


@pytest.mark.parametrize("arch", DENSE)
def test_init_params_follows_the_reference_scheme(arch):
    """Same tree, shapes and dtypes as the reference; ones and zeros where
    it has them; normal draws at its scales (std within 15 %)."""
    cfg = get_config(arch).reduced()
    gen = torch.Generator().manual_seed(0)
    tp = dict(_leaves(M.init_params(cfg, gen, device="cpu")))
    jp = dict(_leaves(JM.init_params(jget_config(arch).reduced(),
                                     jax.random.PRNGKey(0))))
    assert sorted(tp) == sorted(jp)
    for name, j in jp.items():
        t = tp[name]
        assert tuple(t.shape) == j.shape and t.dtype == torch.float32, name
        j = np.asarray(j)
        if name.endswith("scale"):
            assert torch.equal(t, torch.ones_like(t)), name
        elif name.split("/")[-1] in ("bq", "bk", "bv"):
            assert torch.equal(t, torch.zeros_like(t)), name
        else:
            ratio = float(t.std()) / float(j.std())
            assert 0.85 < ratio < 1.15, (name, ratio)


@pytest.mark.parametrize("arch", DENSE)
def test_forward_logits_matches_jax(arch):
    cfg, jp, tp = _setup(arch)
    toks = _tokens(cfg, 2, 24)
    want = np.asarray(JM.forward_logits(cfg, jp, {"tokens": jnp.asarray(toks)}))
    got = M.forward_logits(cfg, tp, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.float32
    assert got.shape == (2, 24, L.padded_vocab(cfg))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_cache_and_decode_match_jax(arch):
    """Prompts longer than gemma's reduced window (16), so the rolling
    cache and its ``kpos`` are exercised; three decode steps each."""
    cfg, jp, tp = _setup(arch, seed=1)
    s = 24
    toks = _tokens(cfg, 2, s + 2, seed=1)
    jl, jc = JM.prefill(cfg, jp, {"tokens": jnp.asarray(toks[:, :s - 1])},
                        max_len=s + 4)
    tl, tc = M.prefill(cfg, tp, {"tokens": torch.from_numpy(toks[:, :s - 1])},
                       max_len=s + 4)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=ATOL)
    want, got = dict(_leaves(jc)), dict(_leaves(tc))
    assert sorted(got) == sorted(want)
    for name, j in want.items():
        assert tuple(got[name].shape) == j.shape, name
        if name.endswith("kpos"):
            np.testing.assert_array_equal(got[name].numpy(), np.asarray(j))
        else:
            np.testing.assert_allclose(got[name].numpy(), np.asarray(j),
                                       rtol=0, atol=ATOL, err_msg=name)
    full = M.forward_logits(cfg, tp, {"tokens": torch.from_numpy(toks)})
    for pos in range(s - 1, s + 2):
        step = toks[:, pos:pos + 1]
        jl, jc = JM.decode_step(cfg, jp, jc, jnp.asarray(step),
                                jnp.int32(pos))
        tl, tc = M.decode_step(cfg, tp, tc, torch.from_numpy(step), pos)
        assert tl.shape == (2, 1, L.padded_vocab(cfg))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=ATOL)
        err = float((tl[:, 0] - full[:, pos]).abs().max())
        assert err < 2e-2, (arch, pos, err)


@pytest.mark.parametrize("arch", DENSE)
def test_layers_match_jax(arch):
    """rmsnorm, RoPE, the MLP and lm_head on shared inputs."""
    cfg, jp, tp = _setup(arch, seed=2)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 5, cfg.d_model)).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    blk_j = jax.tree.map(lambda a: a[0], jp["periods"]["block0"])
    blk_t = M._period(tp["periods"], 0)["block0"]
    pairs = [
        (JL.rmsnorm(blk_j["norm1"], jx, cfg.norm_eps),
         L.rmsnorm(blk_t["norm1"], tx, cfg.norm_eps)),
        (JL.mlp(cfg, blk_j["mlp"], jx), L.mlp(cfg, blk_t["mlp"], tx)),
        (JL.lm_head(cfg, jp["embed"], jx), L.lm_head(cfg, tp["embed"], tx)),
    ]
    q = rng.normal(size=(2, 5, cfg.n_heads, cfg.d_head)).astype(np.float32)
    pos = np.array([0, 3, 7, 100, 4096], np.int32)
    pairs.append((JL.rope(jnp.asarray(q), jnp.asarray(pos), cfg.rope_theta),
                  L.rope(torch.from_numpy(q), torch.from_numpy(pos),
                         cfg.rope_theta)))
    for want, got in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL)


def test_bf16_layers_cast_where_jax_casts():
    """bf16 activations and weights: the attention and RoPE casts of the
    reference (scores in bf16 divided by sqrt(dh) before the f32 cast;
    RoPE promoted to f32 and cast back) agree within bf16 rounding."""
    cfg = dataclasses.replace(jget_config("qwen2.5-32b").reduced(),
                              param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    jp = JM.init_params(cfg, jax.random.PRNGKey(5))
    tp = convert.lm_params(jax.tree.map(np.asarray, jp))
    toks = _tokens(cfg, 2, 12, seed=5)
    want = np.asarray(JM.forward_logits(cfg, jp, {"tokens": jnp.asarray(toks)}))
    got = M.forward_logits(cfg, tp, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.float32
    # logits are bf16-rounded in lm_head (ulp 2^-5 at magnitudes 4-8)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=4 * 2.0 ** -5 * max(1.0, np.abs(want).max() / 8))


def _bf16_cfg(arch: str, **widths):
    return dataclasses.replace(jget_config(arch).reduced(),
                               param_dtype="bfloat16",
                               compute_dtype="bfloat16", **widths)


@pytest.mark.parametrize("site,width", [("scores", 128), ("scores", 96),
                                        ("embed", 72), ("embed", 4608)])
def test_bf16_scalars_round_as_jax_rounds_them(site, width):
    """JAX rounds a weakly typed Python scalar to the array's dtype before
    the op (sqrt(128) -> 11.3125, sqrt(72) -> 8.5 in bf16); the port's two
    sites do the same, so their bf16 outputs equal JAX's bit for bit.
    Widths whose square root is not a bf16 value show the difference; the
    reduced configs' 16 and 64 do not."""
    rng = np.random.default_rng(width)
    if site == "scores":
        x = rng.normal(size=100_000).astype(jnp.bfloat16)
        # the reference's expression, src/repro/models/layers.py _attend
        want = np.asarray(jnp.asarray(x) / math.sqrt(width))
        got = L.scale_scores(torch.from_numpy(x.view(np.int16))
                             .view(torch.bfloat16), width)
    else:
        cfg = _bf16_cfg("gemma2-27b", d_model=width)
        assert cfg.tie_embeddings
        tok = (rng.normal(size=(L.padded_vocab(cfg), width)) * 0.02
               ).astype(jnp.bfloat16)
        toks = _tokens(cfg, 4, 25, seed=width)
        want = np.asarray(JL.embed(cfg, {"tok": jnp.asarray(tok)},
                                   jnp.asarray(toks)))
        got = L.embed(cfg, {"tok": torch.from_numpy(tok.view(np.int16))
                            .view(torch.bfloat16)}, torch.from_numpy(toks))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16))


@pytest.mark.parametrize("seed", [5, 7])
def test_bf16_forward_logits_with_unrounded_widths(seed):
    """bf16 forward of reduced gemma2 (tied embeddings, softcaps) at
    d_head 128 and d_model 72, whose square roots JAX rounds to bf16.
    Measured on the CPU: the largest gap to JAX was 0.084 (seed 5) and
    0.106 (seed 7) with the scalars unrounded, 0.044 and 0.041 with them
    rounded; the rest is other bf16 roundings.  Tolerance 2^-4: 8 bf16
    ulps at the logits' magnitude of 1-2."""
    cfg = _bf16_cfg("gemma2-27b", d_head=128, d_model=72)
    jp = JM.init_params(cfg, jax.random.PRNGKey(seed))
    tp = convert.lm_params(jax.tree.map(np.asarray, jp))
    toks = _tokens(cfg, 2, 12, seed=seed)
    want = np.asarray(JM.forward_logits(cfg, jp, {"tokens": jnp.asarray(toks)}))
    got = M.forward_logits(cfg, tp, {"tokens": torch.from_numpy(toks)})
    assert np.abs(want).max() < 2
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2.0 ** -4)


@pytest.mark.parametrize("arch", NOT_PORTED)
def test_archs_not_ported_yet_raise_naming_the_roadmap(arch):
    cfg = get_config(arch).reduced()
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        M.init_params(cfg, torch.Generator(), device="cpu")


@pytest.mark.parametrize("knob,value", [("attn_q_chunk", 8),
                                        ("attn_shard_heads", True),
                                        ("sp_decode", True)])
def test_perf_knobs_not_ported_yet_raise(knob, value):
    cfg = dataclasses.replace(get_config("minitron-8b").reduced(),
                              **{knob: value})
    params = M.init_params(cfg, torch.Generator(), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        M.forward_logits(cfg, params, {"tokens": torch.zeros((1, 4),
                                                             dtype=torch.int64)})
