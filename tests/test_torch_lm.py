"""The LM stack (configs, layers, model composition): the port against JAX.

The same parameters go through both packages: ``repro``'s ``init_params``
draws them, ``jax.tree.map(np.asarray, ...)`` hands them over as NumPy,
and ``repro_torch.convert.lm_params`` carries them across bit for bit.
Every arch of ``ARCHS`` runs reduced, in float32 on the CPU; the two
frameworks sum in different orders, so logits and caches agree within
``atol=1e-4``.  Decode against the full forward is held within 2e-2, as
``tests/test_arch_smoke.py`` holds JAX, on the no-drop MoE config
(``_nodrop``) as it does: a forward over more tokens has a larger
capacity, so at the default factor it is not the same function.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import frontends as JF
from repro.models import layers as JL
from repro.models import lm as JM
from repro.models import ssm as JS
from repro_torch import convert
from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.models import frontends as F
from repro_torch.models import layers as L
from repro_torch.models import lm as M
from repro_torch.models import ssm as S

from _torch_config_util import assert_same_fields

DENSE = ["minitron-8b", "nemotron-4-340b", "qwen2.5-32b", "gemma2-27b"]
# MoE, RWKV, the hybrid, the encoder-decoder and the vision backbone
OTHERS = ["mixtral-8x7b", "granite-moe-3b-a800m", "rwkv6-3b",
          "jamba-v0.1-52b", "whisper-base", "llava-next-34b"]
ATOL = 1e-4
# jamba stacks 16 blocks whose residual stream reaches ~40 (f32 ulp
# 3.8e-6); each block agrees within 1e-5 on identical inputs, and the
# rounding gathered over them reached 1.0002e-4 on logits of 8.7 (seed
# 0): its logits are held within 1e-4 + 1e-5 |logit|
RTOL = {"jamba-v0.1-52b": 1e-5}


def _leaves(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _nodrop(cfg):
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.num_experts)))
    return cfg


def _setup(arch: str, seed: int = 0, nodrop: bool = False):
    cfg = jget_config(arch).reduced()
    if nodrop:
        cfg = _nodrop(cfg)
    jp = JM.init_params(cfg, jax.random.PRNGKey(seed))
    tp = convert.lm_params(jax.tree.map(np.asarray, jp))
    return cfg, jp, tp


def _tokens(cfg, b: int, s: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, s)).astype(np.int32)


def _batches(cfg, toks: np.ndarray, seed: int = 0, embeds=None):
    """The same batch for JAX and the port: ``tokens``, or ``embeds``
    (given, or normal * 0.02 for the vision stub), plus 20 frames of
    ``enc_embeds`` for the encoder-decoder."""
    rng = np.random.default_rng(seed + 100)
    b, s = toks.shape
    batch = {"tokens": toks}
    if embeds is None and cfg.frontend == "vision_stub":
        embeds = (rng.normal(size=(b, s, cfg.d_model)) * 0.02
                  ).astype(np.float32)
    if embeds is not None:
        batch = {"embeds": embeds}
    if cfg.enc_dec:
        batch["enc_embeds"] = (rng.normal(size=(b, 20, cfg.d_model)) * 0.02
                               ).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def _close(got: torch.Tensor, want, arch: str, **kw):
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=RTOL.get(arch, 0), atol=ATOL, **kw)


def test_configs_equal_the_reference_field_for_field():
    from repro.configs import ARCHS as JARCHS
    from repro.configs import cells as jcells
    from repro_torch.configs import cells

    assert sorted(ARCHS) == sorted(JARCHS)
    for arch in ARCHS:
        assert_same_fields(get_config(arch), jget_config(arch))
        assert_same_fields(get_config(arch).reduced(),
                           jget_config(arch).reduced())
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


@pytest.mark.parametrize("arch", OTHERS)
def test_lm_params_of_every_block_kind_cross_bit_for_bit(arch):
    """bf16 trees of the MoE, RWKV, mamba, cross-attention and encoder
    blocks, with the float32 leaves the reference keeps (the MoE router,
    mamba's ``A_log`` and ``D``): every leaf's dtype and bits."""
    cfg = dataclasses.replace(jget_config(arch).reduced(),
                              param_dtype="bfloat16")
    np_tree = jax.tree.map(np.asarray, JM.init_params(cfg,
                                                      jax.random.PRNGKey(3)))
    want, got = dict(_leaves(np_tree)), dict(_leaves(convert.lm_params(
        np_tree)))
    assert sorted(got) == sorted(want)
    f32 = {n for n, a in want.items() if a.dtype == np.float32}
    assert f32 == {n for n in want if n.split("/")[-1] in
                   ("router", "A_log", "D")}
    for name, arr in want.items():
        t = got[name]
        assert tuple(t.shape) == arr.shape, name
        if name in f32:
            assert t.dtype == torch.float32, name
            np.testing.assert_array_equal(t.numpy().view(np.int32),
                                          arr.view(np.int32), name)
        else:
            assert t.dtype == torch.bfloat16, name
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          arr.view(np.int16), name)


@pytest.mark.parametrize("arch", DENSE + OTHERS)
def test_init_params_follows_the_reference_scheme(arch):
    """Same tree, shapes and dtypes as the reference; ones and zeros where
    it has them, and its other constants (a leaf the reference draws the
    same under two keys: RWKV's ``mu``, mamba's ``A_log``, ...) within
    float32 rounding; normal draws at its scales (std within 15 %, or 4
    standard errors of the ratio, sqrt(1/n), for a leaf of n < 711)."""
    cfg = get_config(arch).reduced()
    gen = torch.Generator().manual_seed(0)
    tp = dict(_leaves(M.init_params(cfg, gen, device="cpu")))
    jcfg = jget_config(arch).reduced()
    jp = dict(_leaves(JM.init_params(jcfg, jax.random.PRNGKey(0))))
    jp2 = dict(_leaves(JM.init_params(jcfg, jax.random.PRNGKey(1))))
    assert sorted(tp) == sorted(jp)
    for name, j in jp.items():
        t = tp[name]
        assert tuple(t.shape) == j.shape and t.dtype == torch.float32, name
        j = np.asarray(j)
        if name.endswith("scale"):
            assert torch.equal(t, torch.ones_like(t)), name
        elif name.split("/")[-1] in ("bq", "bk", "bv"):
            assert torch.equal(t, torch.zeros_like(t)), name
        elif np.array_equal(j, np.asarray(jp2[name])):
            np.testing.assert_allclose(t.numpy(), j, rtol=1e-6, atol=0,
                                       err_msg=name)
        else:
            ratio = float(t.std()) / float(j.std())
            tol = max(0.15, 4 / math.sqrt(j.size))
            assert abs(ratio - 1) < tol, (name, ratio)


@pytest.mark.parametrize("arch", DENSE + OTHERS)
def test_forward_logits_matches_jax(arch):
    """At the default capacity factor: MoE layers drop what the
    reference drops."""
    cfg, jp, tp = _setup(arch)
    jb, tb = _batches(cfg, _tokens(cfg, 2, 24))
    want = np.asarray(JM.forward_logits(cfg, jp, jb))
    got = M.forward_logits(cfg, tp, tb)
    assert got.dtype == torch.float32
    assert got.shape == (2, 24, L.padded_vocab(cfg))
    _close(got, want, arch)


@pytest.mark.parametrize("arch", DENSE + OTHERS)
def test_prefill_cache_and_decode_match_jax(arch):
    """Prompts longer than gemma's reduced window (16), so the rolling
    cache and its ``kpos`` are exercised; three decode steps each, which
    carry mamba's and RWKV's states on.  whisper decodes against the
    cross K/V of its encoded frames; llava prefills from ``embeds``, the
    embedding rows of its prompt, so its decode continues the forward
    over the tokens."""
    cfg, jp, tp = _setup(arch, seed=1, nodrop=True)
    s = 24
    toks = _tokens(cfg, 2, s + 2, seed=1)
    embeds = None
    if cfg.frontend == "vision_stub":
        embeds = np.asarray(jp["embed"]["tok"])[toks[:, :s - 1]]
    jb, tb = _batches(cfg, toks[:, :s - 1], seed=1, embeds=embeds)
    jl, jc = JM.prefill(cfg, jp, jb, max_len=s + 4)
    tl, tc = M.prefill(cfg, tp, tb, max_len=s + 4)
    _close(tl, jl, arch)
    want, got = dict(_leaves(jc)), dict(_leaves(tc))
    assert sorted(got) == sorted(want)
    for name, j in want.items():
        assert tuple(got[name].shape) == j.shape, name
        assert got[name].dtype == convert.array_to_torch(
            np.asarray(j)).dtype, name
        if name.endswith("kpos"):
            np.testing.assert_array_equal(got[name].numpy(), np.asarray(j))
        else:
            np.testing.assert_allclose(got[name].numpy(), np.asarray(j),
                                       rtol=0, atol=ATOL, err_msg=name)
    jcross = tcross = None
    full_batch = {"tokens": torch.from_numpy(toks)}
    if cfg.enc_dec:
        jcross = JM._cross_kv(cfg, jp, JM._encode(cfg, jp,
                                                  jb["enc_embeds"]))
        tcross = M._cross_kv(cfg, tp, M._encode(cfg, tp, tb["enc_embeds"]))
        for name in ("k", "v"):
            _close(tcross[name], jcross[name], arch)
        full_batch["enc_embeds"] = tb["enc_embeds"]
    full = M.forward_logits(cfg, tp, full_batch)
    for pos in range(s - 1, s + 2):
        step = toks[:, pos:pos + 1]
        jl, jc = JM.decode_step(cfg, jp, jc, jnp.asarray(step),
                                jnp.int32(pos), cross=jcross)
        tl, tc = M.decode_step(cfg, tp, tc, torch.from_numpy(step), pos,
                               cross=tcross)
        assert tl.shape == (2, 1, L.padded_vocab(cfg))
        _close(tl, jl, arch)
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


def test_bf16_forward_of_rwkv_casts_where_jax_casts():
    """bf16 forward of reduced rwkv6-3b: within 4 bf16 ulps of the
    largest logit (0.25 at 8.8; measured on the CPU: 0.234, mean 0.031).
    A float32 step kept in bf16 shows here: with ``models/ssm.py``
    changed to take the decay ``exp(-exp(dec))`` in bf16 the gap was
    0.609, the group norm in bf16 1.156, the scan state in bf16 0.391."""
    cfg = _bf16_cfg("rwkv6-3b")
    jp = JM.init_params(cfg, jax.random.PRNGKey(5))
    tp = convert.lm_params(jax.tree.map(np.asarray, jp))
    toks = _tokens(cfg, 2, 12, seed=5)
    want = np.asarray(JM.forward_logits(cfg, jp, {"tokens": jnp.asarray(toks)}))
    got = M.forward_logits(cfg, tp, {"tokens": torch.from_numpy(toks)})
    top = float(np.abs(want).max())
    ulp = 2.0 ** (math.floor(math.log2(top)) - 7)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=4 * ulp)


def _bf16_ulp(x: np.ndarray) -> float:
    return 2.0 ** (math.floor(math.log2(float(np.abs(x).max()))) - 7)


def test_bf16_jamba_blocks_cast_where_jax_casts():
    """bf16 reduced jamba, block by block on identical inputs (the
    reference's own activations): each block's mixer (mamba or
    attention) and its MLP or MoE within 4 bf16 ulps of its largest
    value (measured on the CPU: 3.0), in bf16.  The whole model is not
    compared: from its eighth block on, bf16 rounding moves the router
    logits by up to 0.23 and JAX's and the port's top-2 part on tokens
    whose second and third logits lie 0.10-0.15 apart, after which the
    logits differ by up to 3.2."""
    cfg = _nodrop(_bf16_cfg("jamba-v0.1-52b"))
    jp = JM.init_params(cfg, jax.random.PRNGKey(5))
    tp = convert.lm_params(jax.tree.map(np.asarray, jp))
    toks = _tokens(cfg, 2, 12, seed=5)
    jx = JL.embed(cfg, jp["embed"], jnp.asarray(toks))
    pos, tpos = jnp.arange(12), torch.arange(12)

    def t(a):
        return convert.array_to_torch(np.asarray(a))

    for i in range(cfg.num_periods):
        for j, kind in enumerate(cfg.block_pattern):
            bj = jax.tree.map(lambda a: a[i], jp["periods"][f"block{j}"])
            bt = M._period(tp["periods"], i)[f"block{j}"]
            h = JL.rmsnorm(bj["norm1"], jx, cfg.norm_eps)
            if kind == "mamba":
                yj = JS.mamba_block(cfg, bj["mamba"], h)[0]
                yt = S.mamba_block(cfg, bt["mamba"], t(h))[0]
            else:
                yj = JL.attention(cfg, bj["attn"], h, pos)
                yt = L.attention(cfg, bt["attn"], t(h), tpos)
            h2 = JL.rmsnorm(bj["norm2"], jx + yj, cfg.norm_eps)
            if "moe" in bj:
                fj, ft = JL.moe(cfg, bj["moe"], h2), L.moe(cfg, bt["moe"],
                                                           t(h2))
            else:
                fj, ft = JL.mlp(cfg, bj["mlp"], h2), L.mlp(cfg, bt["mlp"],
                                                           t(h2))
            for want, got in ((yj, yt), (fj, ft)):
                want = np.asarray(want, np.float32)
                assert got.dtype == torch.bfloat16
                np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                           atol=4 * _bf16_ulp(want),
                                           err_msg=f"{i}.{j} {kind}")
            jx = jx + yj + fj


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_frontend_batch_shapes_equal_the_reference(arch):
    for shape in SHAPES.values():
        assert F.batch_shapes(get_config(arch), shape) == \
            JF.batch_shapes(jget_config(arch), shape)


def test_synthetic_embeds_draw_the_reference_distribution():
    cfg = get_config("whisper-base")
    x = F.synthetic_embeds(cfg, 2, 1500, torch.Generator().manual_seed(0),
                           device="cpu")
    assert x.shape == (2, 1500, cfg.d_model) and x.dtype == torch.bfloat16
    assert abs(float(x.float().std()) / 0.02 - 1) < 0.01
    assert abs(float(x.float().mean())) < 1e-4
