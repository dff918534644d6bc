"""The reference's "opt" variant on the port: its four model knobs
(``attn_q_chunk``, ``attn_shard_heads``, ``sp_decode``,
``moe_dp_sharding``) against the reference, on all ten reduced archs.

Configs are ``apply_variant(config, "opt", shape)`` of the two shapes
whose variants differ (``train_4k``; ``long_500k``, which adds
``sp_decode``, read by decode alone, so its forward and gradients are
``train_4k``'s), reduced, with ``attn_q_chunk`` lowered from 2048 to 16:
at 2048 a test-sized sequence is one block.  At 16, prompts of 39-48
tokens take three blocks, a ragged last one among them, and with the
reduced window of 16 gemma2's local blocks start their keys past 0
(``k_lo > 0``).  rwkv6-3b runs 128 tokens, so its ``rwkv_chunk=64``
takes the chunked form.  The same parameters go through both packages
in float32 on the CPU (the reference's functions under ``jax.jit``, as
``test_torch_train_step.py`` runs them); the frameworks sum in other
orders, so logits,
caches and the loss agree within ``ATOL`` = 1e-4, and each gradient
leaf within 1e-4 of its largest magnitude (``test_torch_train.py``
holds the plain configs' within 5e-5).  ``sp_flash_decode`` is held
directly against the reference's scan within 1e-6: the port folds a
group of blocks at once, which rounds otherwise in float32.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train_util import (  # noqa: F401 (a fixture)
    flat_np, loss_batch, one_torch_thread, setup, to_jax, to_torch)
from repro.dist import sp_decode as JSP
from repro.models import lm as JM
from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.dist import sp_decode as SP
from repro_torch.launch.dryrun import apply_variant
from repro_torch.models import lm as M
from repro_torch.train.train_step import value_and_grad

ATOL = 1e-4
GRAD_RTOL = 1e-4
CHUNK = 16
KNOBS = ("moe_dp_sharding", "attn_q_chunk", "attn_shard_heads",
         "attn_scores_bf16", "sp_decode", "rwkv_chunk")
VARIANTS = [(arch, shape) for arch in sorted(ARCHS)
            for shape in ("train_4k", "long_500k")]


def _opt_knobs(arch: str, shape: str, chunk: int | None = CHUNK) -> dict:
    """The knobs ``apply_variant`` sets, with ``attn_q_chunk`` lowered."""
    opt = apply_variant(get_config(arch), "opt", SHAPES[shape])
    return {**{k: getattr(opt, k) for k in KNOBS}, "attn_q_chunk": chunk}


def _seq(cfg) -> int:
    return 128 if "rwkv" in cfg.block_pattern else 48


def _close(got: torch.Tensor, want, what: str = ""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=ATOL, err_msg=what)


def _batch(cfg, jp, toks: np.ndarray, seed: int = 0) -> dict:
    """NumPy inputs for both packages: tokens, or (llava) the embedding
    rows of the tokens, plus 20 encoder frames for whisper."""
    batch = {"tokens": toks}
    if cfg.frontend == "vision_stub":
        batch = {"embeds": np.asarray(jp["embed"]["tok"])[toks]}
    if cfg.enc_dec:
        batch["enc_embeds"] = (np.random.default_rng(seed).normal(
            size=(toks.shape[0], 20, cfg.d_model)) * 0.02).astype(np.float32)
    return batch


def _forward_and_gradients(cfg, jp, tp):
    """Logits at ``attn_q_chunk`` and at 2048 (one block), then the loss
    and every gradient leaf."""
    s = _seq(cfg)
    for chunk in (cfg.attn_q_chunk, 2048):
        c = dataclasses.replace(cfg, attn_q_chunk=chunk)
        toks = np.random.default_rng(1).integers(0, c.vocab, (2, s))
        b = _batch(c, jp, toks.astype(np.int32))
        want = jax.jit(functools.partial(JM.forward_logits, c))(jp, to_jax(b))
        _close(M.forward_logits(c, tp, to_torch(b)), want, f"chunk {chunk}")
    batch = loss_batch(cfg, s=s)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, b: JM.forward_loss(cfg, p, b)))(jp, to_jax(batch))
    tl, tg = value_and_grad(cfg, tp, to_torch(batch))
    np.testing.assert_allclose(float(tl), float(jl), rtol=0, atol=ATOL)
    want = flat_np(jg)
    for (k, w), g in zip(want.items(), tg):
        got = np.zeros_like(w) if g is None else g.numpy()
        np.testing.assert_allclose(
            got, w, rtol=0, atol=GRAD_RTOL * float(np.abs(w).max()) + 1e-30,
            err_msg=k)


def _prefill_and_decode(cfg, jp, tp, steps: int = 3):
    """A prompt of 39 tokens (blocks of 16, 16 and 7; rwkv: 128), then
    ``steps`` decode steps; logits and every cache leaf each step."""
    s = 128 if "rwkv" in cfg.block_pattern else 39
    toks = np.random.default_rng(2).integers(
        0, cfg.vocab, (2, s + steps)).astype(np.int32)
    b = _batch(cfg, jp, toks[:, :s], seed=2)
    jl, jc = jax.jit(functools.partial(JM.prefill, cfg,
                                       max_len=s + steps + 2))(jp, to_jax(b))
    jdecode = jax.jit(functools.partial(JM.decode_step, cfg))
    tl, tc = M.prefill(cfg, tp, to_torch(b), max_len=s + steps + 2)
    _close(tl, jl, "prefill")
    jcross = tcross = None
    if cfg.enc_dec:
        jcross = JM._cross_kv(cfg, jp, JM._encode(
            cfg, jp, jnp.asarray(b["enc_embeds"])))
        tcross = M._cross_kv(cfg, tp, M._encode(
            cfg, tp, torch.from_numpy(b["enc_embeds"])))
    for pos in range(s, s + steps):
        step = toks[:, pos:pos + 1]
        jl, jc = jdecode(jp, jc, jnp.asarray(step), jnp.int32(pos),
                         cross=jcross)
        tl, tc = M.decode_step(cfg, tp, tc, torch.from_numpy(step), pos,
                               cross=tcross)
        _close(tl, jl, f"decode at {pos}")
        want = flat_np(jc)
        for k, v in flat_np(tc).items():
            if k.endswith("kpos"):
                np.testing.assert_array_equal(v, want[k], err_msg=k)
            else:
                _close(torch.from_numpy(v), want[k], f"{k} at {pos}")


def test_the_long_context_variant_differs_in_sp_decode_alone():
    for arch in ARCHS:
        train, long = (_opt_knobs(arch, s) for s in ("train_4k",
                                                     "long_500k"))
        assert {k for k in KNOBS if train[k] != long[k]} == {"sp_decode"}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_opt_variant_forward_and_loss_gradients_match_the_reference(arch):
    _forward_and_gradients(*setup(arch, **_opt_knobs(arch, "train_4k")))


@pytest.mark.parametrize("arch,shape", VARIANTS)
def test_opt_variant_prefill_and_decode_match_the_reference(arch, shape):
    """Under ``long_500k`` the full-attention blocks (gemma2's global
    ones among them) decode through ``sp_flash_decode``."""
    _prefill_and_decode(*setup(arch, **_opt_knobs(arch, shape)))


@pytest.mark.parametrize("knob,value,arch", [
    ("attn_q_chunk", CHUNK, "gemma2-27b"),
    ("attn_shard_heads", True, "qwen2.5-32b"),
    ("sp_decode", True, "gemma2-27b"),
    ("moe_dp_sharding", True, "granite-moe-3b-a800m")])
def test_each_knob_alone_matches_the_reference(knob, value, arch):
    cfg, jp, tp = setup(arch, **{knob: value})
    _forward_and_gradients(cfg, jp, tp)
    _prefill_and_decode(cfg, jp, tp, steps=2)


@pytest.mark.parametrize("s_max,pos,softcap", [(1300, 1299, None),
                                               (1300, 700, 50.0),
                                               (300, 123, None),
                                               (2048, 2047, 30.0)])
def test_sp_flash_decode_matches_the_reference_scan(s_max, pos, softcap):
    """Caches of 1,300 positions (padded to 3 blocks of 512), 300 (one
    block of 300) and 2,048 (4 whole blocks); the row at ``pos``
    written, the positions past it masked; GQA with 3 query heads a KV
    head; with and without a softcap."""
    cfg = dataclasses.replace(get_config("gemma2-27b").reduced(),
                              n_heads=6, n_kv_heads=2, attn_softcap=softcap)
    rng = np.random.default_rng(s_max + pos)
    b, kvd = 2, cfg.n_kv_heads * cfg.d_head
    q = rng.normal(size=(b, 1, cfg.n_heads, cfg.d_head)).astype(np.float32)
    ck, cv = (rng.normal(size=(b, s_max, kvd)).astype(np.float32)
              for _ in range(2))
    k1, v1 = (rng.normal(size=(b, 1, kvd)).astype(np.float32)
              for _ in range(2))
    jout, jk, jv = JSP.sp_flash_decode(cfg, *map(jnp.asarray,
                                                 (q, ck, cv, k1, v1)),
                                       jnp.int32(pos))
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    out, tk2, tv2 = SP.sp_flash_decode(cfg, torch.from_numpy(q), tk, tv,
                                       torch.from_numpy(k1),
                                       torch.from_numpy(v1), pos)
    assert tk2 is tk and tv2 is tv
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert out.shape == (b, 1, cfg.n_heads * cfg.d_head)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0,
                               atol=1e-6)


def test_sp_flash_decode_folds_groups_of_blocks_as_the_scan():
    """More blocks than a group (``GROUP`` = 64): 70 blocks of 512 keys,
    the folds of two groups against the reference's scan."""
    cfg = get_config("minitron-8b").reduced()
    s_max, pos = 70 * 512 - 5, 70 * 512 - 300
    assert s_max > SP.GROUP * SP._BLOCK
    rng = np.random.default_rng(0)
    kvd = cfg.n_kv_heads * cfg.d_head
    q = rng.normal(size=(1, 1, cfg.n_heads, cfg.d_head)).astype(np.float32)
    ck, cv = (rng.normal(size=(1, s_max, kvd)).astype(np.float32)
              for _ in range(2))
    k1, v1 = (rng.normal(size=(1, 1, kvd)).astype(np.float32)
              for _ in range(2))
    jout, _, _ = JSP.sp_flash_decode(cfg, *map(jnp.asarray,
                                               (q, ck, cv, k1, v1)),
                                     jnp.int32(pos))
    out, _, _ = SP.sp_flash_decode(cfg, *map(torch.from_numpy,
                                             (q, ck, cv, k1, v1)), pos)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0,
                               atol=1e-6)
