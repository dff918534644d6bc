"""LM serving: the port's ``ServeEngine`` and sampler against JAX's.

Parameters cross from ``repro``'s ``init_params`` through
``repro_torch.convert.lm_params``; the reduced archs run in float32 on
the CPU, where the sampler's ``minp_mask`` takes its plain version.

* Greedy serving (3 requests, 2 slots, as the reference's launcher runs
  it) emits the same tokens, token for token, for the dense archs and
  the MoE (at the serving capacity factor), RWKV and hybrid ones.
* Decode writes the new SSM and RWKV states into the engine's cache.
* Sampling draws from a ``torch.Generator``, so its tokens cannot equal
  JAX's: on the same decode-step logits, the threshold and the masked
  logits are bit-equal to what JAX's ``sample`` computes, every draw
  lies in the kept set, and 20,000 draws from one row follow
  ``softmax(masked)`` (chi-square, p > 1e-3, fixed seed).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

import repro_torch.kernels as K
from repro.configs import get_config as jget_config
from repro.kernels import ops as jops
from repro.models import lm as JM
from repro.serve import engine as JE
from repro_torch import convert
from repro_torch.kernels.ref import MINP_FILL
from repro_torch.launch import serve as launch_serve
from repro_torch.models import lm as M
from repro_torch.serve import engine as E

ROOT = Path(__file__).resolve().parents[1]
DENSE = ["minitron-8b", "nemotron-4-340b", "qwen2.5-32b", "gemma2-27b"]
MOE_SSM = ["granite-moe-3b-a800m", "mixtral-8x7b", "rwkv6-3b",
           "jamba-v0.1-52b"]


def _setup(arch: str):
    cfg = jget_config(arch).reduced()
    jp = JM.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, jp, convert.lm_params(jax.tree.map(np.asarray, jp))


def _requests(mod, cfg, n=3, new=6, prompt=8):
    rng = np.random.default_rng(0)
    return [mod.Request(rid=i, prompt=rng.integers(0, cfg.vocab, prompt)
                        .astype(np.int32), max_new_tokens=new)
            for i in range(n)]


def _decode_logits(arch: str) -> tuple[np.ndarray, int]:
    """A decode step's logits [2, V] from JAX, on reduced ``arch``."""
    cfg, jp, _ = _setup(arch)
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (2, 12))
    _, cache = JM.prefill(cfg, jp, {"tokens": jnp.asarray(toks[:, :-1])},
                          max_len=16)
    logits, _ = JM.decode_step(cfg, jp, cache, jnp.asarray(toks[:, -1:]),
                               jnp.int32(11))
    return np.array(logits[:, 0]), cfg.vocab


@pytest.mark.parametrize("arch", DENSE + MOE_SSM)
def test_greedy_engine_emits_the_reference_tokens(arch):
    cfg, jp, tp = _setup(arch)
    want = JE.ServeEngine(cfg, jp, num_slots=2, max_len=32,
                          sc=JE.SamplerConfig(greedy=True)
                          ).run(_requests(JE, cfg))
    got = E.ServeEngine(cfg, tp, num_slots=2, max_len=32,
                        sc=E.SamplerConfig(greedy=True), device="cpu"
                        ).run(_requests(E, cfg))
    assert [r.rid for r in got] == [r.rid for r in want]
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]


@pytest.mark.parametrize("min_p", [0.05, 0.1, 0.3])
@pytest.mark.parametrize("clutch", [True, False])
@pytest.mark.parametrize("arch", ["minitron-8b", "gemma2-27b"])
def test_threshold_and_mask_bit_equal_to_jax_sample(arch, clutch, min_p):
    """JAX's ``sample`` internals, written out as it computes them."""
    logits, _ = _decode_logits(arch)
    jl = jnp.asarray(logits) / max(1.0, 1e-6)
    jtau = jl.max(axis=-1) + jnp.log(min_p)
    if clutch:
        jmask = jops.sample_threshold_mask(jl.astype(jnp.float32),
                                           jtau.astype(jnp.float32))
    else:
        jmask = jnp.where(jl >= jtau[:, None], jl, -1e30)
    sc = E.SamplerConfig(min_p=min_p, use_clutch_mask=clutch)
    tau, masked = E.threshold_mask(torch.from_numpy(logits) / 1.0, sc)
    np.testing.assert_array_equal(tau.numpy().view(np.int32),
                                  np.asarray(jtau, np.float32).view(np.int32))
    np.testing.assert_array_equal(masked.numpy().view(np.int32),
                                  np.asarray(jmask).view(np.int32))


def test_every_draw_lies_in_the_kept_set():
    logits, _ = _decode_logits("qwen2.5-32b")
    lt = torch.from_numpy(logits)
    sc = E.SamplerConfig()
    _, masked = E.threshold_mask(lt, sc)
    kept = masked > MINP_FILL
    assert 1 <= int(kept.sum(-1).min()) and bool((~kept).any())
    gen = torch.Generator().manual_seed(0)
    for _ in range(200):
        toks = E.sample(None, lt, gen, sc)
        assert toks.dtype == torch.int32
        assert bool(kept.gather(1, toks.long()[:, None]).all())


def test_draws_follow_softmax_of_the_masked_logits():
    """20,000 Gumbel-max draws from one row against softmax(masked):
    chi-square over the kept tokens (bins of expected count < 5 merged),
    fixed generator seed, rejected at p < 1e-3."""
    logits, _ = _decode_logits("minitron-8b")
    _, masked = E.threshold_mask(torch.from_numpy(logits), E.SamplerConfig())
    row = masked[0]
    n = 20_000
    gen = torch.Generator().manual_seed(1234)
    draws = E.gumbel_max(row.expand(n, -1), gen)
    counts = np.bincount(draws.numpy(), minlength=row.shape[0])
    p = torch.softmax(row.double(), -1).numpy()
    kept = (row > MINP_FILL).numpy()
    assert counts[~kept].sum() == 0
    exp, obs = p[kept] * n, counts[kept]
    order = np.argsort(exp)
    exp, obs = exp[order], obs[order]
    small = exp < 5
    if small.any():
        exp = np.concatenate([[exp[small].sum()], exp[~small]])
        obs = np.concatenate([[obs[small].sum()], obs[~small]])
    assert len(exp) >= 5
    _, pval = stats.chisquare(obs, exp * obs.sum() / exp.sum())
    assert pval > 1e-3, pval


def test_sampling_engine_on_cpu_runs_the_plain_mask_and_counts_nothing():
    cfg, _, tp = _setup("gemma2-27b")
    K.reset_launch_counts()
    eng = E.ServeEngine(cfg, tp, num_slots=2, max_len=32, seed=7,
                        device="cpu")
    done = eng.run(_requests(E, cfg, n=3, new=5))
    assert sorted(r.rid for r in done) == [0, 1, 2]
    for r in done:
        assert len(r.out_tokens) == 5
        assert all(0 <= t < cfg.vocab for t in r.out_tokens)
    assert K.minp_mask.launches == 0
    # the same seed draws the same tokens
    again = E.ServeEngine(cfg, tp, num_slots=2, max_len=32, seed=7,
                          device="cpu").run(_requests(E, cfg, n=3, new=5))
    assert [r.out_tokens for r in again] == [r.out_tokens for r in done]


def test_engine_updates_the_cache_in_place_like_the_reference():
    """After serving, the port's cache equals the reference's, which is
    rebuilt functionally at every step (greedy, so both take the same
    tokens)."""
    cfg, jp, tp = _setup("gemma2-27b")
    je = JE.ServeEngine(cfg, jp, num_slots=2, max_len=32,
                        sc=JE.SamplerConfig(greedy=True))
    te = E.ServeEngine(cfg, tp, num_slots=2, max_len=32,
                       sc=E.SamplerConfig(greedy=True), device="cpu")
    je.run(_requests(JE, cfg, n=3, new=4))
    te.run(_requests(E, cfg, n=3, new=4))
    want = jax.tree.map(np.asarray, je.cache)
    for blk, leaves in want.items():
        for name, arr in leaves.items():
            got = te.cache[blk][name].numpy()
            if name == "kpos":
                np.testing.assert_array_equal(got, arr)
            else:
                np.testing.assert_allclose(got, arr, rtol=0, atol=1e-4)


@pytest.mark.parametrize("arch", ["rwkv6-3b", "jamba-v0.1-52b"])
def test_decode_updates_ssm_and_rwkv_states_in_place(arch):
    """The engine keeps the cache dict that ``decode_step`` returns, so
    the step must write its new recurrent states into that dict's
    tensors.  One step on a prefilled cache: the same dict and storage
    come back, holding the reference's new states; then the engine's
    cache after serving equals the reference's.  The RWKV state sums
    k^T v over every token and grows to ~64 (f32 ulp 7.6e-6), so leaves
    are held within 1e-4 + 1e-5 |value|."""
    cfg, jp, tp = _setup(arch)
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (2, 9))
    _, jc = JM.prefill(cfg, jp, {"tokens": jnp.asarray(toks[:, :-1])},
                       max_len=16)
    _, tc = M.prefill(cfg, tp, {"tokens": torch.from_numpy(toks[:, :-1])},
                      max_len=16)
    before = {(b, n): (t.data_ptr(), t.clone())
              for b, leaves in tc.items() for n, t in leaves.items()}
    _, jc = JM.decode_step(cfg, jp, jc, jnp.asarray(toks[:, -1:]),
                           jnp.int32(8))
    _, out = M.decode_step(cfg, tp, tc, torch.from_numpy(toks[:, -1:]), 8)
    assert out is tc
    states = [k for k in before if k[1] in ("ssm", "conv", "state", "x_tm",
                                            "x_cm")]
    assert states
    for (blk, name), (ptr, old) in before.items():
        t = tc[blk][name]
        assert t.data_ptr() == ptr, (blk, name)
        if (blk, name) in states:
            assert not torch.equal(t, old), (blk, name)
        np.testing.assert_allclose(t.numpy(), np.asarray(jc[blk][name]),
                                   rtol=1e-5, atol=1e-4,
                                   err_msg=f"{blk}/{name}")
    je = JE.ServeEngine(cfg, jp, num_slots=2, max_len=32,
                        sc=JE.SamplerConfig(greedy=True))
    te = E.ServeEngine(cfg, tp, num_slots=2, max_len=32,
                       sc=E.SamplerConfig(greedy=True), device="cpu")
    je.run(_requests(JE, cfg, n=3, new=4))
    te.run(_requests(E, cfg, n=3, new=4))
    for blk, leaves in jax.tree.map(np.asarray, je.cache).items():
        for name, arr in leaves.items():
            np.testing.assert_allclose(te.cache[blk][name].numpy(), arr,
                                       rtol=1e-5, atol=1e-4,
                                       err_msg=f"{blk}/{name}")


def test_launcher_prints_the_reference_keys_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "minitron-8b", "--reduced", "--device", "cpu", "--requests", "3",
         "--max-new", "4"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    text = out.stdout[:out.stdout.index("}") + 1]
    report = json.loads(text)
    assert set(report) == {"requests", "generated_tokens", "seconds",
                           "tok_per_s", "sampler"}
    assert report["requests"] == 3 and report["generated_tokens"] == 12
    assert report["sampler"] == "clutch-minp"


def test_serving_entry_points_raise_without_cuda_unless_cpu_is_asked(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = jget_config("minitron-8b").reduced()
    params = M.init_params(cfg, torch.Generator(), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        E.ServeEngine(cfg, params, num_slots=2, max_len=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_serve.main(["--arch", "minitron-8b", "--reduced"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        M.init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        M.init_cache(cfg, 2, 16)
    assert E.ServeEngine(cfg, params, num_slots=2, max_len=16,
                         device="cpu").device.type == "cpu"
