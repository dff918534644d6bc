"""AI21 Jamba2 Mini's mechanisms in the port, held against the plain
reference the benchmark judges it by (``clutchbench/reference/
lm_jamba.py``), on the CPU in float32 with seeded random weights.

The model is Jamba2 Mini cut to the port's smoke widths, two whole
periods of its layout as published: attention at in-period index 4,
Mamba-1 with dt, B and C normed elsewhere, 16 experts top-2 on the odd
indices with the softmax-then-top-k gate and no token dropped, no
positional encoding.  The port and the reference sum in different
orders (batched products, the grouped expert products).  Through 16
float32 layers each lies up to 1.9e-4 from the same forward in float64,
on logits up to 4.6 (seeds 1-3), so the engine's logits are held within
``ATOL + RTOL * max|logit|`` (5.6e-4 there, 1.5 times the two errors
together); one MoE layer's output within ``ATOL``;
the scan's plain version against a float64 loop within ``SCAN_ATOL``
(float32 rounding over 48 steps).
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from clutchbench.reference import lm_jamba as R
from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.kernels import ref
from repro_torch.kernels.common import with_plain_grad
from repro_torch.kernels.selective_scan import selective_scan
from repro_torch.models import layers as L
from repro_torch.models import lm as M
from repro_torch.serve import engine as E

ATOL = 1e-4
RTOL = 1e-4
SCAN_ATOL = 1e-5
PATTERN = ("mamba", "mamba", "mamba", "mamba", "attn", "mamba", "mamba",
           "mamba")
CFG = ModelConfig(
    name="jamba2-mini-smoke", family="hybrid", num_layers=16, d_model=64,
    n_heads=4, n_kv_heads=2, d_head=16, d_ff=128, vocab=512,
    block_pattern=PATTERN, mlp="silu_glu",
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=64,
                  moe_layers=(1, 3, 5, 7), capacity_factor=None,
                  renormalize=False),
    ssm_d_state=16, ssm_dt_bc_norm=True, rope_theta=None, norm_eps=1e-6,
    param_dtype="float32", compute_dtype="float32")


def _model(cfg: ModelConfig = CFG) -> dict:
    """The configuration as the benchmark's ``model`` object."""
    d = dataclasses.asdict(cfg)
    d["block_pattern"] = list(d["block_pattern"])
    return d


def _weights(seed: int = 0, cfg: ModelConfig = CFG) -> dict:
    """Flat float32 weights drawn by the reference's layout."""
    g = torch.Generator().manual_seed(seed)
    return {name: (torch.ones(shape) if std is None
                   else torch.randn(shape, generator=g) * std)
            for name, (shape, std) in R.layout(_model(cfg)).items()}


def _nested(flat: dict) -> dict:
    tree: dict = {}
    for name, t in flat.items():
        *path, leaf = name.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = t
    return tree


def _flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def test_the_reference_lays_the_weights_out_as_the_port():
    """The reference's names and shapes are the port's ``init_params``
    tree, leaf for leaf, so the benchmark's weights load into the
    engine as they are."""
    port = _flat(M.init_params(CFG, torch.Generator(), "meta"))
    want = R.layout(_model())
    assert sorted(port) == sorted(want)
    for name, (shape, _) in want.items():
        assert tuple(port[name].shape) == shape, name


@pytest.mark.parametrize("change", [
    {"rope_theta": 10000.0},
    {"ssm_dt_bc_norm": False},
    {"mlp": "gelu"},
    {"moe": dataclasses.replace(CFG.moe, renormalize=True)},
    {"moe": dataclasses.replace(CFG.moe, capacity_factor=1.25)},
    {"block_pattern": ("rwkv",) * 8},
])
def test_the_reference_raises_for_what_it_does_not_compute(change):
    with pytest.raises(ValueError):
        R.layout(_model(dataclasses.replace(CFG, **change)))


def test_the_engine_prefills_and_decodes_as_the_reference():
    """``ServeEngine`` (batch-1 prefills merged into 3 slots, decode
    steps of every slot through the K/V, convolution and scan-state
    cache) against the reference's full forward over prompt and drawn
    tokens, at every new token's logits."""
    flat = _weights(1)
    prompts = np.random.default_rng(2).integers(0, CFG.vocab, (3, 19))
    new = 6
    engine = E.ServeEngine(CFG, _nested(flat), 3, 32,
                           sc=E.SamplerConfig(greedy=True), device="cpu")
    got = torch.empty(3, new, CFG.vocab)
    step = 0
    drawn = E.sample

    def keep(cfg, logits, generator, sc):
        nonlocal step
        got[:, step] = logits[:, :CFG.vocab]
        step += 1
        return drawn(cfg, logits, generator, sc)

    E.sample = keep
    try:
        done = engine.run([E.Request(rid=j, prompt=p.astype(np.int32),
                                     max_new_tokens=new)
                           for j, p in enumerate(prompts)])
    finally:
        E.sample = drawn
    assert step == new
    slot = {r.rid: s for s, r in enumerate(sorted(done, key=lambda r: r.rid))}
    for r in done:
        seq = torch.tensor(list(r.prompt) + r.out_tokens[:-1])
        want = R.logits(flat, _model(), seq, start=len(r.prompt) - 1)
        tol = ATOL + RTOL * float(want.abs().max())
        assert (got[slot[r.rid]] - want).abs().max() < tol


def _skewed(flat: dict, block: str = "periods.block1.") -> dict:
    """The weights with block ``block``'s router sending every token
    whose features sum well above 0 to expert 3 first."""
    out = dict(flat)
    router = flat[block + "moe.router"].clone()
    router[:, :, 3] += 1.0
    out[block + "moe.router"] = router
    return out


def test_dropless_moe_keeps_every_token_one_expert_takes():
    """A skewed router sends all 64 tokens to one expert, 6.4 times the
    capacity (10) a GShard factor of 1.25 gives it: the dropless MoE
    computes every assignment, as the reference does, where GShard
    drops 54."""
    flat = _skewed(_weights(3))
    p = _nested(flat)["periods"]["block1"]["moe"]
    p = {k: v[0] for k, v in p.items()}
    x = torch.randn(2, 32, CFG.d_model, generator=torch.Generator(
        ).manual_seed(4)) + 2.0
    got = L.moe(CFG, p, x)
    want = R._moe(_model(), flat, "periods.block1.", 0, lambda t: t.float(),
                  x.reshape(-1, CFG.d_model)).reshape(x.shape)
    assert (got - want).abs().max() < ATOL
    gshard = dataclasses.replace(CFG, moe=dataclasses.replace(
        CFG.moe, capacity_factor=1.25))
    _, flat_e, _, keep, cap = L.moe_dispatch(gshard, p["router"],
                                            x.reshape(-1, CFG.d_model), 1.25)
    assert int((flat_e == 3).sum()) == 64 > cap
    assert not keep.all()
    assert (L.moe(gshard, p, x) - want).abs().max() > 1e-2


def test_the_gate_is_not_renormalised():
    """Jamba's gate keeps the top-2 probabilities of the softmax over all
    16 experts, which sum below 1; Mixtral's (``renormalize``) the
    softmax over the two logits."""
    g = torch.Generator().manual_seed(5)
    xf = torch.randn(40, 64, generator=g)
    router = torch.randn(64, 16, generator=g) / 8
    gates, idx = L.moe_gates(CFG, router, xf)
    probs = torch.softmax(xf @ router, -1)
    assert torch.equal(idx, probs.topk(2, -1).indices)
    assert torch.allclose(gates, probs.gather(-1, idx))
    assert (gates.sum(-1) < 1 - 1e-3).all()
    mixtral = dataclasses.replace(CFG, moe=dataclasses.replace(
        CFG.moe, renormalize=True))
    gates2, idx2 = L.moe_gates(mixtral, router, xf)
    assert torch.equal(idx2, idx)
    assert torch.allclose(gates2, gates / gates.sum(-1, keepdim=True))


def test_attention_without_rotary_sees_positions_only_through_the_mask():
    """With no positional encoding the last query's output is the same
    whatever the order of the keys before it, and whatever positions the
    rows are given; with RoPE the order shows."""
    p = {k: v[0] for k, v in _nested(_weights(6))["periods"]["block4"][
        "attn"].items()}
    x = torch.randn(1, 12, CFG.d_model, generator=torch.Generator(
        ).manual_seed(7))
    perm = torch.cat([torch.randperm(11, generator=torch.Generator(
        ).manual_seed(8)), torch.tensor([11])])
    pos = torch.arange(12)
    base = L.attention(CFG, p, x, pos)
    assert (L.attention(CFG, p, x[:, perm], pos)[:, -1]
            - base[:, -1]).abs().max() < 1e-5
    assert (L.attention(CFG, p, x, pos + 37) - base).abs().max() < 1e-6
    roped = dataclasses.replace(CFG, rope_theta=10000.0)
    assert (L.attention(roped, p, x[:, perm], pos)[:, -1]
            - L.attention(roped, p, x, pos)[:, -1]).abs().max() > 1e-3


def test_rmsnorm_of_groups_norms_each_over_its_own_width():
    """B and C normed side by side as [..., 2, N] with scales [2, N] (as
    ``mamba_block`` norms them) equal each normed alone; the norm
    with a gradient asked gives the same values as without."""
    g = torch.Generator().manual_seed(11)
    x = torch.randn(3, 5, 40, generator=g)
    s = torch.randn(2, 16, generator=g)
    bc = L.rmsnorm({"scale": s}, x[..., 8:].unflatten(-1, (2, 16)), 1e-6)
    for i in range(2):
        alone = ref.rmsnorm_ref(x[..., 8 + 16 * i:24 + 16 * i], s[i], 1e-6)
        assert torch.equal(bc[..., i, :], alone)
    w = s[0].clone().requires_grad_()
    with_grad = L.rmsnorm({"scale": w}, x[..., :16], 1e-6)
    with torch.no_grad():
        assert torch.equal(L.rmsnorm({"scale": w}, x[..., :16], 1e-6),
                           with_grad)
    assert with_grad.requires_grad


def _scan_loop(x, dt, z, b, c, a_log, d, dt_bias, h):
    """The selective scan one step at a time in float64."""
    x, dt, z, b, c, a_log, d, dt_bias = (
        t.double() for t in (x, dt, z, b, c, a_log, d, dt_bias))
    a = -torch.exp(a_log)
    delta = torch.nn.functional.softplus(dt + dt_bias)
    h = torch.zeros(x.shape[0], *a.shape, dtype=torch.float64) \
        if h is None else h.double()
    ys = []
    for t in range(x.shape[1]):
        h = torch.exp(delta[:, t, :, None] * a) * h \
            + (delta[:, t] * x[:, t])[..., None] * b[:, t, None, :]
        ys.append((h * c[:, t, None, :]).sum(-1) + d * x[:, t])
    y = torch.stack(ys, 1) * torch.nn.functional.silu(z)
    return y, h


@pytest.mark.parametrize("with_state", [False, True])
def test_selective_scan_plain_version_is_the_sequential_loop(with_state):
    """``selective_scan`` on CPU tensors (its plain version) against the
    float64 loop, from zeros and from a carried state; a scan split in
    two, the second half from the first's state, is the whole scan."""
    g = torch.Generator().manual_seed(9)
    bsz, s, din, n = 2, 48, 24, 16
    x, dt, z = (torch.randn(bsz, s, din, generator=g) for _ in range(3))
    b, c = (torch.randn(bsz, s, n, generator=g) for _ in range(2))
    a_log, d = torch.randn(din, n, generator=g), torch.randn(din, generator=g)
    dt_bias = torch.randn(din, generator=g)
    h0 = torch.randn(bsz, din, n, generator=g) if with_state else None
    args = (x, dt, z, b, c, a_log, d, dt_bias)
    y, h = selective_scan(*args, h0)
    wy, wh = _scan_loop(*args, h0)
    assert y.dtype == torch.float32 and h.dtype == torch.float32
    assert (y - wy).abs().max() < SCAN_ATOL * max(1.0, float(wy.abs().max()))
    assert (h - wh).abs().max() < SCAN_ATOL * max(1.0, float(wh.abs().max()))
    half = s // 2
    y1, h1 = selective_scan(*(t[:, :half] for t in args[:5]), *args[5:], h0)
    y2, h2 = selective_scan(*(t[:, half:] for t in args[:5]), *args[5:], h1)
    assert torch.allclose(torch.cat([y1, y2], 1), y, atol=1e-6)
    assert torch.allclose(h2, h, atol=1e-6)
    assert selective_scan.launches == 0


def test_selective_scan_is_the_reference_scan():
    """The plain version's recurrence is the benchmark reference's
    ``scan`` (one sequence, no gate): ``h . C`` equal within float32
    rounding."""
    g = torch.Generator().manual_seed(10)
    s, din, n = 300, 8, 16
    delta = torch.nn.functional.softplus(torch.randn(s, din, generator=g))
    a = -torch.exp(torch.randn(din, n, generator=g))
    x, b, c = (torch.randn(s, w, generator=g) for w in (din, n, n))
    want, wh = R.scan(delta, a, x, b, c)
    da = torch.exp(delta[None, :, :, None] * a)
    dbx = (delta * x)[None, :, :, None] * b[None, :, None, :]
    got, h = ref.mamba_scan_ref(da, dbx, c[None], None)
    assert (got[0] - want).abs().max() < 1e-5 * max(1.0, math.sqrt(s))
    assert (h[0] - wh).abs().max() < 1e-5 * max(1.0, math.sqrt(s))


def test_mamba_block_hands_the_whole_scan_to_one_call(monkeypatch):
    """Outside ``selective_scan`` (the kernel on the card), a Mamba
    mixer's prefill builds no [B, S, din, N] tensor and makes no loop
    over time: with the scan stubbed out, its operations' count is the
    same at S = 8 and S = 64, none gives an output of B * S * din * N
    elements, and the scan is called once with the whole sequence."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.models import ssm as S

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.shapes = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in out if isinstance(out, (tuple, list)) else (out,):
                if isinstance(t, torch.Tensor):
                    self.shapes.append(tuple(t.shape))
            return out

    calls = []

    def stub(x, dt, z, b, c, a_log, d, dt_bias, state=None):
        calls.append(tuple(x.shape))
        return torch.zeros_like(x), x.new_zeros(
            (x.shape[0], x.shape[2], a_log.shape[1]))

    monkeypatch.setattr(S, "selective_scan", stub)
    p = S.mamba_init(CFG, torch.Generator().manual_seed(0),
                     torch.device("cpu"))
    seen = []
    for s in (8, 64):
        x = torch.randn(2, s, CFG.d_model)
        with torch.no_grad(), Ops() as ops:
            S.mamba_block(CFG, p, x)
        seen.append(ops.shapes)
        assert calls[-1] == (2, s, CFG.d_inner_ssm)
        big = 2 * s * CFG.d_inner_ssm * CFG.ssm_d_state
        assert all(math.prod(sh) < big for sh in ops.shapes), ops.shapes
    assert len(calls) == 2 and len(seen[0]) == len(seen[1])


def _scan_case(with_state: bool):
    g = torch.Generator().manual_seed(12)
    bsz, s, din, n = 2, 6, 8, 16
    args = [torch.randn(bsz, s, din, generator=g) for _ in range(3)]
    args += [torch.randn(bsz, s, n, generator=g) for _ in range(2)]
    args += [torch.randn(din, n, generator=g), torch.randn(din, generator=g),
             torch.randn(din, generator=g)]
    args.append(torch.randn(bsz, din, n, generator=g) if with_state
                else None)
    return ref.selective_scan_ref, args


def _norm_case(_):
    g = torch.Generator().manual_seed(13)
    return ref.rmsnorm_ref, [torch.randn(3, 2, 16, generator=g),
                             torch.randn(2, 16, generator=g), 1e-6]


@pytest.mark.parametrize("case, with_state", [
    (_scan_case, False), (_scan_case, True), (_norm_case, None)])
def test_a_kernel_without_a_backward_takes_its_plain_versions_gradient(
        case, with_state):
    """``with_plain_grad``: the launch's values forward (here the plain
    version plus one, so they show which ran), and backward exactly the
    gradient of the plain version, for every input that asks for one;
    no graph where none does."""
    plain, args = case(with_state)

    def launch(*a):
        out = plain(*a)
        return tuple(t + 1 for t in out) if isinstance(out, tuple) \
            else out + 1

    with torch.no_grad():
        want = plain(*args)
    free = with_plain_grad(launch, plain, *args)
    want, free = ((want,), (free,)) if torch.is_tensor(want) else (
        want, free)
    for f, w in zip(free, want):
        assert torch.equal(f, w + 1) and f.grad_fn is None
    leaves = [a.clone().requires_grad_() if torch.is_tensor(a) else a
              for a in args]
    asked = [a for a in leaves if torch.is_tensor(a)][::2]
    for a in leaves:
        if torch.is_tensor(a) and not any(a is q for q in asked):
            a.requires_grad_(False)
    got = with_plain_grad(launch, plain, *leaves)
    mine = plain(*leaves)
    got, mine = ((got,), (mine,)) if torch.is_tensor(mine) else (got, mine)
    g = torch.Generator().manual_seed(14)
    cot = [torch.randn(t.shape, generator=g) for t in mine]
    for o, w in zip(got, mine):
        assert torch.equal(o.detach(), w.detach() + 1)
    assert all(torch.equal(a, b) for a, b in zip(
        torch.autograd.grad(got, asked, cot),
        torch.autograd.grad(mine, asked, cot)))


def test_the_mixer_and_norm_on_a_mesh_are_the_plain_path():
    """``mamba_block`` (dt, B and C normed) and ``rmsnorm`` on DTensors
    of a one-rank mesh (each rank's pieces through ``run_local``) give
    the plain tensors' values and gradients."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.models import ssm as S

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))

        def place(t):
            return DTensor.from_local(t, mesh, [Replicate()] * 2,
                                      run_check=False)

        p = S.mamba_init(CFG, torch.Generator().manual_seed(0),
                         torch.device("cpu"))
        p = {k: v.requires_grad_() for k, v in p.items()}
        x = torch.randn(2, 9, CFG.d_model,
                        generator=torch.Generator().manual_seed(1),
                        requires_grad=True)
        w = p["dt_norm"].shape[0]
        plain = S.mamba_block(CFG, p, x)[:2] + (
            L.rmsnorm({"scale": p["dt_norm"]}, x[..., :w], 1e-6),)
        dp, dx = {k: place(v) for k, v in p.items()}, place(x)
        meshed = S.mamba_block(CFG, dp, dx)[:2] + (
            L.rmsnorm({"scale": dp["dt_norm"]}, dx[..., :w], 1e-6),)
        for a, b in zip(plain, meshed):
            assert torch.equal(a, b.full_tensor())
        leaves = [x, p["in_proj"], p["A_log"], p["dt_norm"], p["c_norm"]]
        mine = torch.autograd.grad(sum(t.sum() for t in plain), leaves)
        theirs = torch.autograd.grad(
            sum(t.sum() for t in meshed),
            [dx, dp["in_proj"], dp["A_log"], dp["dt_norm"], dp["c_norm"]])
        for a, b in zip(mine, theirs):
            assert torch.allclose(a, b.full_tensor(), atol=1e-6)
    finally:
        dist.destroy_process_group()
