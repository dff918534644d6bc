"""The dry run on a fake production mesh of H100s: every (arch x shape)
cell's per-device layout, memory, FLOPs and collective bytes, with no
card and no allocation.

Counterpart of the reference package's ``launch/dryrun.py``, which
AOT-lowers and compiles each cell on 512 placeholder host devices.
Here one process stands for every rank: ``torch.distributed``'s fake
process group (256 ranks, 512 with ``--multi-pod``) under
:func:`repro_torch.launch.mesh.make_production_mesh`, parameters,
moments, caches and batches as DTensors of meta-device shards (shapes
only), placed by the reference's spec trees.  The step runs
op by op under :class:`repro_torch.launch.roofline.StepCounter`, which
counts each rank's local operations: FLOPs, bytes, collective result
bytes and the peak of the tensors it makes.

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch granite-moe-3b-a800m --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
        [--multi-pod | --both-meshes] [--out artifacts/dryrun_torch]

Per cell (the reference's JSON fields):
  * the full step: every period runs, so no scan trip-count correction
    is needed.  Loops over steps of one shape -- a train step's
    microbatches, a recurrence's time steps -- run their first step,
    counted as many times as the loop has steps
    (:mod:`repro_torch.models.loops`): their shapes are the same, so the
    counts are.  ``memory_analysis`` gives a device's argument and
    output bytes and the peak of the tensors the step makes
    (``temp_size_in_bytes``), ``full_step_cost`` its FLOPs and bytes,
    ``full_step_collectives`` its collective bytes by kind; ``compile_s``
    is the seconds the trace took;
  * ``components``: the reference's breakdown (``period_grad``,
    ``head_grad``, ``embed_grad``, ``opt_update``, ``enc_period_grad``;
    ``period_fwd``, ``head_fwd``; ``period_decode``, ``head_decode``),
    each counted alone under the same mesh and shardings and times its
    multiplier;
  * ``roofline``: :class:`~repro_torch.launch.roofline.RooflineTerms` of
    the full step's counts (the card's peaks), and ``model_flops`` /
    ``model_flops_ratio`` against them.

Every number is modeled: nothing runs on a card.  The one-card parts --
the "opt" variant and the parameter accounting -- are here too:

  apply_variant     -- the perf knobs of the "opt" variant
  abstract_params   -- the parameter tree on the meta device
  count_params      -- parameters of a tree
  active_params     -- the same, with an MoE's experts counted top_k of
                       num_experts
  microbatches_for  -- microbatches a train cell takes per data shard
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.dist.sharding import (
    P,
    NamedSharding,
    device_put,
    distribute,
    fit,
    is_dtensor,
    shardings,
    use_mesh,
)
from repro_torch.launch import roofline as R
from repro_torch.models import layers as L
from repro_torch.models import lm as M
from repro_torch.models import loops
from repro_torch.models.lm import init_params
from repro_torch.train import optimizer as O
from repro_torch.train import train_step as T
from repro_torch.train.tree import flatten

OPT_NOTES = {
    "moe_dp": "MoE dispatch buffer constrained to P(None, data, model)",
    "tp_serve": "serving params TP-only (no FSDP all-gathers at inference)",
    "bigmicro": "4x tokens per microbatch (fewer FSDP gather waves)",
}
#: the encoder's frames of an encoder-decoder's decode cell (whisper's
#: 30-s window), as the reference lowers it
ENC_FRAMES = 1500


# --------------------------------------------------------------------- #
# Parameter accounting
# --------------------------------------------------------------------- #

def abstract_params(cfg: ModelConfig) -> dict:
    """The parameter tree of ``cfg`` on the meta device."""
    return init_params(cfg, torch.Generator(), torch.device("meta"))


def count_params(tree) -> float:
    return float(sum(leaf.numel() for leaf in flatten(tree).values()))


def active_params(cfg: ModelConfig, tree) -> float:
    """MoE: count only top_k of num_experts expert params as active (a
    leaf whose path has a key containing ``moe`` and one containing
    ``w_in``, ``w_gate`` or ``w_out``)."""
    total = count_params(tree)
    if cfg.moe is None:
        return total
    expert = 0
    for path, leaf in flatten(tree).items():
        keys = path.split("/")
        if any("moe" in k for k in keys) and any(
                w in k for k in keys for w in ("w_in", "w_gate", "w_out")):
            expert += leaf.numel()
    frac = cfg.moe.top_k / cfg.moe.num_experts
    return total - expert * (1.0 - frac)


def microbatches_for(cfg: ModelConfig, shape: ShapeConfig, dp_total: int
                     ) -> int:
    if shape.kind != "train":
        return 1
    per_dev = max(shape.global_batch // dp_total, 1)
    target_tokens = 4096 if cfg.d_model >= 10000 else 8192
    mb_per_dev = max(1, target_tokens // shape.seq_len)
    return max(1, per_dev // mb_per_dev)


# --------------------------------------------------------------------- #
# Abstract inputs
# --------------------------------------------------------------------- #

def input_sds(cfg: ModelConfig, shape: ShapeConfig, micro: int) -> dict:
    """Meta-tensor stand-ins for every model input (no allocation)."""
    b, s = shape.global_batch, shape.seq_len
    cd = L.cdtype(cfg)

    def sds(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    if shape.kind == "train":
        mb = b // micro
        out = {}
        if cfg.enc_dec:
            out["enc_embeds"] = sds((micro, mb, s, cfg.d_model), cd)
        if cfg.frontend == "vision_stub":
            out["embeds"] = sds((micro, mb, s, cfg.d_model), cd)
        else:
            out["tokens"] = sds((micro, mb, s), torch.int32)
        out["labels"] = sds((micro, mb, s), torch.int32)
        return out
    if shape.kind == "prefill":
        if cfg.enc_dec:
            return {"enc_embeds": sds((b, s, cfg.d_model), cd),
                    "tokens": sds((b, 8), torch.int32)}
        if cfg.frontend == "vision_stub":
            return {"embeds": sds((b, s, cfg.d_model), cd)}
        return {"tokens": sds((b, s), torch.int32)}
    return {"tokens": sds((b, 1), torch.int32)}


def named(mesh, spec_tree):
    """A ``NamedSharding`` for every spec of ``spec_tree`` (unfitted)."""
    if isinstance(spec_tree, dict):
        return {k: named(mesh, v) for k, v in spec_tree.items()}
    return NamedSharding(mesh, spec_tree)


def strip_data_axis(spec_tree):
    """TP-only param specs for serving: FSDP ("data") sharding of weights
    makes every layer re-all-gather its weights at inference time; serving
    replicates across "data" instead (the reference's tp_serve variant)."""
    if isinstance(spec_tree, dict):
        return {k: strip_data_axis(v) for k, v in spec_tree.items()}
    return P(*(None if e == "data" else e for e in tuple(spec_tree)))


# --------------------------------------------------------------------- #
# Meta tensors on the fake mesh
# --------------------------------------------------------------------- #

def ensure_fake_group(world: int) -> None:
    """Make the default process group the fake one of ``world`` ranks
    (this process is rank 0).  A real group is refused: the fake one
    would replace it."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("the dry run needs the fake process group; "
                               "this process has a real one")
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _fake(tree):
    """A new meta tensor shaped like each leaf of ``tree``."""
    if isinstance(tree, dict):
        return {k: _fake(v) for k, v in tree.items()}
    return torch.empty(tuple(tree.shape), dtype=tree.dtype, device="meta")


def _placed(mesh, spec_tree, tree):
    """``tree`` (fake tensors) distributed by its fitted specs, each rank
    keeping its own piece."""
    return device_put(tree, shardings(mesh, spec_tree, tree),
                      src_data_rank=None)


def _put(t, spec, mesh):
    return distribute(t, NamedSharding(mesh, fit(spec, tuple(t.shape),
                                                 mesh)), src_data_rank=None)


def _local_bytes(*trees) -> int:
    total = 0
    for tree in trees:
        leaves = flatten(tree).values() if isinstance(tree, dict) \
            else [tree]
        for t in leaves:
            if isinstance(t, torch.Tensor):
                t = t.to_local() if is_dtensor(t) else t
                total += t.numel() * t.element_size()
    return total


def _whole_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in flatten(tree).values())


class _MetaHostReads(TorchDispatchMode):
    """A host read of a meta scalar (the optimizer's step count) gives 0:
    a dry run has shapes, not values."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if func is torch.ops.aten._local_scalar_dense.default and \
                args[0].device.type == "meta":
            return 0
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def counted(mesh):
    """A :class:`~repro_torch.launch.roofline.StepCounter` over the body,
    with the loops' sampler installed, the mesh ambient, plain tensors
    joining DTensors as replicated and meta scalars read as 0."""
    from torch.distributed.tensor.experimental import implicit_replication

    c = R.StepCounter(device="meta")
    token = loops.STEP_SAMPLER.set(c.scaled)
    try:
        with c, _MetaHostReads(), use_mesh(mesh), implicit_replication():
            yield c
    finally:
        loops.STEP_SAMPLER.reset(token)


def _step_count(c: R.StepCounter, args: int, outs: int,
                seconds: float) -> dict:
    return {"flops": c.flops, "bytes": c.bytes,
            "collectives": dict(c.collectives),
            "argument_size_in_bytes": args, "output_size_in_bytes": outs,
            "temp_size_in_bytes": int(c.peak_bytes), "seconds": seconds}


# --------------------------------------------------------------------- #
# The full step
# --------------------------------------------------------------------- #

def lower_full_step(cfg: ModelConfig, shape: ShapeConfig, mesh, micro: int,
                    tp_only_params: bool = False) -> dict:
    """The cell's whole step on meta tensors under the counter: a dict
    of its per-device ``flops``, ``bytes``, ``collectives`` by kind, the
    memory (``argument_size_in_bytes``, ``output_size_in_bytes``,
    ``temp_size_in_bytes``), the per-device and whole bytes of the
    parameters and moments (``per_device``, ``unsharded``) and the
    trace's ``seconds``.  Needs the fake process group."""
    dp = T.dp_axes(mesh)
    pspecs = M.param_specs(cfg)
    if tp_only_params:
        pspecs = strip_data_axis(pspecs)
    with torch.device("meta"):
        params = _placed(mesh, pspecs, _fake(abstract_params(cfg)))
        per_dev = {"params": _local_bytes(params)}
        whole = {"params": _whole_bytes(params)}
        if shape.kind == "train":
            opt_cfg = O.OptConfig(opt_dtype=cfg.opt_dtype)
            opt = O.init_opt_state(opt_cfg, params)
            opt = _placed(mesh, O.opt_state_specs(pspecs), opt)
            per_dev["opt_state"] = _local_bytes(opt)
            whole["opt_state"] = _whole_bytes(opt)
            batch = {k: _put(_fake(v), P(None, dp, None, None)
                             if v.dim() == 4 else P(None, dp, None), mesh)
                     for k, v in input_sds(cfg, shape, micro).items()}
            args = _local_bytes(params, opt, batch)
            step = T.make_train_step(cfg, opt_cfg)
            t0 = time.perf_counter()
            with counted(mesh) as c:
                params, opt, stats = step(params, opt, batch)
            res = _step_count(c, args, _local_bytes(params, opt, stats),
                              time.perf_counter() - t0)
        elif shape.kind == "prefill":
            batch = {k: _put(_fake(v), P(dp, None, None)
                             if v.dim() == 3 else P(dp, None), mesh)
                     for k, v in input_sds(cfg, shape, micro).items()}
            args = _local_bytes(params, batch)
            t0 = time.perf_counter()
            with torch.no_grad(), counted(mesh) as c:
                logits, cache = M.prefill(cfg, params, batch,
                                          max_len=shape.seq_len)
                logits = _put(logits, P(dp, None, None), mesh)
                cache = _placed(mesh, M.cache_specs(cfg), cache)
            res = _step_count(c, args, _local_bytes(logits, cache),
                              time.perf_counter() - t0)
        else:
            b = shape.global_batch
            cache = _placed(mesh, M.cache_specs(cfg), M.init_cache(
                cfg, b, shape.seq_len, device="meta"))
            tokens = _put(torch.empty((b, 1), dtype=torch.int32),
                          P(dp, None), mesh)
            cross = None
            if cfg.enc_dec:
                kvd = cfg.n_kv_heads * cfg.d_head
                cross = {n: _put(torch.empty(
                    (cfg.num_periods, b, ENC_FRAMES, kvd),
                    dtype=L.cdtype(cfg)), P(None, dp, None, "model"), mesh)
                    for n in ("k", "v")}
            args = _local_bytes(params, cache, tokens) + \
                (_local_bytes(cross) if cross else 0)
            t0 = time.perf_counter()
            with torch.no_grad(), counted(mesh) as c:
                logits, cache = M.decode_step(cfg, params, cache, tokens,
                                              shape.seq_len - 1, cross)
                logits = _put(logits, P(dp, None, None), mesh)
            res = _step_count(c, args, _local_bytes(logits, cache),
                              time.perf_counter() - t0)
    res["per_device"], res["unsharded"] = per_dev, whole
    return res


# --------------------------------------------------------------------- #
# Components (the reference's breakdown)
# --------------------------------------------------------------------- #

def _period_specs(cfg: ModelConfig) -> dict:
    return {f"block{i}": M._block_specs(cfg, kind, i,
                                        with_cross=cfg.enc_dec)
            for i, kind in enumerate(cfg.block_pattern)}


def _unstack(tree):
    """Meta stand-ins of one period's leaves (the period axis cut)."""
    if isinstance(tree, dict):
        return {k: _unstack(v) for k, v in tree.items()}
    return torch.empty(tuple(tree.shape[1:]), dtype=tree.dtype,
                       device="meta")


def _drop_lead(spec_tree):
    if isinstance(spec_tree, dict):
        return {k: _drop_lead(v) for k, v in spec_tree.items()}
    return P(*tuple(spec_tree)[1:])


def _grad(loss: torch.Tensor, trees: list) -> None:
    leaves = [t for tree in trees for t in (
        flatten(tree).values() if isinstance(tree, dict) else [tree])]
    torch.autograd.grad(loss, leaves, allow_unused=True)


def _requires_grad(tree):
    for t in (flatten(tree).values() if isinstance(tree, dict) else [tree]):
        t.requires_grad_(True)
    return tree


def components(cfg: ModelConfig, shape: ShapeConfig, mesh, micro: int,
               tp_only_params: bool = False):
    """Yield ``(name, multiplier, counts)`` for the cell's breakdown:
    each component runs alone on meta tensors under the counter, with
    the full step's shardings; ``counts`` as :func:`lower_full_step`'s
    (unscaled by the multiplier)."""
    dp = T.dp_axes(mesh)
    b, s, d = shape.global_batch, shape.seq_len, cfg.d_model
    cd = L.cdtype(cfg)
    meta = abstract_params(cfg)
    pp_specs = _period_specs(cfg)
    emb_specs = L.embed_specs(cfg)
    if tp_only_params:
        pp_specs = strip_data_axis(pp_specs)
        emb_specs = strip_data_axis(emb_specs)

    def run(fn, *args_trees):
        t0 = time.perf_counter()
        with counted(mesh) as c:
            outs = fn()
        return _step_count(c, _local_bytes(*args_trees),
                           _local_bytes(*outs) if outs else 0,
                           time.perf_counter() - t0)

    with torch.device("meta"):
        def period_params():
            return _placed(mesh, pp_specs, _fake(_unstack(meta["periods"])))

        ep = _placed(mesh, emb_specs, _fake(meta["embed"]))
        fp = _placed(mesh, L.rmsnorm_specs(cfg), _fake(meta["final_norm"]))
        if shape.kind == "train":
            mb = b // micro
            x = _put(torch.empty((mb, s, d), dtype=cd), P(dp, None, None),
                     mesh)
            tok = _put(torch.empty((mb, s), dtype=torch.int32), P(dp, None),
                       mesh)
            pp = _requires_grad(period_params())
            xg = x.detach().requires_grad_(True)

            def period_grad():
                y = M.period_fn(cfg, pp, xg, torch.arange(s))
                _grad(y.float().sum(), [pp, xg])

            yield ("period_grad", cfg.num_periods * micro,
                   run(period_grad, pp, xg))
            _requires_grad(ep)
            _requires_grad(fp)

            def head_grad():
                h = L.rmsnorm(fp, xg, cfg.norm_eps)
                logits = L.lm_head(cfg, ep, h)
                logz = M.logsumexp(logits)
                gold = M.gold_logits(logits, tok.long().clamp(min=0))
                _grad((logz - gold).mean(), [ep, fp, xg])

            yield "head_grad", micro, run(head_grad, ep, fp, xg, tok)

            def embed_grad():
                _grad(L.embed(cfg, ep, tok).float().sum(), [ep])

            yield "embed_grad", micro, run(embed_grad, ep, tok)
            opt_cfg = O.OptConfig(opt_dtype=cfg.opt_dtype)
            pspecs = M.param_specs(cfg)
            params = _placed(mesh, pspecs, _fake(meta))
            grads = _placed(mesh, pspecs, _float32(_fake(meta)))
            opt = _placed(mesh, O.opt_state_specs(pspecs),
                          O.init_opt_state(opt_cfg, params))

            def opt_update():
                O.apply_updates(opt_cfg, params, grads, opt)
                return [params, opt]

            yield "opt_update", 1, run(opt_update, params, grads, opt)
            if cfg.enc_dec:
                enc_specs = {"block0": M._block_specs(cfg, "attn", 0)}
                if tp_only_params:
                    enc_specs = strip_data_axis(enc_specs)
                encp = _requires_grad(_placed(mesh, enc_specs, _fake(
                    {"block0": _unstack(meta["enc_periods"]["block0"])})))

                def enc_period_grad():
                    y = M._apply_block(cfg, "attn", encp["block0"], xg,
                                       torch.arange(s), causal=False)
                    _grad(y.float().sum(), [encp, xg])

                yield ("enc_period_grad", cfg.enc_layers * micro,
                       run(enc_period_grad, encp, xg))
            return

        if shape.kind == "prefill":
            x = _put(torch.empty((b, s, d), dtype=cd), P(dp, None, None),
                     mesh)
            pp = period_params()

            def period_fwd():
                with torch.no_grad():
                    return [M.period_fn(cfg, pp, x, torch.arange(s))]

            yield "period_fwd", cfg.num_periods, run(period_fwd, pp, x)

            def head_fwd():
                with torch.no_grad():
                    return [L.lm_head(cfg, ep, L.rmsnorm(
                        fp, x[:, -1:], cfg.norm_eps))]

            yield "head_fwd", 1, run(head_fwd, ep, fp, x)
            return

        specs = _drop_lead(M.cache_specs(cfg))
        pcache = _placed(mesh, specs, _fake(_unstack(_meta_cache(cfg, b, s))))
        x = _put(torch.empty((b, 1, d), dtype=cd), P(dp, None, None), mesh)
        pp = period_params()

        def period_decode():
            with torch.no_grad():
                return [M.period_decode(cfg, pp, pcache, x, s - 1)]

        yield ("period_decode", cfg.num_periods,
               run(period_decode, pp, pcache, x))

        def head_decode():
            with torch.no_grad():
                return [L.lm_head(cfg, ep, L.rmsnorm(fp, x, cfg.norm_eps))]

        yield "head_decode", 1, run(head_decode, ep, fp, x)


def _float32(tree):
    if isinstance(tree, dict):
        return {k: _float32(v) for k, v in tree.items()}
    return tree.float()


def _meta_cache(cfg: ModelConfig, b: int, s: int) -> dict:
    return M.init_cache(cfg, b, s, device="meta")


# --------------------------------------------------------------------- #
# Cell runner
# --------------------------------------------------------------------- #

def apply_variant(cfg: ModelConfig, variant: str,
                  shape: ShapeConfig | None = None) -> ModelConfig:
    """``cfg`` under ``variant``: itself unless it is ``"opt"``, the
    reference's perf knobs.  Their gates are the reference's, set for
    its mesh (heads >= its 16-way model axis; ``sp_decode`` only in the
    B = 1 ``long_500k`` cell)."""
    if variant != "opt":
        return cfg
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe_dp_sharding=True)
    cfg = dataclasses.replace(
        cfg,
        attn_q_chunk=2048,
        attn_shard_heads=(cfg.n_heads >= 16),
        attn_scores_bf16=(cfg.attn_softcap is None),
        rwkv_chunk=64 if "rwkv" in cfg.block_pattern else None,
    )
    if shape is not None and shape.name == "long_500k":
        cfg = dataclasses.replace(cfg, sp_decode=True)
    return cfg


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             skip_components: bool = False, variant: str = "base",
             cfg: ModelConfig | None = None, mesh=None) -> dict:
    """One cell's record (the reference's fields).  ``cfg`` replaces the
    arch's config (a reduced one in the tests) and ``mesh`` the
    production mesh; without ``mesh`` the fake group of 256 (512) ranks
    is made the default group."""
    from repro_torch.launch.mesh import make_production_mesh

    shape = SHAPES[shape_name]
    cfg = apply_variant(cfg or get_config(arch), variant, shape)
    if mesh is None:
        ensure_fake_group(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod)
    chips = mesh.size()
    dp_total = chips // mesh.size(mesh.mesh_dim_names.index("model"))
    micro = microbatches_for(cfg, shape, dp_total)
    tp_only = variant == "opt" and shape.kind != "train"
    t0 = time.time()
    result = {
        "arch": arch, "shape": shape_name, "variant": variant,
        "mesh": "x".join(str(n) for n in mesh.shape),
        "chips": chips, "microbatches": micro,
    }
    full = lower_full_step(cfg, shape, mesh, micro, tp_only_params=tp_only)
    result["memory_analysis"] = {
        k: full[k] for k in ("argument_size_in_bytes",
                             "output_size_in_bytes", "temp_size_in_bytes")}
    result["per_device_bytes"] = full["per_device"]
    result["unsharded_bytes"] = full["unsharded"]
    result["full_step_cost"] = {"flops": full["flops"],
                                "bytes": full["bytes"]}
    result["full_step_collectives"] = full["collectives"]
    result["compile_s"] = round(full["seconds"], 1)
    meta = abstract_params(cfg)
    n_active = active_params(cfg, meta)
    result["n_params"] = count_params(meta)
    result["n_params_active"] = n_active
    coll = sum(full["collectives"].values())
    terms = R.RooflineTerms(full["flops"], full["bytes"], coll, chips)
    result["roofline"] = terms.as_dict()
    tokens = shape.global_batch * (
        1 if shape.kind == "decode" else shape.seq_len)
    mf = (R.model_flops_train(n_active, tokens) if shape.kind == "train"
          else R.model_flops_decode(n_active, tokens))
    result["model_flops"] = mf
    # the counted FLOPs are per device; the model's are global
    result["model_flops_ratio"] = (mf / (full["flops"] * chips)
                                   if full["flops"] else 0.0)
    if not skip_components:
        detail = {}
        for name, mult, cnt in components(cfg, shape, mesh, micro,
                                          tp_only_params=tp_only):
            detail[name] = {
                "mult": mult, "flops": cnt["flops"] * mult,
                "bytes": cnt["bytes"] * mult,
                "collective_bytes": sum(cnt["collectives"].values()) * mult}
        result["components"] = detail
    result["total_s"] = round(time.time() - t0, 1)
    return result


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--skip-components", action="store_true")
    ap.add_argument("--variant", default="base", choices=["base", "opt"])
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    args = ap.parse_args(argv)

    from repro_torch.configs import cells

    todo = cells() if args.all else [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    os.makedirs(args.out, exist_ok=True)
    failures = []
    for arch, shape in todo:
        for mp in meshes:
            tag = f"{arch}_{shape}_{'pod2' if mp else 'pod1'}"
            if args.variant != "base":
                tag += f"_{args.variant}"
            out_path = os.path.join(args.out, tag + ".json")
            if os.path.exists(out_path):
                print(f"[skip] {tag} (artifact exists)")
                continue
            print(f"[run ] {tag}", flush=True)
            try:
                res = run_cell(arch, shape, mp,
                               skip_components=args.skip_components or mp,
                               variant=args.variant)
                with open(out_path, "w") as f:
                    json.dump(res, f, indent=1)
                rf = res["roofline"]
                print(f"[ok  ] {tag} trace={res['compile_s']}s "
                      f"bottleneck={rf['bottleneck']}", flush=True)
            except Exception:
                failures.append(tag)
                with open(os.path.join(args.out, tag + ".FAILED"), "w") as f:
                    f.write(traceback.format_exc())
                print(f"[FAIL] {tag}", flush=True)
                traceback.print_exc()
    if failures:
        raise SystemExit(f"{len(failures)} cells failed: {failures}")


if __name__ == "__main__":
    main()
