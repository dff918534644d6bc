"""One rank of a gloo group on the CPU, for the port's mesh tests.

    RANK=r WORLD_SIZE=n MASTER_ADDR=localhost MASTER_PORT=p \\
        python tests/_torch_mesh_worker.py CASE '{"arg": ...}'

Imports ``torch`` and ``repro_torch`` only.  Each case prints one JSON
line last (and may write ``.npz`` files where its arguments say); the
caller (``tests/_torch_mesh_util.py``) compares them with the reference.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.dist import sharding as S
from repro_torch.train.tree import flatten, unflatten


def load_tree(path: str) -> dict:
    with np.load(path) as z:
        return unflatten({k: z[k] for k in z.files})


def save_tree(path: str, tree: dict) -> None:
    from repro_torch.dist.sharding import full

    np.savez(path, **{k: full(v).detach().numpy()
                      for k, v in flatten(tree).items()})


def case_train(a: dict) -> dict:
    """``run_training`` on a ("data", "model") mesh from the reference's
    initial parameters; rank 0 also runs it with no mesh."""
    from repro_torch.train import loop as TL
    from repro_torch.train import optimizer as O

    cfg = get_config(a["arch"]).reduced()
    init = load_tree(a["params"])
    TL.init_params = lambda c, gen, device: convert.lm_params(init, device)
    mesh = init_device_mesh("cpu", tuple(a["mesh"]),
                            mesh_dim_names=("data", "model"))
    shape = ShapeConfig("t", a["seq"], a["batch"], "train")
    oc = O.OptConfig(lr=3e-4, warmup_steps=2, total_steps=a["steps"])

    def train(ckdir, mesh):
        tc = TL.TrainConfig(steps=a["steps"], checkpoint_every=100,
                            checkpoint_dir=ckdir, log_every=1)
        out = TL.run_training(cfg, shape, tc, oc, device="cpu", mesh=mesh)
        return [[r["loss"], r["grad_norm"]] for r in out["log"]]

    res = {"sharded": train(a["ckdir"] + "/mesh", mesh)}
    if dist.get_rank() == 0:
        res["plain"] = train(a["ckdir"] + "/plain", None)
    return res


def case_checkpoint(a: dict) -> dict:
    """A tree distributed on one mesh, saved, restored onto another."""
    from repro_torch.dist.sharding import device_put, full, shardings
    from repro_torch.models import lm as M
    from repro_torch.train import optimizer as O
    from repro_torch.train.checkpoint import CheckpointManager

    cfg = get_config(a["arch"]).reduced()
    params = M.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    pspecs = M.param_specs(cfg)
    opt = O.init_opt_state(O.OptConfig(), params)
    for i, v in enumerate(flatten(opt["mu"]).values()):
        v.normal_(generator=torch.Generator().manual_seed(i))
    tree = {"params": params, "opt": opt}
    specs = {"params": pspecs, "opt": O.opt_state_specs(pspecs)}
    names = ("data", "model")
    m1 = init_device_mesh("cpu", tuple(a["save_mesh"]), mesh_dim_names=names)
    m2 = init_device_mesh("cpu", tuple(a["load_mesh"]), mesh_dim_names=names)
    saved = device_put(tree, shardings(m1, specs, tree))
    cm = CheckpointManager(a["ckdir"])
    cm.save(1, saved, blocking=True)
    sh2 = shardings(m2, specs, tree)
    back = cm.restore(1, saved, sh2)
    same = placed = True
    for k, v in flatten(tree).items():
        got = flatten(back)[k]
        same &= bool(torch.equal(full(got), v))
        placed &= (tuple(got.placements) == flatten(sh2)[k].placements
                   and got.device_mesh == m2)
    return {"same": same, "placed": placed}


def case_ddp(a: dict) -> dict:
    """Compressed DDP steps on a 1-D ("data",) mesh."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.dist import ddp as D
    from repro_torch.train import optimizer as O

    cfg = get_config(a["arch"]).reduced()
    params = convert.lm_params(load_tree(a["params"]))
    mesh = init_device_mesh("cpu", (dist.get_world_size(),),
                            mesh_dim_names=("data",))
    oc = O.OptConfig(lr=a["lr"], warmup_steps=2, total_steps=20)
    opt = O.init_opt_state(oc, params)
    err = D.init_error_state(params)
    step = D.make_ddp_step(cfg, oc, compress=True, mesh=mesh, axis="data")
    src = SyntheticLM(cfg, ShapeConfig("t", a["seq"], a["batch"], "train"),
                      seed=1)
    losses = []
    for i in range(a["steps"]):
        b = src.batch_at(i)
        params, opt, err, loss = step(
            params, opt, err, {k: torch.from_numpy(v[0])
                               for k, v in b.items()})
        losses.append(float(loss))
    if dist.get_rank() == 0:
        save_tree(a["out"], {"params": params, "err": err})
    return {"losses": losses}


def case_moe(a: dict) -> dict:
    """The MoE layer on a batch-sharded DTensor against its plain run:
    routing over the whole batch, so the same tokens are dropped."""
    import dataclasses

    from repro_torch.dist.sharding import device_put, shardings, use_mesh
    from repro_torch.models import layers as L
    from repro_torch.models import lm as M

    cfg = dataclasses.replace(get_config(a["arch"]).reduced(),
                              moe_dp_sharding=a["moe_dp"])
    p = {k: torch.from_numpy(v) for k, v in np.load(a["moe"]).items()}
    x = torch.from_numpy(np.load(a["x"]))
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    spec = {"moe": M.param_specs(cfg)["periods"]["block0"]["moe"]}
    pd = device_put({"moe": p}, shardings(mesh, {"moe": {
        k: S.P(*tuple(v)[1:]) for k, v in spec["moe"].items()}}, {"moe": p}))
    xd = device_put(x, S.NamedSharding(mesh, S.P("data", None, None)))
    with torch.no_grad():
        plain = L.moe(cfg, p, x, capacity_factor=a["cf"])
        with use_mesh(mesh):
            got = L.moe(cfg, pd["moe"], xd, capacity_factor=a["cf"])
        _, _, _, keep, _ = L.moe_dispatch(cfg, p["router"],
                                          x.reshape(-1, x.shape[-1]),
                                          a["cf"])
    whole = S.full(got)
    if dist.get_rank() == 0:
        np.save(a["out"], whole.numpy())
    return {"err": float((whole - plain).abs().max()),
            "dropped": int((~keep).sum()),
            "placements": [str(q) for q in got.placements]}


def case_sp_decode(a: dict) -> dict:
    """Two decode steps with ``sp_decode`` against a sequence-sharded
    cache on a ("data", "model") mesh, beside the full forward."""
    import dataclasses

    from repro_torch.dist.sharding import device_put, shardings, use_mesh
    from repro_torch.models import lm as M

    cfg = get_config(a["arch"]).reduced()
    params = convert.lm_params(load_tree(a["params"]))
    toks = torch.from_numpy(np.asarray(a["tokens"], np.int32))
    s = toks.shape[1]
    mesh = init_device_mesh("cpu", tuple(a["mesh"]),
                            mesh_dim_names=("data", "model"))
    cfg_sp = dataclasses.replace(cfg, sp_decode=True)
    with torch.no_grad():
        full = M.forward_logits(cfg, params, {"tokens": toks})
        _, cache = M.prefill(cfg_sp, params, {"tokens": toks[:, :s - 1]},
                             max_len=a["max_len"])
        cache = device_put(cache, shardings(mesh, M.cache_specs(cfg_sp),
                                            cache))
        with use_mesh(mesh):
            step, cache = M.decode_step(cfg_sp, params, cache,
                                        toks[:, s - 1:s], s - 1)
            nxt = step[:, 0].argmax(-1)[:, None].to(torch.int32)
            step2, cache = M.decode_step(cfg_sp, params, cache, nxt, s)
        full2 = M.forward_logits(cfg, params,
                                 {"tokens": torch.cat([toks, nxt], 1)})
    k = cache["block0"]["k"]
    return {"err": float((full[:, -1] - step[:, 0]).abs().max()),
            "err2": float((full2[:, -1] - step2[:, 0]).abs().max()),
            "placements": [str(p) for p in k.placements],
            "local_rows": int(k.to_local().shape[2])}


def case_fused(a: dict) -> dict:
    """Queries and leaf addresses through the fused executors over a
    ``shard_mesh`` and on one rank (plain kernel versions)."""
    from repro_torch.dist.sharding import shard_mesh
    from repro_torch.kernels.fused_session import (
        FusedGbdtExec,
        FusedTableExec,
    )

    with np.load(a["data"]) as z:
        feats = [z[f"f{i}"] for i in range(a["num_features"])]
        X = z["X"]
        forest = convert.forest(z["feature_idx"], z["thresholds"],
                                z["leaves"], a["forest_bits"],
                                a["forest_features"])
    table = convert.table(a["n_bits"], feats)
    mesh = shard_mesh(a["num_shards"])
    if mesh.get_coordinate() is None:       # a rank the mesh leaves out
        with pytest.raises(ValueError, match="not in the executor's mesh"):
            FusedTableExec(table, a["num_shards"], a["num_chunks"],
                           mesh=mesh)
        return {"ranks": mesh.size(), "lut_shards": None}
    queries = [tuple(q) for q in json.loads(a["queries"])]
    queries = [(q[0], *q[1:3], [str(o) for o in q[3]],
                [tuple(t) for t in q[4]]) if q[0] == "compound" else q
               for q in queries]
    got = FusedTableExec(table, a["num_shards"], a["num_chunks"],
                         mesh=mesh).run(queries)
    one = FusedTableExec(table, a["num_shards"], a["num_chunks"],
                         device="cpu").run(queries)
    gx = FusedGbdtExec(forest, a["forest_chunks"], mesh=mesh)
    addrs = gx.leaf_addrs(X)
    res = {"ranks": mesh.size(), "lut_shards": int(FusedTableExec(
        table, a["num_shards"], a["num_chunks"], mesh=mesh).lut.shape[0])}
    if dist.get_rank() == 0:
        out = {"addrs": addrs,
               "addrs_one": FusedGbdtExec(forest, a["forest_chunks"],
                                          device="cpu").leaf_addrs(X),
               "pred": gx.infer(X)}
        for i, (g, o) in enumerate(zip(got, one)):
            out[f"got{i}"] = np.asarray(g)
            out[f"one{i}"] = np.asarray(o)
        np.savez(a["out"], **out)
    else:
        gx.infer(X)
    return res


def main() -> None:
    case, args = sys.argv[1], json.loads(sys.argv[2])
    torch.set_num_threads(1)
    dist.init_process_group("gloo")
    try:
        res = globals()[f"case_{case}"](args)
        res["rank"] = dist.get_rank()
        print(json.dumps(res), flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    main()
