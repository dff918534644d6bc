"""The port's partition specs against the reference's.

``repro_torch.dist.sharding.fit`` and every spec tree of the port
(``param_specs``, ``cache_specs`` with and without ``sp_decode``, the
layer and SSM ``*_specs``, ``opt_state_specs``, ``batch_specs``) equal
the reference's entry by entry, the reference's ``PartitionSpec`` read
as a tuple; ``fit`` is held on the reference's mesh doubles (a ``shape``
dict) of (16, 16), (2, 16, 16) and (2, 4) for every leaf of every
arch at full width, and on random shapes and specs.  Then the DTensor
side on a fake 16-rank (4, 4) mesh, in this process: placements, local
shard shapes, ``shard_mesh``'s rank count, and ``constrain`` outside a
mesh.  All exact.
"""

import dataclasses

import jax
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCHS as JARCHS
from repro.dist.sharding import fit as jfit
from repro.models import layers as JL
from repro.models import lm as JM
from repro.models import ssm as JS
from repro.train import optimizer as JO
from repro.train import train_step as JT
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.dist import sharding as S
from repro_torch.dist.sharding import P
from repro_torch.launch import dryrun as D
from repro_torch.models import layers as L
from repro_torch.models import lm as M
from repro_torch.models import ssm as SS
from repro_torch.train import optimizer as O
from repro_torch.train import train_step as T
from repro_torch.train.tree import flatten


class Double:
    """The reference's mesh test double: a ``shape`` dict."""

    def __init__(self, shape: dict) -> None:
        self.shape = shape


MESHES = {
    "16x16": Double({"data": 16, "model": 16}),
    "2x16x16": Double({"pod": 2, "data": 16, "model": 16}),
    "2x4": Double({"data": 2, "model": 4}),
}


def _ref_leaves(tree) -> dict:
    """A reference spec tree as ``{"a/b": tuple}``."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {"/".join(str(k.key) for k in path): tuple(spec)
            for path, spec in flat}


def _port_leaves(tree) -> dict:
    return {k: tuple(v) for k, v in flatten(tree).items()}


def _cfgs():
    for arch in ARCHS:
        for sp in (False, True):
            yield arch, sp


@pytest.mark.parametrize("arch,sp", list(_cfgs()))
def test_spec_trees_equal_the_reference(arch, sp):
    tc = dataclasses.replace(ARCHS[arch], sp_decode=sp)
    jc = dataclasses.replace(JARCHS[arch], sp_decode=sp)
    for port, ref in ((M.param_specs(tc), JM.param_specs(jc)),
                      (M.cache_specs(tc), JM.cache_specs(jc)),
                      (O.opt_state_specs(M.param_specs(tc)),
                       JO.opt_state_specs(JM.param_specs(jc)))):
        got, want = _port_leaves(port), _ref_leaves(ref)
        assert got == want
        assert all(isinstance(v, P) for v in flatten(port).values())


def test_layer_specs_equal_the_reference():
    for arch in ARCHS:
        tc, jc = ARCHS[arch], JARCHS[arch]
        pairs = [(L.rmsnorm_specs, JL.rmsnorm_specs),
                 (L.attn_specs, JL.attn_specs), (L.mlp_specs, JL.mlp_specs),
                 (L.embed_specs, JL.embed_specs),
                 (SS.rwkv_specs, JS.rwkv_specs),
                 (SS.rwkv_ffn_specs, JS.rwkv_ffn_specs),
                 (SS.mamba_specs, JS.mamba_specs)]
        if tc.moe is not None:
            pairs.append((L.moe_specs, JL.moe_specs))
        for port, ref in pairs:
            assert _port_leaves(port(tc)) == _ref_leaves(ref(jc)), port


def _shapes(arch: str) -> dict:
    """Every leaf shape of the full-width parameters and of a
    decode_32k cache (and an sp_decode one), on the meta device."""
    cfg = ARCHS[arch]
    shape = SHAPES["decode_32k"]
    out = {f"p/{k}": tuple(v.shape)
           for k, v in flatten(D.abstract_params(cfg)).items()}
    out.update({f"c/{k}": tuple(v.shape) for k, v in flatten(M.init_cache(
        cfg, shape.global_batch, shape.seq_len, device="meta")).items()})
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_fit_equals_the_reference_on_every_leaf(arch, mesh):
    m = MESHES[mesh]
    shapes = _shapes(arch)
    for sp in (False, True):
        tc = dataclasses.replace(ARCHS[arch], sp_decode=sp)
        jc = dataclasses.replace(JARCHS[arch], sp_decode=sp)
        specs = {**{f"p/{k}": v for k, v in
                    _port_leaves(M.param_specs(tc)).items()},
                 **{f"c/{k}": v for k, v in
                    _port_leaves(M.cache_specs(tc)).items()}}
        refs = {**{f"p/{k}": v for k, v in
                   _ref_leaves(JM.param_specs(jc)).items()},
                **{f"c/{k}": v for k, v in
                   _ref_leaves(JM.cache_specs(jc)).items()}}
        assert set(specs) == set(shapes) == set(refs)
        for key, shp in shapes.items():
            got = S.fit(P(*specs[key]), shp, m)
            want = jfit(JP(*refs[key]), shp, m)
            assert tuple(got) == tuple(want), (key, shp, got, want)


NAMES = ("pod", "data", "model", "absent")
entry = st.one_of(st.none(), st.sampled_from(NAMES),
                  st.lists(st.sampled_from(NAMES), min_size=1, max_size=3,
                           unique=True).map(tuple))


@settings(max_examples=300, deadline=None)
@given(spec=st.lists(entry, max_size=4),
       shape=st.lists(st.integers(1, 96), min_size=0, max_size=5),
       mesh=st.sampled_from(list(MESHES)))
def test_fit_property_against_the_reference(spec, shape, mesh):
    got = S.fit(P(*spec), tuple(shape), MESHES[mesh])
    want = jfit(JP(*spec), tuple(shape), MESHES[mesh])
    assert tuple(got) == tuple(want)


def test_batch_specs_and_dp_axes_equal_the_reference():
    class Named:
        def __init__(self, names):
            self.mesh_dim_names = names
            self.axis_names = names

    cfg = ARCHS["minitron-8b"]
    shapes = {"tokens": ((4, 8, 16), "int32"), "labels": ((8, 16), "int32"),
              "embeds": ((4, 8, 16, 32), "bfloat16"),
              "enc_embeds": ((8, 16, 32), "bfloat16")}
    for names in (("data", "model"), ("pod", "data", "model"), ("model",)):
        got = T.batch_specs(cfg, Named(names), shapes)
        want = JT.batch_specs(JARCHS["minitron-8b"], Named(names), shapes)
        assert T.dp_axes(Named(names)) == JT.dp_axes(Named(names))
        assert {k: tuple(v) for k, v in got.items()} == \
            {k: tuple(v) for k, v in want.items()}


def test_strip_data_axis_equals_the_reference():
    from test_torch_launch import _reference_dryrun

    JD = _reference_dryrun()
    cfg = ARCHS["mixtral-8x7b"]
    got = _port_leaves(D.strip_data_axis(M.param_specs(cfg)))
    want = _ref_leaves(JD.strip_data_axis(JM.param_specs(
        JARCHS["mixtral-8x7b"])))
    assert got == want


# ----------------------------- DTensor side -------------------------- #

@pytest.fixture(scope="module")
def mesh44():
    """A fake 16-rank default group, this process its rank 0, and a
    (4, 4) ("data", "model") mesh on it; the group is destroyed after."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    D.ensure_fake_group(16)
    try:
        yield init_device_mesh("cpu", (4, 4),
                               mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def test_placements_follow_the_spec(mesh44):
    from torch.distributed.tensor import Replicate, Shard

    assert S.placements(P("data", "model"), mesh44) == (Shard(0), Shard(1))
    assert S.placements(P("model", "data"), mesh44) == (Shard(1), Shard(0))
    assert S.placements(P(None, "model"), mesh44) == (Replicate(), Shard(1))
    assert S.placements(P(("data", "model"), None), mesh44) == \
        (Shard(0), Shard(0))
    assert S.placements(P(), mesh44) == (Replicate(), Replicate())
    with pytest.raises(ValueError, match="mesh order"):
        S.placements(P(("model", "data")), mesh44)
    with pytest.raises(ValueError, match="no axis"):
        S.placements(P("pod"), mesh44)
    with pytest.raises(ValueError, match="twice"):
        S.placements(P("data", "data"), mesh44)


def test_tuple_entries_in_the_spec_trees_are_in_mesh_order():
    """No spec tree holds an entry that ``placements`` refuses: every
    tuple entry names its axes in mesh order."""
    order = ("pod", "data", "model")
    for arch in ARCHS:
        for sp in (False, True):
            cfg = dataclasses.replace(ARCHS[arch], sp_decode=sp)
            for spec in list(flatten(M.param_specs(cfg)).values()) + \
                    list(flatten(M.cache_specs(cfg)).values()):
                for e in spec:
                    if isinstance(e, tuple):
                        idx = [order.index(n) for n in e]
                        assert idx == sorted(idx), (arch, spec)


def test_local_shard_shapes_on_a_fake_mesh(mesh44):
    cfg = ARCHS["granite-moe-3b-a800m"]
    meta = D.abstract_params(cfg)
    sh = S.shardings(mesh44, M.param_specs(cfg), meta)
    placed = S.device_put(D._fake(meta), sh, src_data_rank=None)
    for key, t in flatten(placed).items():
        spec = flatten(sh)[key].spec
        want = list(t.shape)
        for d, e in enumerate(spec):
            for n in ((e,) if isinstance(e, str) else e or ()):
                want[d] //= 4
        assert list(t.to_local().shape) == want, (key, spec)
        assert t.placements == S.placements(spec, mesh44)
    q = D.abstract_params(cfg)["periods"]["block0"]["attn"]["wq"]
    assert S.fit(P(None, "data", "model"), q.shape, mesh44) == \
        P(None, "data", "model")


def test_shard_mesh_takes_the_largest_dividing_rank_count(mesh44):
    for shards, want in ((32, 16), (12, 12), (7, 7), (17, 1), (3, 3),
                         (20, 10)):
        m = S.shard_mesh(shards)
        assert m.size() == want and m.mesh_dim_names == ("shards",)
    assert S.shard_mesh(6, axis="x", devices=[0, 1, 2, 3]).size() == 3


def test_constrain_is_the_identity_outside_a_mesh(mesh44):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    x = torch.arange(64.0).reshape(8, 8)
    assert S.constrain(x, P("data", "model")) is x
    with S.use_mesh(mesh44):
        assert S.constrain(x, P("data", "model")) is x   # a plain tensor
    d = distribute_tensor(x, mesh44, [Replicate(), Replicate()])
    assert S.constrain(d, P("data", "model")) is d     # no ambient mesh
    with S.use_mesh(mesh44):
        got = S.constrain(d, P("data", ("pod", "model")))
        assert got.placements == (Shard(0), Shard(1))
        odd = S.constrain(d[:6], P("model", None))       # 6 % 4 != 0
        assert odd.placements == (Replicate(), Replicate())
        uneven = S.constrain(d[:6], P("model", None), allow_uneven=True)
        assert uneven.placements == (Replicate(), Shard(0))
    assert S.constrain(d, P("data", "model")) is d     # the mesh is gone
