"""Partition specs on a ``torch.distributed`` device mesh.

Counterpart of the reference package's ``dist/sharding.py``.  A logical
spec like ``P(("pod", "data"), "model")`` is written once per parameter
tree; ``fit`` shrinks it to what a concrete shape supports on a mesh
(the same algorithm, on any mesh object with a ``shape`` dict, a
``DeviceMesh`` or the reference's test doubles).  Where the reference
builds a ``NamedSharding``, the port builds DTensor placements: a mesh
dimension named in tensor dimension ``d``'s entry shards ``d``
(``Shard(d)``), every other mesh dimension replicates.  A tuple entry
shards its dimension over several mesh dimensions, major to minor in
mesh order, as JAX does; an entry that names them out of mesh order has
no such placement and is refused.

``use_mesh(mesh)`` is the reference's ``with mesh:``: inside it,
``constrain`` redistributes a DTensor to a spec, and outside it (or on a
plain tensor) ``constrain`` is the identity, so model code annotates
layouts unconditionally.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any

import torch


class P(tuple):
    """A partition spec: one entry per tensor dimension, each ``None``
    (replicated), a mesh axis name, or a tuple of names.  Dimensions past
    its length are replicated.  As JAX's ``PartitionSpec`` does, a tuple
    of one name is that name and an empty tuple is None."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                return None if not e else e[0] if len(e) == 1 else tuple(e)
            return e

        return super().__new__(cls, (norm(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}" if len(self) != 1 \
            else f"P({self[0]!r})"


def _axis_sizes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or of any object with a
    ``shape`` dict (the reference's test doubles)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def _names(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def fit(spec, shape, mesh) -> P:
    """Largest prefix of ``spec`` that evenly divides ``shape`` on
    ``mesh``.

    Per dimension, axis names are kept left to right while their
    cumulative mesh-axis product divides the dimension size; the first
    non-dividing axis drops the rest of that dimension's names.  A
    dropped dimension becomes ``None`` (replicated).  Dimensions beyond
    ``len(spec)`` are replicated."""
    sizes = _axis_sizes(mesh)
    entries: list[Any] = []
    spec_t = tuple(spec)
    for i, dim in enumerate(shape):
        entry = spec_t[i] if i < len(spec_t) else None
        if entry is None:
            entries.append(None)
            continue
        names = _names(entry)
        keep: list[str] = []
        prod = 1
        for name in names:
            size = sizes.get(name, 1)
            if dim % (prod * size) != 0:
                break
            keep.append(name)
            prod *= size
        if not keep:
            entries.append(None)
        elif len(keep) == 1:
            entries.append(keep[0])
        elif len(keep) == len(names) and not isinstance(entry, str):
            entries.append(entry)   # the original tuple object
        else:
            entries.append(tuple(keep))
    return P(*entries)


def placements(spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh
    dimension: ``Shard(d)`` where the mesh dimension is named in tensor
    dimension ``d``'s entry and holds more than one rank, else
    ``Replicate()`` (DTensor restricts views of a dimension it calls
    sharded, even over one rank).  Raises
    ``ValueError`` for a name the mesh lacks, a name used twice, or a
    tuple entry out of mesh order."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    seen: set[str] = set()
    for d, entry in enumerate(tuple(spec)):
        axes = _names(entry)
        pos = []
        for a in axes:
            if a not in names:
                raise ValueError(f"{spec}: mesh {names} has no axis {a!r}")
            if a in seen:
                raise ValueError(f"{spec}: axis {a!r} used twice")
            seen.add(a)
            pos.append(names.index(a))
        if pos != sorted(pos):
            raise ValueError(
                f"{spec}: entry {entry!r} is not in mesh order {names}; "
                "DTensor shards a dimension major to minor in mesh order")
        for i in pos:
            if mesh.size(i) > 1:     # one rank splits nothing: replicated
                out[i] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: the counterpart of ``jax.sharding.NamedSharding``
    (``spec`` already fitted to the leaf it places)."""

    mesh: Any
    spec: P

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def _map(fn, *trees):
    """``fn`` over the leaves of nested dicts (the first tree's keys)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def shardings(mesh, spec_tree, tree):
    """A ``NamedSharding`` tree for ``tree`` (tensors, or anything with a
    ``shape``), each leaf's logical spec fitted to its shape.  With
    :func:`device_put` it distributes the tree."""
    return _map(lambda spec, leaf: NamedSharding(
        mesh, fit(spec, tuple(leaf.shape), mesh)), spec_tree, tree)


def distribute(t: torch.Tensor, sharding: NamedSharding,
               src_data_rank: int | None = 0):
    """``t`` (the whole tensor, the same on every rank) as a DTensor
    placed by ``sharding``; rank ``src_data_rank``'s copy is the one
    scattered (``None``: each rank keeps its own piece, no collective).
    A DTensor is redistributed."""
    from torch.distributed.tensor import distribute_tensor

    if is_dtensor(t):
        return t.redistribute(sharding.mesh, sharding.placements)
    return distribute_tensor(t, sharding.mesh, sharding.placements,
                             src_data_rank=src_data_rank)


def device_put(tree, sharding_tree, src_data_rank: int | None = 0):
    """Every leaf of ``tree`` distributed by the matching leaf of
    ``sharding_tree`` (:func:`distribute`)."""
    return _map(lambda t, s: distribute(t, s, src_data_rank), tree,
                sharding_tree)


def is_dtensor(t) -> bool:
    """Whether ``t`` is a DTensor (without importing DTensor for a plain
    tensor's sake)."""
    if type(t) is torch.Tensor:
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def full(t):
    """The whole tensor of a DTensor as a plain tensor, the same on
    every rank (an all-gather, differentiable); any other ``t`` itself."""
    return t.full_tensor() if is_dtensor(t) else t


def split_dim(x, dim: int, sizes: tuple[int, ...]):
    """``x`` with dimension ``dim`` split into ``sizes`` (a reshape).

    DTensor shards the first of the new dimensions, so it refuses a
    split whose first size the shard count of ``dim`` does not divide
    (heads across ranks, where GSPMD pads): such mesh dimensions are
    replicated first.  A plain tensor is reshaped as it is."""
    dim = dim % x.dim()
    shape = tuple(x.shape[:dim]) + tuple(sizes) + tuple(x.shape[dim + 1:])
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate, Shard

        mesh, pl = x.device_mesh, list(x.placements)
        count = 1
        for i, q in enumerate(pl):
            if isinstance(q, Shard) and q.dim == dim:
                if sizes[0] % (count * mesh.size(i)):
                    pl[i] = Replicate()
                else:
                    count *= mesh.size(i)
        if pl != list(x.placements):
            x = x.redistribute(mesh, pl)
    return x.reshape(shape)


def merge_dims(x, shape: tuple[int, ...]):
    """``x`` reshaped to ``shape``, which merges dimensions (the inverse
    of :func:`split_dim`).  On a DTensor the gradient is brought back to
    the result's own placements before the backward splits it again,
    since a gradient sharded otherwise may not split."""
    y = x.reshape(shape)
    if is_dtensor(y):
        y = y.redistribute(y.device_mesh, y.placements)
    return y


#: the data-parallel axes, in mesh order
DP_AXES = ("pod", "data")


def gather_dp(tree):
    """Every DTensor leaf of ``tree`` with its data-parallel shards
    gathered (its "pod" / "data" mesh dimensions replicated), keeping
    its "model" split: a weight in its tensor-parallel layout, as FSDP
    all-gathers a layer's weights before use (the gradient
    reduce-scatters back).  Plain leaves are themselves."""
    if isinstance(tree, dict):
        return {k: gather_dp(v) for k, v in tree.items()}
    if not is_dtensor(tree):
        return tree
    from torch.distributed.tensor import Replicate

    names = tree.device_mesh.mesh_dim_names
    pl = [Replicate() if n in DP_AXES else q
          for n, q in zip(names, tree.placements)]
    if pl == list(tree.placements):
        return tree
    return tree.redistribute(tree.device_mesh, pl)


def spec_of(x) -> P:
    """The spec of DTensor ``x``'s layout: each dimension's entry the
    mesh axes that shard it, in mesh order (a pending sum reads as
    replicated)."""
    entries: list[list[str]] = [[] for _ in range(x.dim())]
    for name, pl in zip(x.device_mesh.mesh_dim_names, x.placements):
        if pl.is_shard():
            entries[pl.dim % x.dim()].append(name)
    return P(*entries)


def mesh_of(*tensors):
    """The mesh of the first DTensor among ``tensors``, or None."""
    for t in tensors:
        if is_dtensor(t):
            return t.device_mesh
    return None


def run_local(fn, args: tuple, arg_specs: tuple, out_specs: tuple):
    """``fn(*args)``, or, when a DTensor is among ``args``, ``fn`` on
    each rank's pieces with plain autograd (``local_map``): each
    argument laid out by its spec in ``arg_specs`` (a plain tensor taken
    as replicated; a None spec or argument passed as it is) and each
    result wrapped as a DTensor by ``out_specs``.  The specs must fit
    their tensors; DTensor then runs nothing inside ``fn``.

    An argument replicated over a mesh dimension that splits another
    argument meets only that rank's part of the other on each rank, so
    its gradient there is a partial sum, and is summed: a weight over
    the batch's ranks, an activation over a weight's "model" slices."""
    mesh = mesh_of(*args)
    if mesh is None:
        return fn(*args)
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    placed, in_pl = [], []
    for a, spec in zip(args, arg_specs):
        if a is None or spec is None:
            placed.append(a)
            in_pl.append(None)
            continue
        if not is_dtensor(a):
            a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        pl = placements(spec, mesh)
        placed.append(a.redistribute(mesh, pl))
        in_pl.append(pl)
    split = [any(pl is not None and not pl[m].is_replicate()
                 for pl in in_pl) for m in range(mesh.ndim)]
    grad_pl = tuple(None if pl is None else tuple(
        Partial() if q.is_replicate() and sp else q
        for q, sp in zip(pl, split)) for pl in in_pl)
    out_pl = tuple(placements(s, mesh) for s in out_specs)
    return local_map(fn, out_placements=out_pl, in_placements=tuple(in_pl),
                     in_grad_placements=grad_pl, device_mesh=mesh)(*placed)


def batch_spec(mesh, shape: tuple[int, ...]) -> P:
    """``P(dp, None, ...)`` fitted to ``shape`` on ``mesh``: dimension 0
    over the data-parallel axes where they divide it, the rest
    replicated."""
    return fit(known_axes(P(DP_AXES), mesh), shape, mesh)


def head_spec(mesh, shape: tuple[int, ...], head_dim: int) -> P:
    """``P(dp, ..., "model" at head_dim, ...)`` fitted to ``shape`` on
    ``mesh``: the batch (dimension 0) over the data-parallel axes and the
    heads (or channels) over "model", each dropped where it does not
    divide."""
    entries = [None] * len(shape)
    entries[0] = DP_AXES
    entries[head_dim] = "model"
    return fit(known_axes(P(*entries), mesh), shape, mesh)


def shard_mesh(num_shards: int, axis: str = "shards", devices=None):
    """1-D mesh for sharding a ``num_shards``-long leading axis.

    Takes the largest prefix of ``devices`` (the ranks of the default
    process group unless given) whose size divides ``num_shards``, so
    every rank holds ``num_shards / d`` shards; on one rank that is a
    one-rank mesh (the collectives are the identity).  The process
    group must be initialised; every rank of it calls this."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("shard_mesh needs an initialised process group")
    ranks = list(devices if devices is not None
                 else range(dist.get_world_size()))
    d = 1
    for k in range(1, min(num_shards, len(ranks)) + 1):
        if num_shards % k == 0:
            d = k
    return DeviceMesh(mesh_device_type(), torch.tensor(ranks[:d]),
                      mesh_dim_names=(axis,))


def mesh_device_type() -> str:
    """``"cuda"`` under an NCCL default group, else ``"cpu"`` (gloo and
    the fake group)."""
    import torch.distributed as dist

    return "cuda" if dist.get_backend() == "nccl" else "cpu"


_AMBIENT: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_mesh", default=None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the ambient mesh of :func:`constrain` (the
    reference's ``with mesh:``)."""
    token = _AMBIENT.set(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.reset(token)


def known_axes(spec, mesh) -> P:
    """``spec`` without the axis names ``mesh`` lacks."""
    sizes = _axis_sizes(mesh)

    def known(entry):
        kept = tuple(n for n in _names(entry) if n in sizes)
        if not kept:
            return None
        return kept[0] if len(kept) == 1 else kept

    return P(*(known(e) for e in tuple(spec)))


def constrain(x, spec, allow_uneven: bool = False):
    """The reference's ``with_sharding_constraint`` against the ambient
    mesh: ``x`` redistributed to ``spec``.

    The identity outside :func:`use_mesh` or when ``x`` is not a
    DTensor.  Axis names the mesh lacks are dropped.
    ``allow_uneven=True`` keeps every other name, dividing or not
    (DTensor splits unevenly, ``torch.chunk`` style); otherwise the spec
    is :func:`fit` to ``x`` first.  The gradient flowing back through
    the result is placed by the same spec."""
    mesh = _AMBIENT.get()
    if mesh is None or not is_dtensor(x):
        return x
    spec = known_axes(spec, mesh)
    if not allow_uneven:
        spec = fit(spec, tuple(x.shape), mesh)
    pl = placements(spec, mesh)
    # the second redistribute (no-op forward) places the gradient too,
    # as the transpose of JAX's sharding constraint constrains the
    # cotangent
    return x.redistribute(mesh, pl).redistribute(mesh, pl)
