"""Card-resident executors behind :class:`repro_torch.pud.PudSession`.

* :class:`FusedTableExec` -- Q1-Q5 and compound predicates over a
  record-sharded table.  Every feature's normal and complement LUT
  planes for every record shard are stacked into one ``[shards, rows,
  words]`` tensor on the device at build time; a query is then ONE
  :func:`~repro_torch.kernels.fused_query.fused_predicate_banked` (or
  ``fused_compound_banked``) launch over every shard, whose per-shard
  popcounts are summed on the device (the reference's ``shard_map`` +
  ``psum`` becomes the kernel's shard axis plus a device-side sum).
* :class:`FusedGbdtExec` -- GBDT inference: the forest's threshold LUT
  and one-hot feature masks stay on the device and one
  :func:`~repro_torch.kernels.fused_query.gbdt_leafbits_banked` launch
  computes every instance's leaf-address bitmap.

Both mirror the reference package's ``kernels/fused_session.py`` layout
byte for byte (ragged per-column blocks, identity-lane padding up to
``C_max``, gt-side saturation and the all-ones lt-side past a narrow
column's max), so the same inputs give the same LUT and row indices.
Bitmaps, counts and leaf addresses are exact integer math on the
device; the few float aggregates (Q4/Q5 averages, GBDT leaf sums) are
finished on the host with the reference's NumPy expressions.

Row indices are resolved on the host (memoized per ``(plan, scalar)``)
and passed as kernel operands, so one kernel serves every (feature,
scalar) combination; ``launch_counts`` counts launches per query kind
``(num_ranges, disjunction)`` and per compound shape.

Over a 1-D mesh (``mesh=``, e.g.
:func:`repro_torch.dist.sharding.shard_mesh`; every rank of it builds
the executor and runs every job) each of its ``d`` ranks holds its
``num_shards / d`` record shards of the LUT and launches the same
kernels on its block: the reference's ``shard_map``.  Its ``psum``
becomes an all-reduce of the count, and the bitmap comes back through
an all-gather of the ranks' blocks; the forest's instances are split
over the ranks and their leaf addresses all-gathered.  A failing
collective raises; nothing falls back to one rank.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.apps.gbdt import assemble_leaves
from repro_torch.convert import words_to_numpy
from repro_torch.core.encoding import ChunkPlan, ColumnPlan, make_plan

from .common import SUBLANES, pack_bits, resolve_device, round_up, unpack_bits
from .fused_query import (
    fused_compound_banked,
    fused_predicate_banked,
    gbdt_leafbits_banked,
)
from .ops import (
    encode_lut,
    lut_offsets,
    lut_rows,
    resolve_indices,
    resolve_indices_banked,
)


def _mesh_group(mesh):
    """(this rank's index on a 1-D mesh, its size, its process group)."""
    if mesh.ndim != 1:
        raise ValueError(f"the fused executors take a 1-D mesh, got "
                         f"{mesh.ndim} dimensions")
    if mesh.get_coordinate() is None:
        raise ValueError("this rank is not in the executor's mesh")
    return mesh.get_local_rank(), mesh.size(), mesh.get_group()


def _all_gather(t: torch.Tensor, mesh) -> torch.Tensor:
    """The ranks' ``t`` (equal shapes) concatenated along dim 0 in rank
    order."""
    import torch.distributed as dist

    _, d, group = _mesh_group(mesh)
    if d == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(d)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts)


def _all_reduce_sum(t: torch.Tensor, mesh) -> torch.Tensor:
    import torch.distributed as dist

    _, d, group = _mesh_group(mesh)
    if d > 1:
        dist.all_reduce(t, group=group)
    return t


class FusedTableExec:
    """Q1-Q5 and compound predicates over a record-sharded table.

    ``table`` is duck-typed (``n_bits``, ``features``, ``num_records``).
    Records shard like the reference's ``QueryBatchExecutor``: ``per =
    ceil(n / num_shards)`` contiguous records per shard, so bitmap order
    is table order.  Padding columns encode ``B = 0``: the gt-side of
    every range is 0 there, so popcounts need no masking.  With ``mesh``
    (1-D, its size dividing ``num_shards``) this rank's LUT holds its
    contiguous block of the shards, on the mesh's device type."""

    def __init__(self, table, num_shards: int, num_chunks: int,
                 plans=None, device=None, mesh=None) -> None:
        self.mesh = mesh
        shard_lo, shard_hi = 0, num_shards
        if mesh is not None:
            rank, d, _ = _mesh_group(mesh)
            if num_shards % d:
                raise ValueError(f"{num_shards} shards do not divide over "
                                 f"{d} ranks")
            shard_lo = rank * (num_shards // d)
            shard_hi = shard_lo + num_shards // d
            device = mesh.device_type
        self.device = resolve_device(device)
        self.table = table
        self.plan: ChunkPlan = make_plan(table.n_bits, num_chunks)
        self.num_features = len(table.features)
        self.num_shards = num_shards
        self.mx = (1 << table.n_bits) - 1
        #: per-column plans; uniform ``(table.n_bits, num_chunks)`` for
        #: every feature when none are supplied
        self.plans = (tuple(plans) if plans is not None else tuple(
            ColumnPlan(table.n_bits, self.plan.num_chunks)
            for _ in table.features))
        if len(self.plans) != self.num_features:
            raise ValueError(
                f"need one ColumnPlan per feature: got {len(self.plans)} "
                f"plans for {self.num_features} features")
        if plans is not None:
            for i, (p, f) in enumerate(zip(self.plans, table.features)):
                if p.n_bits > table.n_bits:
                    raise ValueError(
                        f"column {i}: plan width {p.n_bits} exceeds the "
                        f"table's declared {table.n_bits} bits")
                arr = np.asarray(f, np.uint64)
                if arr.size and int(arr.max()) > p.max_value:
                    raise ValueError(
                        f"column {i}: values reach {int(arr.max())}, "
                        f"which overflows the plan's {p.n_bits}-bit "
                        "width")
        # kernels run at the max chunk count; narrower features' index
        # rows pad up to it with in-block identity lanes
        self.num_chunks = max(p.num_chunks for p in self.plans)
        self._cplans = [p.chunk_plan for p in self.plans]
        n = table.num_records
        self.per = math.ceil(n / num_shards)
        # Per shard: every feature's normal block, then every feature's
        # complement block; blocks are ragged (each as tall as its own
        # plan's planes + 2 constant rows, padded to 8).
        heights = [lut_rows(cp) for cp in self._cplans] * 2
        base = np.concatenate([[0], np.cumsum(heights)]).tolist()
        self._base_n = base[:self.num_features]
        self._base_c = base[self.num_features:2 * self.num_features]
        self.r_pad = base[-1] // (2 * self.num_features)
        words = round_up(-(-self.per // 32), 128)
        self.lut = torch.empty((shard_hi - shard_lo, base[-1], words),
                               dtype=torch.int32, device=self.device)
        for s in range(shard_lo, shard_hi):
            lo = s * self.per
            for f, (col, cp) in enumerate(zip(table.features, self._cplans)):
                v = np.zeros(self.per, np.uint32)
                chunk = np.asarray(col[lo:lo + self.per], np.uint64)
                v[:chunk.shape[0]] = chunk.astype(np.uint32)
                vt = torch.from_numpy(v.view(np.int32)).to(self.device)
                for b, comp in ((self._base_n[f], False),
                                (self._base_c[f], True)):
                    self.lut[s - shard_lo, b:b + heights[f]] = encode_lut(
                        vt, cp, complement=comp)
        #: kernel launches per query kind / compound shape
        self.launch_counts: dict[tuple, int] = {}
        self._idx_cache: dict[tuple, np.ndarray] = {}

    def _count(self, key: tuple) -> None:
        self.launch_counts[key] = self.launch_counts.get(key, 0) + 1

    # ---------------------------- index plumbing ----------------------- #
    def _range_idx(self, fi: int, x0: int, x1: int) -> np.ndarray:
        """Algorithm 1 row indices for ``x0 < f_fi < x1`` in the stacked
        LUT: gt-side on feature ``fi``'s normal block, lt-side on its
        complement block with scalar ``MAX_f - x1`` (``B < x1 <=> MAX_f
        - x1 < MAX_f - B``), ``MAX_f`` being the feature's own plan max.
        The gt scalar saturates to ``MAX_f``; ``x1 > MAX_f`` resolves
        the whole lt-side to the complement block's constant-one row.
        Narrower features pad their ``C_f`` index rows up to ``C_max``
        with in-block identity lanes ``(zero_row, one_row)``."""
        key = (fi, x0, x1)
        idx = self._idx_cache.get(key)
        if idx is None:
            plan = self._cplans[fi]
            mx_f = self.plans[fi].max_value
            pad = self.num_chunks - plan.num_chunks
            _, zero, one = lut_offsets(plan)
            bn, bc = self._base_n[fi], self._base_c[fi]

            def lanes(lt, le, b):
                lt = np.concatenate([lt, np.full(pad, zero, np.int32)])
                le = np.concatenate([le, np.full(pad, one, np.int32)])
                return [lt + np.int32(b), le + np.int32(b)]

            gt = lanes(*resolve_indices(plan, min(x0, mx_f)), bn)
            if x1 > mx_f:
                allc = np.full(self.num_chunks, one, np.int32)
                lt = [allc + np.int32(bc), allc + np.int32(bc)]
            else:
                lt = lanes(*resolve_indices(plan, mx_f - x1), bc)
            idx = np.concatenate(gt + lt).astype(np.int32)
            self._idx_cache[key] = idx
        return idx

    def _predicate(self, ranges: list[tuple[int, int, int]],
                   disjunction: bool):
        idx = np.concatenate([self._range_idx(*r) for r in ranges])
        bm, cnt = fused_predicate_banked(self.lut, idx, self.num_chunks,
                                         len(ranges), disjunction)
        self._count((len(ranges), disjunction))
        return bm, self._total(cnt)

    def _total(self, cnt: torch.Tensor) -> torch.Tensor:
        """The shards' counts summed (over the mesh: an all-reduce)."""
        total = cnt.sum()
        if self.mesh is not None:
            total = _all_reduce_sum(total, self.mesh)
        return total

    def _bitmap(self, bm: torch.Tensor) -> np.ndarray:
        """[S, W] packed words (this rank's block of them on a mesh,
        all-gathered) -> bool [num_records] in table order."""
        if self.mesh is not None:
            bm = _all_gather(bm, self.mesh)
        bits = unpack_bits(words_to_numpy(bm), self.per)      # [S, per]
        return bits.reshape(-1)[: self.table.num_records].astype(bool)

    # ------------------------------- queries --------------------------- #
    def run(self, queries: list[tuple]) -> list:
        """Execute a batch of query wire tuples (``Q*.to_tuple()``);
        one result per query."""
        return [self._one(q) for q in queries]

    def _one(self, q: tuple):
        name, *p = q
        if name == "q1":
            bm, _ = self._predicate([tuple(p)], False)
            return self._bitmap(bm)
        if name == "q2":
            fi, x0, x1, fj, y0, y1 = p
            bm, _ = self._predicate([(fi, x0, x1), (fj, y0, y1)], False)
            return self._bitmap(bm)
        if name == "q3":
            fi, x0, x1, fj, y0, y1 = p
            _, total = self._predicate([(fi, x0, x1), (fj, y0, y1)], True)
            return int(total)
        if name == "q4":
            fk, fi, x0, x1, fj, y0, y1 = p
            bm, _ = self._predicate([(fi, x0, x1), (fj, y0, y1)], False)
            # host-side float finish, the reference's expression
            vals = self.table.features[fk][self._bitmap(bm)]
            return float(vals.mean()) if vals.size else 0.0
        if name == "q5":
            fl, fk, fi, x0, x1, fj, y0, y1 = p
            bm, _ = self._predicate([(fi, x0, x1), (fj, y0, y1)], True)
            vals = self.table.features[fk][self._bitmap(bm)]
            avg = int(vals.mean()) if vals.size else 0
            hi = min(2 * avg, self.mx)
            if avg >= hi:
                return 0
            # phase 2: the scalars exist only after phase 1's host finish
            _, total = self._predicate([(fl, avg, hi)], False)
            return int(total)
        if name == "compound":
            # (count, merge, ops, terms); `merge` picks the reference
            # machine's in-DRAM vs host combine -- one launch computes
            # the same result either way, so it is accepted and ignored
            count, _merge_mode, ops, terms = p
            ranges: list[tuple[int, int, int]] = []
            t_nr: list[int] = []
            t_disj: list[bool] = []
            for term in terms:
                tk, *tp = term
                if tk == "q1":
                    ranges.append(tuple(tp))
                    t_nr.append(1)
                    t_disj.append(False)
                elif tk in ("q2", "q3"):
                    fi, x0, x1, fj, y0, y1 = tp
                    ranges += [(fi, x0, x1), (fj, y0, y1)]
                    t_nr.append(2)
                    t_disj.append(tk == "q3")
                else:
                    raise ValueError(f"unsupported compound term {tk!r}")
            conn = tuple(op == "or" for op in ops)
            idx = np.concatenate([self._range_idx(*r) for r in ranges])
            bm, cnt = fused_compound_banked(
                self.lut, idx, self.num_chunks, tuple(t_nr), tuple(t_disj),
                conn)
            self._count(("compound", tuple(t_nr), tuple(t_disj), conn))
            return int(self._total(cnt)) if count else self._bitmap(bm)
        raise ValueError(f"unknown query {name!r}")


class FusedGbdtExec:
    """GBDT leaf addresses for a whole batch in one kernel launch.

    ``forest`` is duck-typed (``thresholds``, ``feature_idx``,
    ``leaves``, ``n_bits``, ``num_features``, ``num_trees``, ``depth``).
    ``plan`` (a :class:`ColumnPlan`) narrows the threshold LUT to the
    plan's width; instance values then clamp to the plan max (``v <
    threshold`` keeps its truth value, every threshold fitting the
    plan).  Predictions go through :func:`assemble_leaves`, bit-exact
    with the reference.  With ``mesh`` (1-D) every rank holds the LUT
    and masks and computes its contiguous block of the instances (the
    batch padded to a multiple of the ranks with the first instance, as
    the reference pads it), and the addresses are all-gathered."""

    def __init__(self, forest, num_chunks: int, plan=None,
                 device=None, mesh=None) -> None:
        self.mesh = mesh
        if mesh is not None:
            _mesh_group(mesh)
            device = mesh.device_type
        self.device = resolve_device(device)
        self.forest = forest
        thr = np.asarray(forest.thresholds, np.uint64).reshape(-1)
        if plan is not None:
            if thr.size and int(thr.max()) > plan.max_value:
                raise ValueError(
                    f"thresholds reach {int(thr.max())}, which overflows "
                    f"the plan's {plan.n_bits}-bit width")
            self.plan = plan.chunk_plan
            self.mx = plan.max_value
            self._clamp = True
        else:
            self.plan = make_plan(forest.n_bits, num_chunks)
            self.mx = (1 << forest.n_bits) - 1
            self._clamp = False
        self.num_chunks = self.plan.num_chunks
        self.n_nodes = forest.num_trees * forest.depth
        self.lut = encode_lut(
            torch.from_numpy(thr.astype(np.uint32).view(np.int32)).to(
                self.device), self.plan)
        f = forest.num_features
        flat_feat = np.asarray(forest.feature_idx).reshape(-1)
        mask_bits = (flat_feat[None, :] ==
                     np.arange(f)[:, None]).astype(np.uint8)
        words = pack_bits(mask_bits)                     # [F, ceil(n/32)]
        f_pad, w = round_up(f, SUBLANES), int(self.lut.shape[1])
        masks = np.zeros((f_pad, w), np.uint32)
        masks[:f, :words.shape[1]] = words
        self.masks = torch.from_numpy(masks.view(np.int32)).to(self.device)
        # node n's bit: word n // 32, bit n % 32 (depth-major in a tree)
        nodes = torch.arange(self.n_nodes, device=self.device)
        self._node_word = (nodes // 32).view(forest.num_trees, forest.depth)
        self._node_bit = (nodes % 32).view(forest.num_trees, forest.depth)
        #: kernel launches, under the single key ``"gbdt"``
        self.launch_counts: dict[str, int] = {}

    def leaf_addrs(self, X: np.ndarray) -> np.ndarray:
        """[B, F] quantized instances -> [B, T] int32 leaf addresses
        (exact; the whole device half of inference)."""
        forest, plan = self.forest, self.plan
        X = np.asarray(X)
        if self._clamp:
            X = np.minimum(X.astype(np.int64), self.mx)
        b = X.shape[0]
        if self.mesh is not None:
            rank, n_ranks, _ = _mesh_group(self.mesh)
            b_pad = round_up(max(b, 1), n_ranks)
            if b_pad != b:
                X = np.concatenate([X, np.repeat(X[:1], b_pad - b, axis=0)])
            per = b_pad // n_ranks
            X = X[rank * per:(rank + 1) * per]
        cols = []
        for f in range(forest.num_features):
            lt, le = resolve_indices_banked(plan, X[:, f].astype(np.int64))
            cols += [lt, le]
        idx = np.concatenate(cols, axis=1).astype(np.int32)
        bm = gbdt_leafbits_banked(self.lut, self.masks, idx,
                                  self.num_chunks, forest.num_features)
        self.launch_counts["gbdt"] = self.launch_counts.get("gbdt", 0) + 1
        # addr = sum_d bit(t, d) << (D - 1 - d), one depth level at a time
        addrs = torch.zeros((X.shape[0], forest.num_trees),
                            dtype=torch.int32, device=self.device)
        for d in range(forest.depth):
            bit = (bm[:, self._node_word[:, d]] >> self._node_bit[:, d]) & 1
            addrs = (addrs << 1) | bit
        if self.mesh is not None:
            addrs = _all_gather(addrs, self.mesh)[:b]
        return addrs.to(torch.int32).cpu().numpy()

    def infer(self, X: np.ndarray) -> np.ndarray:
        """[B, F] -> [B] float32 predictions, bit-exact with the
        reference (shared host-side leaf assembly)."""
        X = np.asarray(X)
        if X.shape[0] == 0:
            return np.empty((0,), np.float32)
        return assemble_leaves(self.forest.leaves, self.leaf_addrs(X))
