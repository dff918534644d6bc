#!/usr/bin/env python3
"""Cold times of the row-gather kernels of ``repro_torch`` at the main
path's shapes, across source trees, on one NVIDIA GPU.

    python3 tools/time_gather.py TREE [TREE ...] [--rounds N]

Each TREE is the root of a checkout of this repository (its ``src`` is
imported; its kernels are built into its own ``build`` directory).  For
each round the trees are timed in order and then in reverse order
(A B ... B A), one process each, so a drift of the card or the host
falls on every tree alike.  A process times, after an L2 flush, one
launch of:

* ``fused_predicate_banked``: Q2 of ``chip_smoke.py`` (two ranges,
  32 bits / 8 chunks) over the [2, R, 2^19] LUT of its 2^25-record,
  8-feature table;
* ``fused_compound_banked``: its 3-term compound (Q1 or Q2 and Q3);
* ``clutch_merge`` at 8/1, 16/2 and 32/5 over a 2^25-record column;
* ``clutch_merge_banked``: two banks of 2^24 at 32/5, the second
  always true;

and beside them ``x.amax(dim=0)`` over the rows Q2 reads, laid out
contiguously, which moves with the state of the card and not with the
kernel.  The LUT's contents are random: the kernels' work does not
depend on them.  A JSON object per process goes to standard error; the
last line of standard output holds, per tree and kernel, the median
over the tree's processes of each process's median over ``--reps``
launches.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np


def cold_ms(torch, fn, flush, reps):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        flush.max()
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return float(np.median(times))


def child(tree: Path, reps: int) -> dict:
    sys.path.insert(0, str(tree / "src"))
    import torch

    import repro_torch.kernels as K
    from repro_torch.apps.predicate import Table
    from repro_torch.core.encoding import make_plan
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_session import FusedTableExec
    from repro_torch.pud import queries as Q

    cuda = torch.device("cuda")
    gen = torch.Generator(cuda).manual_seed(0)

    def words(*shape):
        return torch.randint(-2 ** 31, 2 ** 31, shape, generator=gen,
                             dtype=torch.int32, device=cuda)

    out = {}
    flush = torch.ones(64 << 20, dtype=torch.int32, device=cuda)
    # the table path: row indices from a small table of the same plan
    ex = FusedTableExec(Table.generate(4096, 32, num_features=8, seed=0),
                        2, 8, device="cpu")
    c, r = ex.num_chunks, ex.lut.shape[1]
    lut = words(2, r, 2 ** 19)
    mx = (1 << 32) - 1
    qa = dict(fi=0, x0=mx // 8, x1=mx // 2, fj=1, y0=mx // 4,
              y1=3 * mx // 4)
    qb = dict(fi=2, x0=mx // 3, x1=mx, fj=5, y0=0, y1=mx // 5)
    q2 = np.concatenate([ex._range_idx(0, qa["x0"], qa["x1"]),
                         ex._range_idx(1, qa["y0"], qa["y1"])])
    d2 = torch.from_numpy(q2).to(cuda)
    out["fused_predicate_banked"] = cold_ms(
        torch, lambda: K.fused_predicate_banked(lut, d2, c, 2, False),
        flush, reps)
    cq = Q.Compound((Q.Q1(fi=6, x0=0, x1=mx // 16), Q.Q2(**qa),
                     Q.Q3(**qb)), ("or", "and"), count=True)
    ranges, t_nr, t_disj = [], [], []
    for term in cq.terms:
        tk, *tp = term.to_tuple()
        rr = [tuple(tp)] if tk == "q1" else [tuple(tp[:3]), tuple(tp[3:])]
        ranges += rr
        t_nr.append(len(rr))
        t_disj.append(tk == "q3")
    shape = (tuple(t_nr), tuple(t_disj), tuple(o == "or" for o in cq.ops))
    dc = torch.from_numpy(
        np.concatenate([ex._range_idx(*x) for x in ranges])).to(cuda)
    out["fused_compound_banked"] = cold_ms(
        torch, lambda: K.fused_compound_banked(lut, dc, c, *shape), flush,
        reps)
    rows = len({int(i) for o in (0, 2 * c, 4 * c, 6 * c)   # le[0] unread
                for i in np.r_[q2[o:o + c], q2[o + c + 1:o + 2 * c]]})
    x = torch.ones((rows, 2 * 2 ** 19), dtype=torch.int32, device=cuda)
    out["amax_q2_rows"] = cold_ms(torch, lambda: x.amax(dim=0), flush, reps)
    del lut, x

    # the merges of the front-ends
    col = torch.randint(0, 2 ** 31, (2 ** 25,), generator=gen,
                        dtype=torch.int32, device=cuda)
    for n_bits, cc in ((8, 1), (16, 2), (32, 5)):
        plan = make_plan(n_bits, cc)
        r = ops.encode_lut(col[:32], plan).shape[0]
        ml = words(r, 2 ** 20)
        lt, le = (torch.from_numpy(v).to(cuda)
                  for v in ops.resolve_indices(plan, 1 << (n_bits - 1)))
        out[f"clutch_merge {n_bits}/{cc}"] = cold_ms(
            torch, lambda: K.clutch_merge(ml, lt, le), flush, reps)
        del ml
    bl = words(2, r, 2 ** 19)
    blt, ble = (torch.from_numpy(v).to(cuda) for v in
                ops.resolve_indices_banked(plan, np.array([1 << 31, -1])))
    out["clutch_merge_banked 32/5"] = cold_ms(
        torch, lambda: K.clutch_merge_banked(bl, blt, ble), flush, reps)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+", type=Path)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.trees[0].resolve(), args.reps)))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    trees = [t.resolve() for t in args.trees]
    # build every tree's kernels first, all at once
    builds = [subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]);"
         " from repro_torch.kernels import _build; _build.build_all()",
         str(t / "src")]) for t in trees]
    if any(p.wait() for p in builds):
        print("a build failed", file=sys.stderr)
        return 1
    runs = {str(t): [] for t in trees}
    for _ in range(args.rounds):
        for t in trees + trees[::-1]:
            got = subprocess.run(
                [sys.executable, __file__, "--child", "--reps",
                 str(args.reps), str(t)],
                capture_output=True, text=True, check=True)
            res = json.loads(got.stdout.strip().splitlines()[-1])
            print(json.dumps({"tree": str(t), **res}), file=sys.stderr)
            runs[str(t)].append(res)
    summary = {t: {k: float(np.median([r[k] for r in rs])) for k in rs[0]}
               for t, rs in runs.items()}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
