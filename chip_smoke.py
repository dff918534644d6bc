#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root

Phases (any failure exits non-zero; none is caught and passed over):

1. Build every CUDA source under ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per file, in parallel) and print the card's name and power
   limit.
2. Hold each kernel bit-exact against its plain PyTorch version on the
   card: 8/16/32-bit plans with values >= 2^31, record counts not a
   multiple of 32, word counts not a power of two, 1-3 shards, every
   index boundary (chunk values 0 and 2^k - 1, the always-true -1),
   ragged per-column plans, 1-3 compound terms.
3. Table path at full width: ``Table.generate(2**25, 32, num_features=8)``
   (33.5M records, 2 shards, 8 chunks of 4 bits: an 8.6 GB LUT) through
   ``PudSession.query`` -- Q1-Q5 and two ``Compound`` shapes, each equal
   to its NumPy reference (Q4 within 1e-9, as ``check`` holds it).
4. GBDT path: ``ObliviousForest.random(1000, 6, 28, n_bits=8)`` through
   ``PudSession.predict`` on 2^16 instances; leaf addresses exact,
   predictions bit-equal to ``assemble_leaves`` over the reference
   addresses.
5. Time each kernel, its plain version and its bound at the main path's
   shapes; print the ``kernels`` JSON line and, last, the ok line.

Launch counts are set to 0 just before each path runs and read just
after; a kernel of the path with no launch fails the run.  Progress and
a detailed JSON report (per-query wall-clock, launch counts per path,
bound inputs, peak memory) go to standard error.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, and the float32 rate
# outside the tensor cores, the highest non-tensor rate in the table --
# used for these kernels' integer logic, so the bound stays a lower bound.
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12

KERNEL_META = {
    "temporal_encode": (
        "src/repro_torch/kernels/csrc/temporal_encode.cu",
        "src/repro/kernels/temporal_encode.py:35"),
    "fused_predicate_banked": (
        "src/repro_torch/kernels/csrc/fused_query.cu",
        "src/repro/kernels/fused_query.py:162"),
    "fused_compound_banked": (
        "src/repro_torch/kernels/csrc/fused_query.cu",
        "src/repro/kernels/fused_query.py:251"),
    "gbdt_leafbits_banked": (
        "src/repro_torch/kernels/csrc/fused_query.cu",
        "src/repro/kernels/fused_query.py:323"),
}


def expect(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------- #
# Phase 2: every kernel against its plain version, small edge cases
# --------------------------------------------------------------------- #

def check_kernels(torch) -> int:
    import repro_torch.kernels as K
    from repro_torch.apps import gbdt as G
    from repro_torch.apps.predicate import Table
    from repro_torch.core.encoding import ColumnPlan, make_plan
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.fused_session import FusedGbdtExec, FusedTableExec

    cuda = torch.device("cuda")
    rng = np.random.default_rng(0)
    n_checks = 0

    def same(a, b, what):
        nonlocal n_checks
        torch.cuda.synchronize()
        expect(a.shape == b.shape and torch.equal(a.cpu(), b.cpu()), what)
        n_checks += 1

    # temporal_encode: ragged warps (W = 131), W not a power of two
    for k, w in ((1, 128), (4, 131), (7, 384), (8, 256), (12, 131)):
        v = rng.integers(0, 1 << k, (w, 32)).astype(np.int32)
        v[0, 0], v[0, 1] = 0, (1 << k) - 1
        vt = torch.from_numpy(v).to(cuda)
        same(K.temporal_encode(vt, k),
             ref.temporal_encode_ref(vt.reshape(-1), k),
             f"temporal_encode k={k} W={w}")

    # encode_lut on the card (kernel) == on the CPU (plain version)
    for n_bits, c, n in ((8, 1, 1000), (8, 2, 12001), (16, 4, 4097),
                         (32, 5, 999), (32, 8, 12001)):
        v = rng.integers(0, 1 << n_bits, n, dtype=np.uint64)
        v[:2] = [0, (1 << n_bits) - 1]
        if n_bits == 32:
            v[2] = 1 << 31
        vt = torch.from_numpy(v.astype(np.uint32).view(np.int32))
        for comp in (False, True):
            plan = make_plan(n_bits, c)
            same(ops.encode_lut(vt.to(cuda), plan, complement=comp),
                 ops.encode_lut(vt, plan, complement=comp),
                 f"encode_lut {n_bits}/{c} n={n} comp={comp}")

    # predicates and compounds over tables: uniform and ragged plans
    cases = [(8, 2, 1, None), (16, 4, 2, None), (32, 8, 3, None),
             (16, 4, 2, [ColumnPlan(16, 4), ColumnPlan(5, 2),
                         ColumnPlan(9, 3)])]
    for n_bits, c, shards, plans in cases:
        n = 5001
        widths = [p.n_bits for p in plans] if plans else [n_bits] * 3
        cols = [rng.integers(0, 1 << wb, n, dtype=np.uint64)
                for wb in widths]
        for col, wb in zip(cols, widths):
            col[:2] = [0, (1 << wb) - 1]
        if n_bits == 32:
            cols[0][2] = 1 << 31
        t = Table(n_bits, cols)
        gx = FusedTableExec(t, shards, c, plans=plans, device=cuda)
        px = FusedTableExec(t, shards, c, plans=plans, device="cpu")
        same(gx.lut, px.lut, f"table LUT {n_bits}-bit x{shards}")
        mx = (1 << n_bits) - 1
        ranges = [(0, 0, mx), (1, mx // 3, 2 * mx // 3), (2, 0, 1),
                  (0, mx - 1, mx), (1, int(rng.integers(0, mx)), mx),
                  (2, mx // 7, mx // 2)]
        for r1, r2 in zip(ranges, ranges[1:]):
            for nr, disj in ((1, False), (2, False), (2, True)):
                rr = [r1, r2][:nr]
                idx = np.concatenate([gx._range_idx(*r) for r in rr])
                got = K.fused_predicate_banked(gx.lut, idx, gx.num_chunks,
                                               nr, disj)
                want = ref.fused_predicate_banked_ref(gx.lut, idx,
                                                      gx.num_chunks, nr, disj)
                same(got[0], want[0], f"predicate bitmap {rr} {disj}")
                same(got[1], want[1], f"predicate count {rr} {disj}")
        for shape in (((1,), (False,), ()),
                      ((2, 1), (True, False), (False,)),
                      ((1, 2, 2), (False, False, True), (True, False))):
            nr = sum(shape[0])
            idx = np.concatenate([gx._range_idx(*r) for r in ranges[:nr]])
            got = K.fused_compound_banked(gx.lut, idx, gx.num_chunks, *shape)
            want = ref.fused_compound_banked_ref(gx.lut, idx, gx.num_chunks,
                                                 *shape)
            same(got[0], want[0], f"compound bitmap {shape}")
            same(got[1], want[1], f"compound count {shape}")
        # random rows anywhere in the LUT, 3 terms
        idx = rng.integers(0, gx.lut.shape[1], 5 * 4 * gx.num_chunks)
        shape = ((1, 2, 2), (False, True, False), (False, True))
        got = K.fused_compound_banked(gx.lut, idx.astype(np.int32),
                                      gx.num_chunks, *shape)
        want = ref.fused_compound_banked_ref(gx.lut, idx, gx.num_chunks,
                                             *shape)
        same(got[0], want[0], "compound bitmap, random rows")
        same(got[1], want[1], "compound count, random rows")

    # GBDT leaf bits: 8/16-bit, a narrowed plan, the always-true -1
    for n_bits, c, plan in ((8, 1, None), (16, 2, None),
                            (16, 3, ColumnPlan(10, 3))):
        f = G.ObliviousForest.random(37, 5, 6, plan.n_bits if plan
                                     else n_bits, seed=n_bits)
        f.n_bits = n_bits
        gx = FusedGbdtExec(f, c, plan=plan, device=cuda)
        X = rng.integers(0, 1 << n_bits, (70, 6), dtype=np.uint64)
        X[0], X[1] = 0, (1 << n_bits) - 1
        expect(np.array_equal(gx.leaf_addrs(X),
                              G.reference_leaf_addrs(f, X)),
               f"leaf addresses {n_bits}-bit plan={plan}")
        n_checks += 1
        a = rng.integers(-1, 1 << gx.plan.n_bits, 70 * 6).astype(np.int64)
        a[:6] = -1
        lt, le = ops.resolve_indices_banked(gx.plan, a)
        lt, le = lt.reshape(70, 6, -1), le.reshape(70, 6, -1)
        idx = np.concatenate([lt, le], axis=2).reshape(70, -1)
        same(K.gbdt_leafbits_banked(gx.lut, gx.masks, idx, gx.num_chunks, 6),
             ref.gbdt_leafbits_banked_ref(gx.lut, gx.masks,
                                          torch.from_numpy(idx).to(cuda),
                                          gx.num_chunks, 6),
             f"leaf bits with -1 lanes {n_bits}-bit")
    return n_checks


# --------------------------------------------------------------------- #
# Phases 3-4: the main path through the session
# --------------------------------------------------------------------- #

def table_queries(Q, mx: int):
    qa = dict(fi=0, x0=mx // 8, x1=mx // 2, fj=1, y0=mx // 4,
              y1=3 * mx // 4)
    qb = dict(fi=2, x0=mx // 3, x1=mx, fj=5, y0=0, y1=mx // 5)
    return [
        ("Q1", Q.Q1(fi=0, x0=mx // 8, x1=mx // 2)),
        ("Q2", Q.Q2(**qa)),
        ("Q3", Q.Q3(**qa)),
        ("Q4", Q.Q4(fk=2, **qa)),
        ("Q5", Q.Q5(fl=3, fk=2, **qa)),
        ("Compound(Q1 and Q3)", Q.Compound(
            (Q.Q1(fi=4, x0=mx // 10, x1=9 * mx // 10), Q.Q3(**qb)),
            ("and",))),
        ("Compound(Q1 or Q2 and Q3), count", Q.Compound(
            (Q.Q1(fi=6, x0=0, x1=mx // 16), Q.Q2(**qa), Q.Q3(**qb)),
            ("or", "and"), count=True)),
    ]


def run_table_path(torch, report):
    import repro_torch.kernels as K
    from repro_torch.apps.predicate import Table
    from repro_torch.pud import PudSession, queries as Q

    t0 = time.perf_counter()
    table = Table.generate(2 ** 25, 32, num_features=8, seed=0)
    report["table_generate_s"] = time.perf_counter() - t0
    session = PudSession()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    handle = session.create_table(table, name="lineitem_like")
    torch.cuda.synchronize()
    report["table_build_s"] = time.perf_counter() - t0
    jobs = []
    for name, q in table_queries(Q, (1 << 32) - 1):
        job = session.query(handle, q)
        jobs.append((name, q, job))
    counts = K.launch_counts()
    ex = session.executor(handle)
    report["table"] = {
        "records": table.num_records, "n_bits": 32, "features": 8,
        "shards": ex.num_shards, "chunks": ex.num_chunks,
        "lut_shape": list(ex.lut.shape),
        "lut_gb": ex.lut.numel() * 4 / 1e9,
        "launches": counts,
        "queries": {},
    }
    for name, q, job in jobs:
        want = q.reference(table)
        got = job.result
        if isinstance(want, np.ndarray):
            expect(np.array_equal(got, want), f"{name} bitmap")
            summary = int(got.sum())
        else:
            expect(q.check(table, got), f"{name}: {got} vs {want}")
            summary = got
        report["table"]["queries"][name] = {
            "wallclock_ms": job.wallclock_ns / 1e6, "result": summary}
    for k in ("temporal_encode", "fused_predicate_banked",
              "fused_compound_banked"):
        expect(counts[k] > 0, f"{k} not launched on the table path")
    return session, handle, counts


def run_gbdt_path(torch, report):
    import repro_torch.kernels as K
    from repro_torch.apps import gbdt as G
    from repro_torch.pud import PudSession

    forest = G.ObliviousForest.random(num_trees=1000, depth=6,
                                      num_features=28, n_bits=8, seed=0)
    X = np.random.default_rng(1).integers(0, 256, (2 ** 16, 28),
                                          dtype=np.uint64)
    session = PudSession()
    K.reset_launch_counts()
    handle = session.load_forest(forest, name="higgs_like")
    job = session.predict(handle, X)
    counts = K.launch_counts()
    for k in ("temporal_encode", "gbdt_leafbits_banked"):
        expect(counts[k] > 0, f"{k} not launched on the GBDT path")
    ex = session.executor(handle)
    # reference_leaf_addrs returns a Fortran-ordered array, and NumPy's
    # float32 sum in assemble_leaves rounds differently along a strided
    # axis; the port and the reference's executors both hold C-ordered
    # addresses, so the bit-exact check feeds C-ordered ones
    addrs = np.ascontiguousarray(np.concatenate(
        [G.reference_leaf_addrs(forest, X[i:i + 8192])
         for i in range(0, X.shape[0], 8192)]))
    expect(np.array_equal(ex.leaf_addrs(X), addrs), "leaf addresses")
    expect(np.array_equal(job.result,
                          G.assemble_leaves(forest.leaves, addrs)),
           "predictions bit-equal to assemble_leaves")
    # reference_predict sums the 1000 trees in another order, so float32
    # rounding differs: agreement within 1e-3 is all it can give
    want = G.reference_predict(forest, X)
    err = float(np.abs(job.result - want).max())
    expect(err <= 1e-3, f"predictions vs reference_predict: {err}")
    report["gbdt"] = {
        "trees": 1000, "depth": 6, "features": 28, "n_bits": 8,
        "instances": X.shape[0], "chunks": ex.num_chunks,
        "lut_shape": list(ex.lut.shape),
        "masks_shape": list(ex.masks.shape),
        "predict_wallclock_ms": job.wallclock_ns / 1e6,
        "max_abs_err_vs_reference_predict": err,
        "launches": counts,
    }
    return session, handle, X, counts


# --------------------------------------------------------------------- #
# Phase 5: times and bounds at the main path's shapes
# --------------------------------------------------------------------- #

def median_ms(torch, fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return float(np.median(times))


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_OPS_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def max_abs_err(torch, a, b) -> int:
    torch.cuda.synchronize()
    if a.shape != b.shape:
        raise RuntimeError(f"shapes differ: {a.shape} vs {b.shape}")
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def read_rows(idx: np.ndarray, c: int, n_ranges: int) -> int:
    """Distinct LUT rows a predicate reads (``le[0]`` of a side is never
    read)."""
    rows = set()
    for rix in range(n_ranges):
        for side in (0, 2 * c):
            o = rix * 4 * c + side
            rows.update(int(i) for i in idx[o:o + c])
            rows.update(int(i) for i in idx[o + c + 1:o + 2 * c])
    return len(rows)


def measure(torch, table_ex, gbdt_ex, X, launches, report):
    import repro_torch.kernels as K
    from repro_torch.kernels import ops, ref
    from repro_torch.pud import queries as Q

    cuda = torch.device("cuda")
    rows = []

    def entry(name, got, want, ms, plain_ms, nbytes, nops, extra=None):
        b_ms, b_by = bound(nbytes, nops)
        err = 0
        for g, w in zip(got, want):
            err = max(err, max_abs_err(torch, g, w))
        expect(err == 0, f"{name} disagrees with its plain version")
        src, rep = KERNEL_META[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": rep, "launches": launches[name],
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": None})
        if extra:
            report.setdefault("bounds", {})[name] = extra

    # temporal_encode: one 4-bit chunk of one table shard's column
    w = table_ex.lut.shape[2]
    k = table_ex._cplans[0].widths[0]
    vals = torch.randint(0, 1 << k, (w, 32), dtype=torch.int32, device=cuda)
    r = (1 << k) - 1
    got = K.temporal_encode(vals, k)
    want = ref.temporal_encode_ref(vals.reshape(-1), k)
    entry("temporal_encode", [got], [want],
          median_ms(torch, lambda: K.temporal_encode(vals, k)),
          median_ms(torch, lambda: ref.temporal_encode_ref(
              vals.reshape(-1), k), reps=5),
          w * 32 * 4 + r * w * 4, r * w * 32,
          {"shape": [w, 32], "k": k})

    # fused_predicate_banked: Q2's two ranges over the full stacked LUT
    lut = table_ex.lut
    s, _, w = lut.shape
    c = table_ex.num_chunks
    mx = (1 << 32) - 1
    q2 = table_queries(Q, mx)[1][1]
    idx = np.concatenate([table_ex._range_idx(q2.fi, q2.x0, q2.x1),
                          table_ex._range_idx(q2.fj, q2.y0, q2.y1)])
    didx = torch.from_numpy(idx).to(cuda)
    got = K.fused_predicate_banked(lut, didx, c, 2, False)
    want = ref.fused_predicate_banked_ref(lut, idx, c, 2, False)
    n_rows = read_rows(idx, c, 2)
    maj_ops = 2 * 2 * (c - 1) * 5 + 2 * 2
    entry("fused_predicate_banked", got, want,
          median_ms(torch, lambda: K.fused_predicate_banked(
              lut, didx, c, 2, False)),
          median_ms(torch, lambda: ref.fused_predicate_banked_ref(
              lut, idx, c, 2, False), reps=5),
          n_rows * s * w * 4 + s * w * 4 + idx.nbytes,
          s * w * (maj_ops + 1),
          {"lut_shape": list(lut.shape), "rows_read": n_rows})

    # fused_compound_banked: the 3-term compound of the table path
    cq = table_queries(Q, mx)[6][1]
    ranges, t_nr, t_disj = [], [], []
    for term in cq.terms:
        tk, *tp = term.to_tuple()
        rr = [tuple(tp)] if tk == "q1" else [tuple(tp[:3]), tuple(tp[3:])]
        ranges += rr
        t_nr.append(len(rr))
        t_disj.append(tk == "q3")
    conn = tuple(op == "or" for op in cq.ops)
    idx = np.concatenate([table_ex._range_idx(*r) for r in ranges])
    didx = torch.from_numpy(idx).to(cuda)
    shape = (tuple(t_nr), tuple(t_disj), conn)
    got = K.fused_compound_banked(lut, didx, c, *shape)
    want = ref.fused_compound_banked_ref(lut, idx, c, *shape)
    n_rows = read_rows(idx, c, len(ranges))
    entry("fused_compound_banked", got, want,
          median_ms(torch, lambda: K.fused_compound_banked(
              lut, didx, c, *shape)),
          median_ms(torch, lambda: ref.fused_compound_banked_ref(
              lut, idx, c, *shape), reps=5),
          n_rows * s * w * 4 + s * w * 4 + idx.nbytes,
          s * w * (len(ranges) * (2 * (c - 1) * 5 + 1) + len(ranges)),
          {"terms": [list(x) for x in shape], "rows_read": n_rows})

    # gbdt_leafbits_banked: the 2^16-instance batch
    glut, masks = gbdt_ex.lut, gbdt_ex.masks
    gc, f = gbdt_ex.num_chunks, gbdt_ex.forest.num_features
    cols = []
    for fi in range(f):
        cols += list(ops.resolve_indices_banked(
            gbdt_ex.plan, X[:, fi].astype(np.int64)))
    gidx = torch.from_numpy(np.concatenate(cols, axis=1)).to(cuda)
    got = K.gbdt_leafbits_banked(glut, masks, gidx, gc, f)
    want = ref.gbdt_leafbits_banked_ref(glut, masks, gidx, gc, f)
    b, gw = gidx.shape[0], glut.shape[1]
    dram = (glut.numel() + masks.numel() + gidx.numel() + b * gw) * 4
    l2 = b * gw * 4 * f * (2 * gc - 1 + 1)
    entry("gbdt_leafbits_banked", [got], [want],
          median_ms(torch, lambda: K.gbdt_leafbits_banked(
              glut, masks, gidx, gc, f)),
          median_ms(torch, lambda: ref.gbdt_leafbits_banked_ref(
              glut, masks, gidx, gc, f), reps=5),
          dram, b * gw * f * ((gc - 1) * 5 + 2),
          {"lut_shape": list(glut.shape), "masks_shape": list(masks.shape),
           "idx_shape": list(gidx.shape), "dram_bytes": dram,
           "l2_bytes": l2})
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is False")
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        log(f"chip_smoke: no repro_torch sources under {SRC}")
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import _build

    report: dict = {}
    t0 = time.perf_counter()
    _build.build_all()
    report["build_s"] = time.perf_counter() - t0
    card = card_line()
    log(f"phase 1: built in {report['build_s']:.1f} s on {card}")

    report["kernel_checks"] = check_kernels(torch)
    log(f"phase 2: {report['kernel_checks']} kernel checks bit-exact")

    tsession, thandle, tcounts = run_table_path(torch, report)
    log(f"phase 3: table path ok {json.dumps(report['table']['queries'])}")
    gsession, ghandle, X, gcounts = run_gbdt_path(torch, report)
    log(f"phase 4: GBDT path ok, predict "
        f"{report['gbdt']['predict_wallclock_ms']:.1f} ms")

    launches = {k: tcounts[k] + gcounts[k] for k in tcounts}
    rows = measure(torch, tsession.executor(thandle),
                   gsession.executor(ghandle), X, launches, report)
    report["kernels"] = rows
    report["card"] = card
    report["device"] = torch.cuda.get_device_name(0)
    report["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    report["total_s"] = time.perf_counter() - t0
    log("report " + json.dumps(report))

    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
