"""Run one cell of the benchmark once on the card:

    python3 clutchbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (``BENCHMARK.json``) names a configuration and a mix.  Set-up
makes the inputs from the seed on the card, builds the system under
test (``repro_torch``'s ``PudSession`` on the fused backend), draws the
requests and warms up every request kind of the mix.  The window then
drives one request at a time (a closed loop, one client) until
``--seconds`` have passed and the request in flight has come back.
Once it has closed, peak memory is read, the system is freed and a
sample of the answers drawn from the seed is compared with the plain
reference.  The last line of standard output is the result, as JSON.

``--trace 0`` reports the cell's end-to-end metrics; ``--trace 1``
profiles the window and reports its per-layer metrics.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
for _p in (str(ROOT), str(ROOT / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from clutchbench import check, data, work  # noqa: E402
from clutchbench.data import derive  # noqa: E402
from clutchbench.manifest import Manifest  # noqa: E402
from clutchbench.profiling import REFILL, Window  # noqa: E402
from clutchbench.reference.forest import Forest as RefForest  # noqa: E402
from clutchbench.reference.predicates import Columns  # noqa: E402

#: top-level module names that no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def p95(values) -> float:
    """The 95th percentile by nearest rank over all ``values``."""
    v = sorted(values)
    return v[max(0, math.ceil(0.95 * len(v)) - 1)]


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


class Reservoir:
    """A uniform sample of ``k`` of the window's answers, drawn from the
    seed as they come, so that memory stays bounded."""

    def __init__(self, k: int, seed: int) -> None:
        self.k = k
        self.rng = np.random.default_rng(seed)
        self.items: list = []

    def offer(self, i: int, out) -> None:
        if i < self.k:
            self.items.append((i, out))
            return
        j = int(self.rng.integers(0, i + 1))
        if j < self.k:
            self.items[j] = (i, out)


class Requests:
    """The cell's request stream, drawn by the mix's generator: a block
    for ``pool_per_s`` requests a second of the window in set-up,
    extended block by block should the window use them up."""

    def __init__(self, gen, spec: dict, seconds: float, system) -> None:
        self.gen, self.system = gen, system
        self.block = max(1, math.ceil(spec["pool_per_s"] * seconds))
        self.plain: list = []
        self.prepared: list = []

    def extend(self) -> None:
        plain = self.gen.draw(self.block)
        self.plain += plain
        self.prepared += self.system.prepare(plain)


def window(system, reqs: Requests, seconds: float, trace: bool,
           keep: Reservoir):
    """Drive requests until ``seconds`` of the window have passed;
    returns (latencies, failures, first error, window seconds, trace
    summary).  Drawing more requests, should the pool run out, stops
    the window's clock: it is the harness's work, not the system's."""
    lat: list[float] = []
    failed, error, paused = 0, None, 0.0
    call, prepared = system.call, reqs.prepared
    with Window(trace) as win:
        i, start = 0, time.perf_counter()
        end = start + seconds
        while True:
            if i == len(prepared):
                r0 = time.perf_counter()
                with win.span(REFILL):
                    reqs.extend()
                prepared = reqs.prepared
                dt = time.perf_counter() - r0
                paused += dt
                end += dt
            req = prepared[i]
            with win.span("window.request"):
                t0 = time.perf_counter()
                try:
                    out = call(req)
                except Exception:           # an answer that never came
                    out = None
                    failed += 1
                    error = error or traceback.format_exc()
                t1 = time.perf_counter()
            lat.append(t1 - t0)
            keep.offer(i, out)
            i += 1
            if t1 >= end:
                break
    return lat, failed, error, t1 - start - paused, win.summary


def kind_of(req) -> str:
    if not isinstance(req, tuple):
        return "predict"
    if req[0] == "compound":
        return f"compound{len(req[3])}{'count' if req[1] else 'bitmap'}"
    return req[0]


def by_kind(plain: list, lat: list) -> str:
    """Each request kind's count, median and 95th percentile latency."""
    groups: dict[str, list] = {}
    for req, t in zip(plain, lat):
        groups.setdefault(kind_of(req), []).append(t * 1e3)
    return "; ".join(f"{k} n={len(v)} med={sorted(v)[len(v) // 2]:.3f} "
                     f"p95={p95(v):.3f}" for k, v in sorted(groups.items()))


def least_seconds(entry: str, plain: list, n: int, cfg: dict,
                  batch: int) -> float:
    """The least time the chip could take for the first ``n`` requests."""
    if entry == "query":
        nbytes = sum(work.query_bytes(r, cfg["records"], cfg["n_bits"],
                                      cfg["num_chunks"]) for r in plain[:n])
        return work.least_seconds(nbytes, 0.0)
    nbytes, ops = work.predict_work(batch, cfg["trees"], cfg["depth"],
                                    cfg["features"], cfg["n_bits"])
    return work.least_seconds(n * nbytes, n * ops)


def build(cfg: dict, seed: int, device):
    """(the inputs, the system under test) for the configuration."""
    from clutchbench import system as sut

    if cfg["kind"] == "table":
        columns = data.lineitem(cfg, derive(seed, 0), device)
        return columns, lambda: sut.Table(cfg, columns, device)
    arrays = data.forest(cfg, derive(seed, 0), device)
    return arrays, lambda: sut.Forest(cfg, arrays, device)


def judge(cfg: dict, spec: dict, inputs, reqs: Requests, sample: list,
          device) -> tuple[dict, dict]:
    """(the numbers compared, each beside its limit; everything the
    comparison found)."""
    limits = dict(cfg["limits"])
    if reqs.gen.entry == "query":
        cols = Columns(inputs, cfg["n_bits"], device)
        found = check.queries([(reqs.plain[i], out) for i, out in sample],
                              cols, device)
        if not any(e["query"] == "Q4" for e in spec["mix"]):
            limits.pop("avg_rel_gap", None)
    else:
        ref = RefForest(inputs["feature_idx"], inputs["thresholds"],
                        inputs["leaves"], device)
        found = check.predictions(
            [(reqs.plain[i], out) for i, out in sample], ref)
    return check.judged(found, limits), found


def run_cell(manifest: Manifest, name: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda", overrides: dict | None = None,
             t_start: float | None = None) -> tuple[dict, dict]:
    """One run of one cell: (the result object, everything the
    comparison found).  ``overrides`` (``{"config": {...}, "mix":
    {...}}``) and ``device="cpu"`` serve the CPU tests only."""
    t_start = time.perf_counter() if t_start is None else t_start
    overrides = overrides or {}
    cell = manifest.cell(name)
    cfg = {**manifest.config(cell["config"]), **overrides.get("config", {})}
    spec = {**manifest.mix(cell["traffic"]), **overrides.get("mix", {})}
    gen = manifest.generator(spec, cfg, seed, device)
    on_card = device != "cpu"
    with torch.profiler.record_function("setup.generate"):
        inputs, make = build(cfg, seed, device)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    with torch.profiler.record_function("setup.build"):
        system = make()
    reqs = Requests(gen, spec, seconds, system)
    reqs.extend()
    for req in system.prepare(gen.warmup()):
        system.call(req)
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start

    keep = Reservoir(spec["check_sample"], derive(seed, 3))
    # the request pool is the harness's: keep the collector from walking
    # it during the window
    gc.collect()
    gc.freeze()
    try:
        lat, failed, error, window_s, summary = window(
            system, reqs, seconds, trace, keep)
    finally:
        gc.unfreeze()
    n = len(lat)

    peak = torch.cuda.max_memory_allocated() if on_card else 0
    system.close()
    del system
    reqs.prepared = []
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    with torch.profiler.record_function("check"):
        numbers, found = judge(cfg, spec, inputs, reqs, keep.items, device)
    if error:
        print(f"{failed} of {n} requests raised; the first:\n{error}",
              file=sys.stderr)
    print("latency by kind (ms): " + by_kind(reqs.plain[:n], lat),
          file=sys.stderr)

    batch = spec.get("batch", 0)
    rows = n * batch
    device_info = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
        "count": 1,
        "memory_peak_bytes": int(peak),
    }
    result = {"correct": failed == 0 and check.passed(numbers),
              "attempted": n, "failed": failed}
    if not trace:
        values = {
            "scan_qps": n / window_s,
            "count_qps": n / window_s,
            "scan_p95_ms": p95(lat) * 1e3,
            "predict_rows_per_s": rows / window_s,
            "setup_s": setup_s,
        }
        metrics = {m["name"]: {"value": values[m["name"]],
                               "unit": m["unit"]}
                   for m in manifest.end_to_end(name)}
    else:
        summary.update(entry=gen.entry, requests=n, rows=rows,
                       least_s=least_seconds(gen.entry, reqs.plain, n, cfg,
                                             batch))
        metrics = {}
        for m in manifest.per_layer(name):
            v = manifest.reader(m["name"])(summary)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device_info.update(busy_s=summary["busy_s"],
                           window_s=summary["window_s"])
    result["metrics"] = metrics
    result["device"] = device_info
    if trace:
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = numbers
    return result, found


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be a whole number of at least 0")
    manifest = Manifest(ROOT / "BENCHMARK.json")
    chips = manifest.cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " found", file=sys.stderr)
        return 2
    result, found = run_cell(manifest, args.workload, args.seed,
                             args.seconds, bool(args.trace),
                             t_start=T_START)
    loaded = forbidden_modules()
    if loaded:
        print(f"the run loaded {', '.join(loaded)}; none of "
              f"{', '.join(FORBIDDEN)} may be loaded", file=sys.stderr)
        return 3
    print(f"checked {found['checked']} answers", file=sys.stderr)
    for k, v in result["checks"].items():
        print(f"{k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
