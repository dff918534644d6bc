"""Run one cell of the benchmark once on the card:

    python3 clutchbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (``BENCHMARK.json``) names a configuration and a mix; the
configuration's ``kind`` names ``kinds/<kind>.py``, which makes the
inputs from the seed and builds the system under test from them
(``repro_torch``'s ``PudSession`` for a table or a forest, its
``ServeEngine`` for a language model).  Set-up draws the requests and
warms up every request kind of the mix.  The window then drives calls
of the system, each taking the fresh requests it asks for (a closed
loop), until ``--seconds`` have passed and the call in flight has come
back; the requests still in flight are waited for after it.  Once it
has closed, peak memory is read, the system is freed and a sample of
the answers drawn from the seed is compared with the plain reference.
The last line of standard output is the result, as JSON.

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

from clutchbench import check  # noqa: E402
from clutchbench.data import derive  # noqa: E402
from clutchbench.manifest import Manifest  # noqa: E402
from clutchbench.profiling import REFILL, Window  # noqa: E402

#: top-level module names that no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def p95(values) -> float:
    """The 95th percentile by nearest rank over all ``values``."""
    v = sorted(values)
    return v[max(0, math.ceil(0.95 * len(v)) - 1)]


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


class Cell:
    """One cell bound to a run: its configuration and mix (with
    ``overrides``, ``{"config": {...}, "mix": {...}}``, which serve the
    CPU tests only), the kind module that builds and judges it, the
    seed and the device."""

    def __init__(self, manifest: Manifest, name: str, seed: int, device,
                 overrides: dict | None = None, control: bool = False
                 ) -> None:
        overrides = overrides or {}
        entry = manifest.cell(name)
        self.manifest, self.name = manifest, name
        self.seed, self.device, self.control = seed, device, control
        self.overrides = overrides
        self.cfg = {**manifest.config(entry["config"]),
                    **overrides.get("config", {})}
        self.spec = {**manifest.mix(entry["traffic"]),
                     **overrides.get("mix", {})}
        self.kind = manifest.kind(self.cfg["kind"])

    def generator(self):
        """The mix's generator, bound to this run's seed."""
        return self.manifest.generator(self.spec, self.cfg, self.seed,
                                       self.device)


class Reservoir:
    """A uniform sample of ``k`` of the answers offered, drawn from the
    seed as they come, so that memory stays bounded."""

    def __init__(self, k: int, seed: int) -> None:
        self.k = k
        self.rng = np.random.default_rng(seed)
        self.items: list = []
        self.seen = 0

    def offer(self, i: int, out) -> None:
        """Offer the answer ``out`` to request ``i``."""
        n, self.seen = self.seen, self.seen + 1
        if n < self.k:
            self.items.append((i, out))
            return
        j = int(self.rng.integers(0, n + 1))
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


class Record:
    """What a window did: ``n`` calls, each call's latency (``lat``) and
    the fresh requests it took (``takes``), calls that raised
    (``failed``, the first traceback in ``error``), the window's seconds
    less any refill, and the trace summary (``--trace 1``) of the calls
    ``traced`` = [first, end)."""

    def __init__(self, lat, takes, failed, error, window_s, summary,
                 traced, plain, system) -> None:
        self.lat, self.takes, self.n = lat, takes, len(lat)
        self.failed, self.error = failed, error
        self.window_s, self.summary = window_s, summary
        self.traced = tuple(traced) if traced else (0, self.n)
        self.plain, self.system = plain, system

    @property
    def p95_s(self) -> float:
        return p95(self.lat)


def window(system, reqs: Requests, seconds: float, trace: bool,
           keep: Reservoir, traced_calls: tuple | None = None) -> Record:
    """Drive calls until ``seconds`` of the window have passed: each
    takes the next ``system.wants()`` requests of the pool and returns
    the ``(request, answer)`` pairs it finished, offered to ``keep``.
    Drawing more requests, should the pool run out, stops the window's
    clock: it is the harness's work, not the system's.  ``trace``
    profiles the window, or only its calls ``traced_calls`` = (first,
    count) where the mix names them."""
    lat: list[float] = []
    takes: list[int] = []
    failed, error, paused = 0, None, 0.0
    call, wants, prepared = system.call, system.wants, reqs.prepared
    win = Window(trace, traced_calls)
    tick = win.at if trace and traced_calls else None
    with win:
        i, start = 0, time.perf_counter()
        end = start + seconds
        while True:
            if tick:
                tick(len(lat))
            k = wants()
            while i + k > len(prepared):
                r0 = time.perf_counter()
                with win.span(REFILL):
                    reqs.extend()
                dt = time.perf_counter() - r0
                paused += dt
                end += dt
            with win.span("window.request"):
                t0 = time.perf_counter()
                try:
                    done = call(prepared[i:i + k], i)
                except Exception:           # answers that never came
                    done = [(j, None) for j in range(i, i + k)]
                    failed += 1
                    error = error or traceback.format_exc()
                t1 = time.perf_counter()
            lat.append(t1 - t0)
            takes.append(k)
            for j, out in done:
                keep.offer(j, out)
            i += k
            if t1 >= end:
                break
        win.close(len(lat))
    return Record(lat, takes, failed, error, t1 - start - paused,
                  win.summary, win.traced, reqs.plain, system)


def warm_up(system, requests: list) -> None:
    """Every request of the warm-up through the calls the window makes,
    then whatever is still in flight, so the window opens idle."""
    i = 0
    while i < len(requests):
        k = min(system.wants(), len(requests) - i)
        system.call(requests[i:i + k], i)
        i += k
    lost = [j for j, out in system.drain() if out is None]
    if lost:
        raise RuntimeError(f"warm-up requests {lost} never came back")


def by_kind(kind, w: Record) -> str:
    """Each call kind's count, median and 95th percentile latency."""
    groups: dict[str, list] = {}
    first = 0
    for t, k in zip(w.lat, w.takes):
        groups.setdefault(kind.label(w.plain[first:first + k]), []).append(
            t * 1e3)
        first += k
    return "; ".join(f"{k} n={len(v)} med={sorted(v)[len(v) // 2]:.3f} "
                     f"p95={p95(v):.3f}" for k, v in sorted(groups.items()))


def run_cell(manifest: Manifest, name: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda", overrides: dict | None = None,
             t_start: float | None = None, control: bool = False
             ) -> tuple[dict, dict]:
    """One run of one cell: (the result object, everything the
    comparison found).  ``overrides`` and ``device="cpu"`` serve the CPU
    tests only; ``control`` has the kind judge its control in the
    program's place, where the control needs the program's answers."""
    t_start = time.perf_counter() if t_start is None else t_start
    marks = [("imports", time.perf_counter())]
    cell = Cell(manifest, name, seed, device, overrides, control)
    kind = cell.kind
    threads = torch.get_num_threads()
    if "host_threads" in cell.spec:
        # the threads of the program's CPU tensor operations: where a
        # mix fixes them, idle workers spin beside the caller no more
        torch.set_num_threads(cell.spec["host_threads"])
    gen = cell.generator()
    on_card = device != "cpu"
    with torch.profiler.record_function("setup.generate"):
        inputs, make = kind.build(cell)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    marks.append(("inputs", time.perf_counter()))
    with torch.profiler.record_function("setup.build"):
        system = make()
    marks.append(("system", time.perf_counter()))
    reqs = Requests(gen, cell.spec, seconds, system)
    reqs.extend()
    marks.append(("requests", time.perf_counter()))
    warm_up(system, system.prepare(gen.warmup()))
    if on_card:
        torch.cuda.synchronize()
    marks.append(("warm-up", time.perf_counter()))
    setup_s = marks[-1][1] - t_start
    parts = ", ".join(f"{k} {t - t0:.2f}" for (k, t), t0 in
                      zip(marks, [t_start] + [t for _, t in marks]))

    keep = Reservoir(cell.spec["check_sample"], derive(seed, 3))
    # the request pool is the harness's: keep the collector from walking
    # it during the window
    gc.collect()
    gc.freeze()
    try:
        w = window(system, reqs, seconds, trace, keep,
                   cell.spec.get("trace_calls"))
    finally:
        gc.unfreeze()
    # the requests still in flight, waited for; one that never comes
    # has failed
    t_window = time.perf_counter()
    late = system.drain()
    t_drain = time.perf_counter()
    for j, out in late:
        keep.offer(j, out)
    failed = w.failed + sum(out is None for _, out in late)
    if not trace:
        values = {**kind.values(cell, w), "setup_s": setup_s}
    else:
        a, b = w.traced
        w.summary.update(entry=gen.entry, requests=b - a,
                         **kind.facts(cell, w))

    peak = torch.cuda.max_memory_allocated() if on_card else 0
    system.close()
    del system
    w.system = None
    reqs.prepared = []
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    with torch.profiler.record_function("check"):
        numbers, found = kind.judge(cell, inputs, reqs.plain, keep.items)
    print(f"set-up seconds: {parts}", file=sys.stderr)
    print(f"seconds: set-up {setup_s:.1f}, window and its trace "
          f"{t_window - t_start - setup_s:.1f}, drain {t_drain - t_window:.1f}"
          f", check {time.perf_counter() - t_check:.1f}", file=sys.stderr)
    if w.error:
        print(f"{w.failed} of {w.n} calls raised; the first:\n{w.error}",
              file=sys.stderr)
    print("latency by kind (ms): " + by_kind(kind, w), file=sys.stderr)

    device_info = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
        "count": 1,
        "memory_peak_bytes": int(peak),
    }
    result = {"correct": failed == 0 and check.passed(numbers),
              "attempted": sum(w.takes), "failed": failed}
    if not trace:
        metrics = {m["name"]: {"value": values[m["name"]],
                               "unit": m["unit"]}
                   for m in manifest.end_to_end(name)}
    else:
        summary = w.summary
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
    torch.set_num_threads(threads)
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
