"""The harness: its statistics, the manifest's rules, discovery by name,
a tiny run through the port's CPU path, the faults that must come out
as not correct, and the control."""

import dataclasses
import json
import re
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from clutchbench import profiling, run
from clutchbench.control import readings
from clutchbench.manifest import Manifest

HOME = Path(__file__).resolve().parents[1]
ROOT = HOME.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _reduced(arch):
    """The port's registry entry of ``arch`` at its smoke scale (float32),
    as a configuration's ``model`` object."""
    from repro_torch.configs.registry import get_config
    return json.loads(json.dumps(dataclasses.asdict(
        get_config(arch).reduced())))


# the cells cut to a size the CPU path runs in a second
TINY = {
    "tpch-lineitem-sf10": {"config": {"records": 20000, "orders": 5000,
                                      "parts": 4000, "suppliers": 200},
                           "mix": {"pool_per_s": 40, "check_sample": 64}},
    "catboost-higgs-1000x6": {"config": {"trees": 40},
                              "mix": {"batch": 32, "pool_per_s": 20}},
    "minitron-8b": {"config": {"model": _reduced("minitron-8b")},
                    "mix": {"slots": 4, "max_len": 40, "prompt_len": 24,
                            "new_tokens": 8, "pool_per_s": 20,
                            "check_sample": 4}},
}
CELLS = [w["name"] for w in BENCH["workloads"]]


def _tiny(cell):
    return TINY[Manifest(ROOT / "BENCHMARK.json").cell(cell)["config"]]


def test_p95_is_nearest_rank_over_all_requests():
    assert run.p95(list(range(1, 101))) == 95
    assert run.p95([5.0]) == 5.0
    # 20 requests: the 19th smallest, so one sample lies beyond it
    vals = [float(v) for v in range(20, 0, -1)]
    assert run.p95(vals) == 19.0
    # every request counts: one slow request in 21 moves it
    assert run.p95([1.0] * 19 + [100.0] * 2) == 100.0


def test_drawing_more_requests_stops_the_window_clock():
    """When the pool runs out inside the window, the draw of the next
    block is left out of the window's seconds and of every latency."""
    import time

    class SlowGen:
        entry = "query"

        def draw(self, n):
            time.sleep(0.25)
            return [("q1", 0, 0, 1)] * n

    class Sleeper:
        def prepare(self, reqs):
            return list(reqs)

        def wants(self):
            return 1

        def call(self, batch, first):
            time.sleep(0.02)
            return [(first, 0)]

    reqs = run.Requests(SlowGen(), {"pool_per_s": 10}, 0.3, Sleeper())
    reqs.extend()                           # set-up's pool: 3 requests
    t0 = time.perf_counter()
    w = run.window(Sleeper(), reqs, 0.3, False, run.Reservoir(4, 1))
    lat, failed, window_s = w.lat, w.failed, w.window_s
    wall = time.perf_counter() - t0
    refills = len(reqs.plain) // 3 - 1
    assert failed == 0 and refills >= 1
    # the window ends with the request in flight at 0.3 s of its own clock
    assert 0.3 <= window_s <= 0.3 + max(lat) + 0.05
    assert wall >= window_s + 0.25 * refills
    assert max(lat) < 0.2 and sum(lat) <= window_s


def test_reservoir_keeps_a_bounded_seeded_sample():
    a, b = run.Reservoir(5, 9), run.Reservoir(5, 9)
    for i in range(1000):
        a.offer(i, i)
        b.offer(i, i)
    assert len(a.items) == 5 and a.items == b.items
    assert max(i for i, _ in a.items) > 5          # later answers enter


def test_manifest_names_units_and_keys():
    top = {"command", "paths", "run_seconds", "configs", "workloads",
           "end_to_end", "per_layer"}
    assert set(BENCH) == top
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [
        m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).exists()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        for cell in m.get("workloads", []):
            assert cell in CELLS
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["moves"] in e2e
        moved = next(e for e in BENCH["end_to_end"]
                     if e["name"] == m["moves"])
        for cell in m["workloads"]:
            assert cell in moved.get("workloads", CELLS)
    m = Manifest(ROOT / "BENCHMARK.json")
    for cell in CELLS:
        kinds = {e["name"] for e in m.end_to_end(cell)}
        assert "setup_s" in kinds and len(kinds) >= 2
        assert m.per_layer(cell)
    for path in HOME.rglob("*"):
        if path.is_file() and "__pycache__" not in path.parts:
            assert re.match(r"^[A-Za-z0-9_./-]+$", str(path.relative_to(
                ROOT))), path


def test_every_named_file_exists():
    m = Manifest(ROOT / "BENCHMARK.json")
    for w in BENCH["workloads"]:
        assert m.config(w["config"])["name"] == w["config"]
        spec = m.mix(w["traffic"])
        gen = m.generator(spec, m.config(w["config"]), 1, "cpu")
        assert gen.entry in ("query", "predict", "generate")
    for metric in BENCH["per_layer"]:
        assert callable(m.reader(metric["name"]))


def test_added_config_mix_and_metric_are_found_by_name(tmp_path):
    home = tmp_path / "clutchbench"
    shutil.copytree(HOME, home, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    bench = json.loads(json.dumps(BENCH))
    cfg = json.loads((home / "configs" / "tpch-lineitem-sf10.json"
                      ).read_text())
    cfg.update(name="tpch-lineitem-tiny", records=1000, orders=250)
    (home / "configs" / "tpch-lineitem-tiny.json").write_text(
        json.dumps(cfg))
    mix = json.loads((home / "mixes" / "adhoc-count.json").read_text())
    mix["mix"] = mix["mix"][:1]
    mix["generator"] = "every-other"
    (home / "mixes" / "q3-only.json").write_text(json.dumps(mix))
    # a generator of its own: the query generator's draws, every other
    (home / "generators" / "every-other.py").write_text(
        "from clutchbench.generators.queries import Generator as G\n"
        "class Generator(G):\n"
        "    def draw(self, n):\n"
        "        return super().draw(2 * n)[::2]\n")
    (home / "layer_metrics" / "requests_seen.py").write_text(
        "def read(s):\n    return float(s['requests'])\n")
    bench["configs"].append({"name": "tpch-lineitem-tiny", "source": "x",
                             "file": "x", "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "tiny.q3-only",
                               "config": "tpch-lineitem-tiny",
                               "traffic": "q3-only", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "requests_seen.count", "unit": "1",
                               "better": "higher", "source": "host_clock",
                               "layer": "x", "moves": "count_qps",
                               "workloads": ["tiny.q3-only"]})
    for m in bench["end_to_end"]:
        if m["name"] == "count_qps":
            m["workloads"].append("tiny.q3-only")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    m = Manifest(tmp_path / "BENCHMARK.json", home=home)
    res, _ = run.run_cell(m, "tiny.q3-only", 5, 0.3, True, device="cpu",
                          overrides={"mix": {"pool_per_s": 50}})
    assert res["correct"]
    assert res["metrics"]["requests_seen.count"]["value"] == res["attempted"]
    res, _ = run.run_cell(m, "tiny.q3-only", 5, 0.3, False, device="cpu",
                          overrides={"mix": {"pool_per_s": 50}})
    assert set(res["metrics"]) == {"count_qps", "setup_s"}


def _run(cell, trace=False, seed=2 ** 31 + 3, seconds=0.4):
    m = Manifest(ROOT / "BENCHMARK.json")
    return run.run_cell(m, cell, seed, seconds, trace, device="cpu",
                        overrides=_tiny(cell))[0]


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_run_through_the_cpu_path(cell):
    res = _run(cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    m = Manifest(ROOT / "BENCHMARK.json")
    assert set(res["metrics"]) == {e["name"] for e in m.end_to_end(cell)}
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert list(res)[-1] == "checks"
    for name, v in res["checks"].items():
        assert v["value"] <= v["limit"], name


@pytest.mark.parametrize("cell", CELLS[:2])
def test_tiny_traced_run_reports_its_layer_metrics(cell):
    res = _run(cell, trace=True)
    assert res["correct"]
    m = Manifest(ROOT / "BENCHMARK.json")
    want = {e["name"] for e in m.per_layer(cell)}
    # no card: no kernel time, so no roofline share; the rest reads
    assert set(res["metrics"]) == {n for n in want if "roofline" not in n}
    assert res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


# ------------------------------------------------------------------ #
# The faults each cell can have must come out as not correct
# ------------------------------------------------------------------ #

def _alter_count(monkeypatch):
    from repro_torch.kernels.fused_session import FusedTableExec
    orig = FusedTableExec._total
    monkeypatch.setattr(FusedTableExec, "_total",
                        lambda self, cnt: orig(self, cnt) + 1)


def _alter_bitmap(monkeypatch):
    from repro_torch.kernels.fused_session import FusedTableExec
    orig = FusedTableExec._bitmap

    def flipped(self, bm):
        out = orig(self, bm).copy()
        out[len(out) // 3] ^= True
        return out
    monkeypatch.setattr(FusedTableExec, "_bitmap", flipped)


def _half_the_rows(monkeypatch):
    """Every scan sees its first shard only: half the records left out,
    counts and means taken over the rest."""
    from repro_torch.kernels import fused_session as fs

    for name in ("fused_predicate_banked", "fused_compound_banked"):
        orig = getattr(fs, name)

        def first_shard(lut, *a, _orig=orig, **k):
            bm, cnt = _orig(lut, *a, **k)
            bm = bm.clone()
            bm[1:] = 0
            cnt = cnt.clone()
            cnt[1:] = 0
            return bm, cnt
        monkeypatch.setattr(fs, name, first_shard)


def _alter_prediction(monkeypatch):
    from repro_torch.kernels.fused_session import FusedGbdtExec
    orig = FusedGbdtExec.infer

    def off(self, x):
        out = orig(self, x).copy()
        out[-1] += np.float32(0.01)
        return out
    monkeypatch.setattr(FusedGbdtExec, "infer", off)


def _half_the_batch(monkeypatch):
    from repro_torch.kernels.fused_session import FusedGbdtExec
    orig = FusedGbdtExec.infer

    def half(self, x):
        h = max(1, x.shape[0] // 2)
        part = orig(self, x[:h])
        return np.resize(part, x.shape[0])
    monkeypatch.setattr(FusedGbdtExec, "infer", half)


def _alter_token(monkeypatch):
    """Every drawn token moved to the next id, where the sampler draws
    it."""
    from repro_torch.serve import engine
    orig = engine.sample

    def moved(cfg, logits, generator, sc):
        return (orig(cfg, logits, generator, sc) + 1) % cfg.vocab
    monkeypatch.setattr(engine, "sample", moved)


def _perturb_logit(monkeypatch):
    """One vocabulary entry's logit raised by 5 in every decode step."""
    from repro_torch.models import lm
    orig = lm.decode_step

    def raised(cfg, params, cache, tokens, pos, cross=None):
        logits, cache = orig(cfg, params, cache, tokens, pos, cross)
        logits[..., 7] += 5.0
        return logits, cache
    monkeypatch.setattr(lm, "decode_step", raised)


def _half_the_slots(monkeypatch):
    """Each decode step computes the first half of its slots only; the
    other half gets their logits."""
    from repro_torch.models import lm
    orig = lm.decode_step

    def half(cfg, params, cache, tokens, pos, cross=None):
        h = max(1, tokens.shape[0] // 2)
        part = {k: {n: t[:, :h] for n, t in v.items()}
                for k, v in cache.items()}
        logits, _ = orig(cfg, params, part, tokens[:h], pos, cross)
        idx = torch.arange(tokens.shape[0]) % h
        return logits[idx], cache
    monkeypatch.setattr(lm, "decode_step", half)


def _state_unchanged(monkeypatch):
    """A decode step that leaves the K/V cache as it found it."""
    from repro_torch.models import lm
    orig = lm.decode_step

    def stale(cfg, params, cache, tokens, pos, cross=None):
        kept = {k: {n: t.clone() for n, t in v.items()}
                for k, v in cache.items()}
        logits, _ = orig(cfg, params, cache, tokens, pos, cross)
        for k, v in kept.items():
            for n, t in v.items():
                cache[k][n].copy_(t)
        return logits, cache
    monkeypatch.setattr(lm, "decode_step", stale)


def _wrong_slot(monkeypatch):
    """A prefill's cache merged into the next slot, not its own."""
    from repro_torch.serve.engine import ServeEngine
    orig = ServeEngine._merge

    def shifted(self, full, one, slot):
        if full is self.cache:          # the outermost call, once
            slot = (slot + 1) % self.num_slots
        orig(self, full, one, slot)
    monkeypatch.setattr(ServeEngine, "_merge", shifted)


def _drop_request(monkeypatch):
    """The first of the window's requests to finish (not the warm-up's,
    which ask for fewer tokens) is freed from its slot but never
    returned."""
    from repro_torch.serve.engine import ServeEngine
    orig = ServeEngine.step
    new = TINY["minitron-8b"]["mix"]["new_tokens"]
    dropped = []

    def lossy(self):
        done = orig(self)
        for r in list(done):
            if not dropped and r.max_new_tokens == new:
                dropped.append(r)
                done.remove(r)
        return done
    monkeypatch.setattr(ServeEngine, "step", lossy)


FAULTS = [
    ("lineitem-sf10.adhoc-count", _alter_count),
    ("lineitem-sf10.adhoc-count", _half_the_rows),
    ("lineitem-sf10.tpch-where", _alter_bitmap),
    ("lineitem-sf10.tpch-where", _half_the_rows),
    ("higgs-1000x6.bulk-65536", _alter_prediction),
    ("higgs-1000x6.bulk-65536", _half_the_batch),
    ("higgs-1000x6.online-256", _alter_prediction),
    ("higgs-1000x6.online-256", _half_the_batch),
    ("minitron-8b.gen-1024x128", _alter_token),
    ("minitron-8b.gen-1024x128", _perturb_logit),
    ("minitron-8b.gen-1024x128", _half_the_slots),
    ("minitron-8b.gen-1024x128", _state_unchanged),
    ("minitron-8b.gen-1024x128", _wrong_slot),
    ("minitron-8b.gen-1024x128", _drop_request),
]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_a_fault_in_the_timed_path_is_not_correct(cell, fault,
                                                  monkeypatch):
    fault(monkeypatch)
    res = _run(cell)
    assert not res["correct"], res["checks"]


def test_a_request_that_raises_is_not_correct(monkeypatch):
    from repro_torch.kernels.fused_session import FusedGbdtExec
    calls = []

    def fail_once(self, x, _orig=FusedGbdtExec.infer):
        calls.append(1)
        if len(calls) == 33:    # the window's first, past the 32 of warm-up
            raise RuntimeError("lost")
        return _orig(self, x)
    monkeypatch.setattr(FusedGbdtExec, "infer", fail_once)
    res = _run("higgs-1000x6.online-256")
    assert res["failed"] == 1 and not res["correct"]


def _control_size(cell):
    """The size the control is held at: the tiny one, but for the
    language model a bfloat16 one of 16 layers of width 256 and 8,192
    ids, where the cell's limits part the program (0.29-0.44 logit gap)
    from the control (3.1-3.9) as they do at full size; at the smoke
    scale the control's gap is 1.7-2.2."""
    if Manifest(ROOT / "BENCHMARK.json").cell(cell)["config"] != \
            "minitron-8b":
        return _tiny(cell)
    model = dict(_reduced("minitron-8b"), num_layers=16, d_model=256,
                 d_ff=1024, vocab=8192, n_heads=4, n_kv_heads=2, d_head=64,
                 param_dtype="bfloat16", compute_dtype="bfloat16")
    return {"config": {"model": model}, "mix": TINY["minitron-8b"]["mix"]}


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_limits(cell):
    numbers = readings(Manifest(ROOT / "BENCHMARK.json"), cell,
                       2 ** 31 + 11, 1.0, device="cpu",
                       overrides=_control_size(cell))
    assert any(v["value"] > v["limit"] for v in numbers.values()), numbers


def test_at_the_control_size_the_program_is_correct():
    """The other side of the language model's control: the program held
    at the control's size passes the cell's limits."""
    cell = "minitron-8b.gen-1024x128"
    res, _ = run.run_cell(Manifest(ROOT / "BENCHMARK.json"), cell,
                          2 ** 31 + 11, 0.5, False, device="cpu",
                          overrides=_control_size(cell))
    assert res["correct"], res["checks"]


# ------------------------------------------------------------------ #
# The trace's reduction
# ------------------------------------------------------------------ #

def test_summary_of_a_synthetic_trace():
    dev = [(100, 200, "k1", "kernel", 0), (150, 250, "k2", "kernel", 0),
           (400, 500, "Memcpy DtoH (Device -> Pageable)", "gpu_memcpy",
            4096), (600, 700, "Memcpy HtoD (Pageable -> Device)",
                    "gpu_memcpy", 64), (1100, 1200, "k1", "kernel", 0)]
    host = [(60, 950, "window.request"), (300, 380, "aten::to"),
            (520, 590, "cudaStreamSynchronize")]
    s = profiling.summarize(dev, host, (0, 1000))
    assert s["window_s"] == 1e-6
    assert s["busy_s"] == pytest.approx(350e-9)     # 100-250, 400-500, 600-700
    assert s["kernel_s"] == pytest.approx(200e-9)   # k1, k2 inside
    assert s["kernels"] == 2
    assert (s["d2h_bytes"], s["h2d_bytes"]) == (4096, 64)
    gaps = dict(s["idle_gaps"])
    # 0-100 before any request, 250-400 in aten::to (mid 325), 500-600 in
    # the sync (mid 550), 700-1000 in the request (mid 850)
    assert gaps == pytest.approx({"window.client": 100e-9,
                                  "aten::to": 150e-9,
                                  "cudaStreamSynchronize": 100e-9,
                                  "window.request": 300e-9})
    assert s["device_ops"][0][0] == "k1"


def test_a_stretch_of_calls_is_traced_alone():
    """With ``calls = (1, 2)`` the profiler records calls 1 and 2 of
    five, and the summary's window is theirs."""
    win = profiling.Window(True, (1, 2))
    with win:
        for i in range(5):
            win.at(i)
            with win.span("window.request"):
                torch.ones(64).sum()
        win.close(5)
    assert win.traced == [1, 3]
    assert win.summary["window_s"] > 0


def test_a_stretch_never_reached_raises():
    win = profiling.Window(True, (3, 2))
    with win:
        win.at(0)
        with pytest.raises(RuntimeError, match="none of the calls"):
            win.close(1)


def test_refill_spans_are_cut_out_of_the_traced_window():
    dev = [(100, 200, "k1", "kernel", 0),
           (400, 500, "randint", "kernel", 0),       # inside the refill
           (450, 480, "Memcpy DtoH (Device -> Pageable)", "gpu_memcpy",
            4096),
           (550, 700, "k2", "kernel", 0)]             # straddles its end
    host = [(60, 300, "window.request"), (600, 900, "window.request")]
    s = profiling.summarize(dev, host, (0, 1000), [(300, 600)])
    assert s["window_s"] == pytest.approx(700e-9)
    assert s["busy_s"] == pytest.approx(200e-9)       # 100-200, 600-700
    assert s["kernel_s"] == pytest.approx(200e-9)
    assert (s["kernels"], s["d2h_bytes"]) == (2, 0)
    gaps = dict(s["idle_gaps"])
    # 0-100 before the first request, 200-300 and 700-1000 inside one
    assert gaps == pytest.approx({"window.request": 400e-9,
                                  "window.client": 100e-9})


@pytest.mark.card
def test_a_short_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    m = Manifest(ROOT / "BENCHMARK.json")
    res, _ = run.run_cell(m, "higgs-1000x6.online-256", 2 ** 31 + 17, 1.0,
                          False)
    assert res["correct"] and res["device"]["platform"] == "gpu"
