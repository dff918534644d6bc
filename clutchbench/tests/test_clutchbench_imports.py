"""What a run loads: never JAX, nor the JAX package ``repro`` (top-level
names compared whole, so ``repro_torch`` is allowed); and the reference
loads nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

HOME = Path(__file__).resolve().parents[1]
ROOT = HOME.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

RUN_TINY = """
import sys
sys.path[:0] = [{root!r}, {src!r}]
from clutchbench import run
from clutchbench.manifest import Manifest
m = Manifest({bench!r})
tiny = {{"config": {{"records": 4000, "orders": 1000, "parts": 800,
                     "suppliers": 40}}, "mix": {{"pool_per_s": 20}}}}
from repro_torch.configs.registry import get_config
import dataclasses, json
model = json.loads(json.dumps(dataclasses.asdict(
    get_config("minitron-8b").reduced())))
lm = {{"config": {{"model": model}},
      "mix": {{"slots": 2, "max_len": 20, "prompt_len": 12, "new_tokens": 4,
              "check_sample": 2, "trace_calls": [0, 1]}}}}
for cell in ("lineitem-sf10.tpch-where", "higgs-1000x6.online-256",
             "minitron-8b.gen-1024x128"):
    ov = tiny if "lineitem" in cell else lm if "minitron" in cell else {{
        "config": {{"trees": 8}}, "mix": {{"batch": 8}}}}
    for trace in (False, True):
        assert run.run_cell(m, cell, 9, 0.2, trace, device="cpu",
                            overrides=ov)[0]["correct"]
print(" ".join(sorted({{k.split(".")[0] for k in sys.modules}})))
"""


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(out.stdout.split()[-1000:])


def test_a_run_loads_no_jax_and_not_the_jax_package():
    loaded = _loaded(RUN_TINY.format(root=str(ROOT), src=str(ROOT / "src"),
                                     bench=str(ROOT / "BENCHMARK.json")))
    assert "repro_torch" in loaded and "clutchbench" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_the_run_refuses_when_it_finds_them(monkeypatch):
    from clutchbench import run
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    assert run.forbidden_modules() == ["jaxlib"]
    monkeypatch.delitem(sys.modules, "jaxlib.xla_client")
    monkeypatch.setitem(sys.modules, "repro_torch_like", object())
    assert "repro" not in run.forbidden_modules()


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_harness_file_names_jax_or_the_jax_package():
    for path in HOME.rglob("*.py"):
        if "tests" in path.parts:
            continue
        assert not _imports(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    for path in (HOME / "reference").glob("*.py"):
        assert not _imports(path) & (FORBIDDEN | {"repro_torch"}), path
    loaded = _loaded(
        f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
        "import clutchbench.reference.forest, "
        "clutchbench.reference.predicates, "
        "clutchbench.reference.lm_dense; "
        "print(' '.join({k.split('.')[0] for k in sys.modules}))")
    assert "repro_torch" not in loaded and not loaded & FORBIDDEN
