"""``BENCHMARK.json`` and the files it names, found by name:

* ``configs/<config>.json``, the configuration as it is run; its
  ``kind`` names ``kinds/<kind>.py``, which builds the system under test
  and judges its answers, and an ``lm`` configuration's ``reference``
  names ``reference/<reference>.py``, its plain forward
* ``mixes/<traffic>.json``, the traffic's parameters, which name the
  generator that draws them
* ``generators/<generator>.py``, whose ``Generator(spec, cfg, seed,
  device)`` draws a mix's requests (``draw(n)``, ``warmup()``)
* ``layer_metrics/<metric>.py``, or else ``layer_metrics/<base>.py``
  with ``<base>`` the metric's name up to its first dot, whose
  ``read(summary)`` gives the per-layer metric, or ``None`` where it
  finds nothing to read
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


class Manifest:
    def __init__(self, path: Path, home: Path = HERE) -> None:
        self.data = json.loads(Path(path).read_text())
        self.home = Path(home)
        self.cells = {w["name"]: w for w in self.data["workloads"]}

    def cell(self, name: str) -> dict:
        if name not in self.cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(have {sorted(self.cells)})")
        return self.cells[name]

    def config(self, name: str) -> dict:
        return json.loads((self.home / "configs" / f"{name}.json"
                           ).read_text())

    def mix(self, name: str) -> dict:
        return json.loads((self.home / "mixes" / f"{name}.json"
                           ).read_text())

    def _metrics(self, kind: str, cell: str) -> list[dict]:
        return [m for m in self.data[kind]
                if cell in m.get("workloads", [cell])]

    def end_to_end(self, cell: str) -> list[dict]:
        """The end-to-end metrics this cell reports."""
        return self._metrics("end_to_end", cell)

    def per_layer(self, cell: str) -> list[dict]:
        """The per-layer metrics this cell reports."""
        return self._metrics("per_layer", cell)

    def _module(self, folder: str, name: str):
        path = self.home / folder / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            f"clutchbench_{folder}_" + name.replace(".", "_").replace(
                "-", "_"), path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module

    def kind(self, name: str):
        """The module ``kinds/<name>.py`` of a configuration's kind."""
        return self._module("kinds", name)

    def reference(self, name: str):
        """The plain reference ``reference/<name>.py`` a configuration
        names."""
        return self._module("reference", name)

    def generator(self, spec: dict, cfg: dict, seed: int, device):
        """The generator the mix ``spec`` names, bound to a run."""
        return self._module("generators", spec["generator"]).Generator(
            spec, cfg, seed, device)

    def reader(self, metric: str):
        """``read`` of the metric's file under ``layer_metrics/``."""
        name = metric
        if not (self.home / "layer_metrics" / f"{name}.py").exists():
            name = metric.split(".")[0]
        return self._module("layer_metrics", name).read
