"""The instance generator: each predict request is a fresh
[``batch``, features] array of instance values drawn by
``data.instances`` from the seed, a block of requests at a time."""

from __future__ import annotations

from clutchbench import data
from clutchbench.data import derive

ENTRY = "predict"


class Generator:
    entry = ENTRY

    def __init__(self, spec: dict, cfg: dict, seed: int, device) -> None:
        self.spec, self.cfg = spec, cfg
        self.seed, self.device = seed, device
        self.batch = spec["batch"]
        self.blocks = 0

    def _arrays(self, n: int, stream: int) -> list:
        x = data.instances(self.cfg, derive(self.seed, stream),
                           n * self.batch, self.device)
        return [x[i * self.batch:(i + 1) * self.batch] for i in range(n)]

    def draw(self, n: int) -> list:
        self.blocks += 1
        return self._arrays(n, 99 + self.blocks)

    def warmup(self) -> list:
        return self._arrays(self.spec["warmup"], 5)
