"""The prompt generator: each request is a prompt of ``prompt_len``
token ids, uniform over the configuration's vocabulary, and the number
of new tokens it asks for, ``new_tokens``; drawn on ``device`` from the
seed, a block of requests at a time.  Every request of a mix has the
same lengths, so every seed gets the same work."""

from __future__ import annotations

import torch

from clutchbench import data
from clutchbench.data import derive

ENTRY = "generate"


class Generator:
    entry = ENTRY

    def __init__(self, spec: dict, cfg: dict, seed: int, device) -> None:
        self.spec, self.vocab = spec, cfg["model"]["vocab"]
        self.seed, self.device = seed, device
        self.blocks = 0

    def _prompts(self, n: int, stream: int) -> list:
        g = data.generator(derive(self.seed, stream), self.device)
        ids = torch.randint(0, self.vocab, (n, self.spec["prompt_len"]),
                            generator=g, device=self.device,
                            dtype=torch.int32).cpu().numpy()
        return list(ids)

    def draw(self, n: int) -> list:
        """``n`` requests: ``(prompt, new tokens)``."""
        self.blocks += 1
        return [(p, self.spec["new_tokens"])
                for p in self._prompts(n, 99 + self.blocks)]

    def warmup(self) -> list:
        """``warmup`` requests of ``warmup_new_tokens`` new tokens: every
        prefill and decode shape of the window, done in a few steps."""
        return [(p, self.spec["warmup_new_tokens"])
                for p in self._prompts(self.spec["warmup"], 5)]
