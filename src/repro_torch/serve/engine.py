"""Batched serving engine: continuous-batching slots, prefill + decode,
Clutch threshold sampling.

Counterpart of the reference package's ``serve/engine.py``.  The
sampler's hot path is the paper's primitive: a vector-scalar comparison
of every vocab logit against a per-request threshold.  With
``use_clutch_mask`` the mask is computed by the ``minp_mask`` kernel
(:func:`repro_torch.kernels.ops.sample_threshold_mask`); otherwise by the
plain float comparison.  The two differ only on a logit -0.0 against a
threshold +0.0 and on NaN logits (see :mod:`repro_torch.kernels.ref`).

Slots model: a fixed decode batch of ``num_slots`` sequences.  Finished
requests free their slot; queued requests are prefilled at batch 1 and
copied into a free slot.  As in the reference, one decode step runs every
slot at the largest active position.  Unlike the reference, the cache is
updated in place (the slot copy and every decode step's K/V row).

``jax.random.categorical`` becomes the same Gumbel-max draw on an
explicit ``torch.Generator`` seeded from ``seed``: the tokens drawn are
not the reference's, but their distribution is, softmax of the masked
logits.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as K
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.ref import MINP_FILL
from repro_torch.models import lm as M


@dataclasses.dataclass
class SamplerConfig:
    temperature: float = 1.0
    min_p: float = 0.05          # threshold = max_logit + log(min_p)
    use_clutch_mask: bool = True
    greedy: bool = False


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # [S] int32
    max_new_tokens: int = 16
    out_tokens: list[int] = dataclasses.field(default_factory=list)


def _log_f32(x: float) -> float:
    """``log(x)`` rounded to float32, as the reference adds a float32
    ``log(min_p)``; a float32 value is exact as a Python float."""
    return float(np.float32(math.log(x)))


def threshold_mask(logits: torch.Tensor, sc: SamplerConfig
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The min-p filter of :func:`sample`: (tau [B], masked logits
    [B, V]) for float32 logits already divided by the temperature."""
    tau = logits.amax(dim=-1) + _log_f32(sc.min_p)
    if sc.use_clutch_mask:
        masked = K.sample_threshold_mask(logits.float(), tau.float())
    else:
        masked = torch.where(logits >= tau[:, None], logits, MINP_FILL)
    return tau, masked


def gumbel_max(masked: torch.Tensor, generator: torch.Generator
               ) -> torch.Tensor:
    """One categorical draw per row of ``masked`` (unnormalised log
    probabilities): argmax of logits plus Gumbel noise, the draw
    ``jax.random.categorical`` makes."""
    u = torch.rand(masked.shape, generator=generator, device=masked.device)
    u.clamp_(min=torch.finfo(torch.float32).tiny)
    return torch.argmax(masked - torch.log(-torch.log(u)), dim=-1)


def sample(cfg: ModelConfig, logits: torch.Tensor,
           generator: torch.Generator, sc: SamplerConfig) -> torch.Tensor:
    """logits: [B, V].  min-p thresholding via the Clutch comparator;
    returns [B] int32 tokens."""
    logits = logits / max(sc.temperature, 1e-6)
    if sc.greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    _, masked = threshold_mask(logits, sc)
    return gumbel_max(masked, generator).to(torch.int32)


def to_device(tree: Any, device: torch.device) -> Any:
    """A parameter or cache tree with every tensor on ``device`` (no copy
    for a tensor already there)."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


class ServeEngine:
    """Serves requests on ``device``: the card unless the caller names
    another (with no CUDA and no ``device`` it raises).  ``params`` are
    moved there if they lie elsewhere."""

    def __init__(self, cfg: ModelConfig, params: Any, num_slots: int,
                 max_len: int, sc: SamplerConfig | None = None,
                 seed: int = 0, device=None) -> None:
        self.device = resolve_device(device)
        self.cfg, self.params = cfg, to_device(params, self.device)
        self.sc = sc or SamplerConfig()
        self.num_slots, self.max_len = num_slots, max_len
        self.cache = M.init_cache(cfg, num_slots, max_len, self.device)
        self.pos = np.zeros(num_slots, np.int64)       # next position
        self.active: dict[int, Request] = {}           # slot -> request
        self.generator = torch.Generator(self.device).manual_seed(seed)

    # ------------------------------------------------------------- #
    def _free_slots(self) -> list[int]:
        return [i for i in range(self.num_slots) if i not in self.active]

    def _merge(self, full: dict, one: dict, slot: int) -> None:
        """Copy a batch-1 prefill cache into ``slot``; a slot-independent
        leaf (the rolling ``kpos``) is replaced, as in the reference."""
        for name, leaf in one.items():
            cur = full[name]
            if isinstance(leaf, dict):
                self._merge(cur, leaf, slot)
            elif (cur.dim() >= 2 and cur.shape[1] == self.num_slots
                    and leaf.shape[1] == 1):
                cur[:, slot:slot + 1] = leaf
            else:
                full[name] = leaf

    def add_request(self, req: Request) -> bool:
        if len(req.prompt) < 2:
            raise ValueError("prompts need >= 2 tokens")
        slots = self._free_slots()
        if not slots:
            return False
        slot = slots[0]
        # prefill all but the last prompt token; the last one is fed by the
        # first decode step (producing the first new-token logits)
        tokens = torch.from_numpy(
            np.asarray(req.prompt[None, :-1], np.int64)).to(self.device)
        _, cache1 = M.prefill(self.cfg, self.params, {"tokens": tokens},
                              max_len=self.max_len)
        self._merge(self.cache, cache1, slot)
        self.pos[slot] = len(req.prompt) - 1
        self.active[slot] = req
        return True

    def step(self) -> list[Request]:
        """One decode step for all active slots; returns finished
        requests.  All slots decode at the largest active position, as in
        the reference (right for equal-length prompts)."""
        if not self.active:
            return []
        last_tok = np.zeros((self.num_slots, 1), np.int64)
        for slot, req in self.active.items():
            last_tok[slot, 0] = (req.out_tokens[-1] if req.out_tokens
                                 else req.prompt[-1])
        pos = int(max(self.pos[s] for s in self.active))
        logits, self.cache = M.decode_step(
            self.cfg, self.params, self.cache,
            torch.from_numpy(last_tok).to(self.device), pos)
        toks = sample(self.cfg, logits[:, 0], self.generator, self.sc)
        toks = toks.cpu().numpy()
        finished = []
        for slot, req in list(self.active.items()):
            req.out_tokens.append(int(toks[slot]))
            self.pos[slot] += 1
            if len(req.out_tokens) >= req.max_new_tokens or \
                    self.pos[slot] >= self.max_len:
                finished.append(req)
                del self.active[slot]
        return finished

    def run(self, requests: list[Request]) -> list[Request]:
        """Serve a list of requests to completion (continuous batching)."""
        pending = list(requests)
        done: list[Request] = []
        while pending or self.active:
            while pending and self._free_slots():
                self.add_request(pending.pop(0))
            done.extend(self.step())
        return done
