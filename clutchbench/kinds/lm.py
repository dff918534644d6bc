"""A decoder language model served by ``repro_torch``'s ``ServeEngine``.

Inputs: the weights, drawn on the device from the seed in the
configuration's ``param_dtype`` (one call a weight, the model's layers
stacked in it) by the layout and scales of the plain reference that the
configuration names (``reference/<reference>.py``); each request is a
prompt and the number of new tokens it asks for.  The system under
test: ``ServeEngine`` over ``ModelConfig(**model)``, with the mix's
``slots`` and ``max_len`` and the engine's own default sampler (min-p
through the ``minp_mask`` kernel), which must be the one the
configuration states.  A call is one turn of ``ServeEngine.run``'s
loop: ``add_request`` into every free slot, then ``step()``.

The check, once the window has closed and the engine is freed, over a
sample of the finished requests drawn from the seed:

* ``wrong_requests``: sampled requests that came back with another
  number of tokens than they asked for or an id outside the vocabulary,
  or never came (every request that never came back, waited for after
  the window, also fails the run);
* ``logit_gap``: the sample replayed through a fresh ``ServeEngine`` as
  the window drives it, its slots filled with the sample and then with
  other prompts of the pool (each request prefilled at batch 1 and
  merged into its slot, every step decoding all slots at the mix's
  cache length), the sample fed the tokens it drew; the largest gap of
  a logit the engine computed for them from the plain reference's full
  forward over prompt and tokens (float32);
* ``token_gap``: the most by which a drawn token's logit, in the
  reference's forward, lies below its min-p threshold (the row's largest
  logit plus ``log(min_p)``, logits over the temperature); 0 when every
  token lies in the kept set.

The control (``control``) puts the reference in the program's place
with every weight rounded to float8 e4m3 (a scale a layer's tensor):
over the same prompts and tokens a short window of the program served,
its logits give ``logit_gap`` and its own min-p draws ``token_gap``.
"""

from __future__ import annotations

import dataclasses
import math
import time
import typing

import numpy as np
import torch

from clutchbench import check, data, work
from clutchbench.data import derive

#: what an answer that ever comes takes at most, past the window
DRAIN_S = 60.0


def model_config(model: dict):
    """``ModelConfig`` from the configuration's ``model`` object, every
    key passed through: a list becomes a tuple, an object the dataclass
    its field holds."""
    from repro_torch.configs.base import ModelConfig

    hints = typing.get_type_hints(ModelConfig)

    def value(key, v):
        if isinstance(v, list):
            return tuple(v)
        if isinstance(v, dict):
            cls = next(t for t in typing.get_args(hints[key])
                       if dataclasses.is_dataclass(t))
            return cls(**{k: tuple(x) if isinstance(x, list) else x
                          for k, x in v.items()})
        return v
    return ModelConfig(**{k: value(k, v) for k, v in model.items()})


def make_weights(cell) -> dict:
    """The flat weights, drawn on the device from the seed by the
    reference's layout: normal draws times their scale, norm scales at
    ones."""
    ref = cell.manifest.reference(cell.cfg["reference"])
    dtype = getattr(torch, cell.cfg["model"]["param_dtype"])
    g = data.generator(derive(cell.seed, 0), cell.device)
    out = {}
    for name, (shape, std) in ref.layout(cell.cfg["model"]).items():
        if std is None:
            out[name] = torch.ones(shape, dtype=dtype, device=cell.device)
        else:
            out[name] = torch.randn(shape, generator=g, dtype=dtype,
                                    device=cell.device).mul_(std)
    return out


def nested(flat: dict) -> dict:
    """The port's parameter tree of the flat ``a.b.c`` names."""
    tree: dict = {}
    for name, t in flat.items():
        *path, leaf = name.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = t
    return tree


def log_f32(x: float) -> float:
    """``log(x)`` rounded to float32, as the engine adds it."""
    return float(np.float32(math.log(x)))


class System:
    """``ServeEngine`` driven as ``ServeEngine.run`` drives it, a turn a
    call.  ``log`` keeps each call's prefill lengths, the slots it
    decoded and the positions they attended."""

    def __init__(self, cell, flat: dict) -> None:
        from repro_torch.serve.engine import Request, SamplerConfig, \
            ServeEngine

        sc = SamplerConfig()
        stated = cell.cfg["sampler"]
        if (sc.min_p, sc.temperature, sc.greedy, sc.use_clutch_mask) != (
                stated["min_p"], stated["temperature"], False, True):
            raise RuntimeError(f"the engine's default sampler {sc} is not "
                               f"the configuration's {stated}")
        self.Request = Request
        self.model = model_config(cell.cfg["model"])
        self.engine = ServeEngine(
            self.model, nested(flat), cell.spec["slots"],
            cell.spec["max_len"], sc=sc,
            seed=derive(cell.seed, 4) % (1 << 63), device=cell.device)
        self.inflight: dict = {}
        self.log: list = []

    def prepare(self, requests: list) -> list:
        return [self.Request(rid=-1, prompt=p, max_new_tokens=n)
                for p, n in requests]

    def wants(self) -> int:
        return self.engine.num_slots - len(self.inflight)

    def call(self, batch: list, first: int) -> list:
        engine, inflight = self.engine, self.inflight
        prefills = []
        for j, req in enumerate(batch):
            req.rid = first + j
            if not engine.add_request(req):
                raise RuntimeError("the engine refused a request with a "
                                   "slot free")
            inflight[req.rid] = req
            prefills.append(len(req.prompt) - 1)
        attended = sum(len(r.prompt) + len(r.out_tokens)
                       for r in inflight.values())
        self.log.append((prefills, len(inflight), attended))
        return [(r.rid, inflight.pop(r.rid).out_tokens)
                for r in engine.step()]

    def drain(self) -> list:
        """Steps until every request in flight has come back (or
        ``DRAIN_S`` have passed); one that never does answers None."""
        out, end = [], time.perf_counter() + DRAIN_S
        while self.inflight and time.perf_counter() < end:
            done = self.engine.step()
            for r in done:
                if self.inflight.pop(r.rid, None) is not None:
                    out.append((r.rid, r.out_tokens))
            if not done and not self.engine.active:
                break
        out += [(rid, None) for rid in self.inflight]
        self.inflight.clear()
        return out

    def close(self) -> None:
        del self.engine


def build(cell):
    """(the flat weights, a maker of the system under test)."""
    flat = make_weights(cell)
    return flat, lambda: System(cell, flat)


def label(taken: list) -> str:
    """The kind of a call, for the latency-by-kind line."""
    return f"prefill{len(taken)}+step" if taken else "step"


def _window_log(w) -> list:
    return w.system.log[-w.n:]


def values(cell, w) -> dict:
    """Tokens drawn in the window, each decoded slot one a step, over the
    window's seconds."""
    drawn = sum(slots for _, slots, _ in _window_log(w))
    return {"gen_tokens_per_s": drawn / w.window_s}


def facts(cell, w) -> dict:
    """What the traced summary adds for the readers: the traced calls'
    steps and the least time the chip could take for them; and, of the
    window's other calls, which the profiler did not slow, their least
    time (``job_least_s``) and their own seconds (``job_s``)."""
    engine = w.system.engine
    ref = cell.manifest.reference(cell.cfg["reference"])
    cost = work.DecoderWork(
        _sizes(engine.params), ref.LOOKUP, ref.LAST_ONLY,
        _sizes(engine.cache), engine.num_slots, engine.max_len,
        engine.cfg.n_heads, engine.cfg.d_head)
    least = [sum(cost.prefill(n) for n in prefills)
             + cost.decode(slots, attended)
             for prefills, slots, attended in _window_log(w)]
    a, b = w.traced
    rest = [i for i in range(len(least)) if not a <= i < b]
    return {"steps": b - a, "least_s": sum(least[a:b]),
            "job_least_s": sum(least[i] for i in rest),
            "job_s": sum(w.lat[i] for i in rest)}


def _flat(tree: dict, prefix: str = "") -> dict:
    """The ``a.b.c`` names of a tree's tensors."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _sizes(tree: dict) -> list:
    """``(name, shape, bytes a element)`` of every tensor in a tree."""
    return [(name, tuple(t.shape), t.element_size())
            for name, t in _flat(tree).items()]


# ------------------------------------------------------------------ #
# The check
# ------------------------------------------------------------------ #

def _replay(cell, flat: dict, reqs: list, fillers: list) -> torch.Tensor:
    """The engine's logits [k, new, vocab] for the ``k`` requests
    ``reqs``, ``(prompt, tokens it drew)`` of one length and as many
    tokens, each fed the tokens it drew: a fresh ``ServeEngine`` of the
    mix's slots and cache length, run as ``ServeEngine.run`` runs it
    over them and then the prompts ``fillers`` (of the same length,
    asking as many tokens, drawing their own), which fill the other
    slots."""
    from repro_torch.serve import engine as E

    cfg = model_config(cell.cfg["model"])
    k, new = len(reqs), len(reqs[0][1])
    device, vocab = cell.device, cfg.vocab
    engine = E.ServeEngine(cfg, nested(flat), cell.spec["slots"],
                           cell.spec["max_len"], sc=E.SamplerConfig(),
                           seed=derive(cell.seed, 6) % (1 << 63),
                           device=device)
    fed = torch.tensor([t for _, t in reqs], dtype=torch.int64,
                       device=device)
    out = torch.empty((k, new, vocab), dtype=torch.float32, device=device)
    slots, step = None, 0
    drawn = E.sample

    def fed_sample(cfg_, logits, generator, sc):
        nonlocal slots, step
        toks = drawn(cfg_, logits, generator, sc)
        if slots is None:
            slot = {r.rid: s for s, r in engine.active.items()}
            slots = torch.tensor([slot[j] for j in range(k)],
                                 device=logits.device)
        out[:, step] = logits[slots, :vocab].float()
        toks[slots] = fed[:, step].to(toks.dtype)
        step += 1
        return toks

    queue = [E.Request(rid=j, prompt=p, max_new_tokens=new)
             for j, (p, _) in enumerate(reqs)]
    queue += [E.Request(rid=k + j, prompt=p, max_new_tokens=new)
              for j, p in enumerate(fillers)]
    E.sample = fed_sample
    try:
        engine.run(queue)
    finally:
        E.sample = drawn
        del engine
    if step != new:
        raise RuntimeError(f"the replay made {step} steps, not {new}")
    return out


def fp8(t: torch.Tensor) -> torch.Tensor:
    """A weight rounded to float8 e4m3, its largest magnitude scaled to
    e4m3's largest (448), back in float32; a vector stays float32."""
    t = t.float()
    if t.dim() < 2:
        return t
    scale = t.abs().max().clamp(min=torch.finfo(torch.float32).tiny) / 448
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def _min_p_draws(logits: torch.Tensor, min_p: float,
                 g: torch.Generator) -> torch.Tensor:
    """The control's sampler: one Gumbel-max draw a row over the logits
    at or above the row's largest plus ``log(min_p)``."""
    tau = logits.amax(-1, keepdim=True) + log_f32(min_p)
    masked = torch.where(logits >= tau, logits, -1e30)
    u = torch.rand(masked.shape, generator=g, device=masked.device)
    u.clamp_(min=torch.finfo(torch.float32).tiny)
    return torch.argmax(masked - torch.log(-torch.log(u)), dim=-1)


def _fillers(cell, plain: list, sample: list, length: int, new: int,
             k: int) -> list:
    """Prompts of the pool of ``length`` ids asking ``new`` tokens, not
    in the sample, for the slots the sample leaves free: the window's
    first call filled every slot from the pool, so it holds enough."""
    taken = {i for i, _ in sample}
    same = [p for i, (p, n) in enumerate(plain)
            if i not in taken and len(p) == length and n == new]
    return same[:cell.spec["slots"] - k]


def judge(cell, flat: dict, plain: list, sample: list) -> tuple[dict, dict]:
    """(the numbers compared, each beside its limit; everything the
    comparison found)."""
    ref = cell.manifest.reference(cell.cfg["reference"])
    model, device = cell.cfg["model"], cell.device
    min_p = cell.cfg["sampler"]["min_p"]
    temp = max(cell.cfg["sampler"]["temperature"], 1e-6)
    wrong, groups = 0, {}
    for i, toks in sample:
        prompt, new = plain[i]
        if (toks is None or len(toks) != new
                or not all(0 <= t < model["vocab"] for t in toks)):
            wrong += 1
            continue
        groups.setdefault((len(prompt), new), []).append((prompt, toks))
    logit_gap = token_gap = 0.0 if groups else math.inf
    served = 0
    g = data.generator(derive(cell.seed, 5), device)
    for (length, new), reqs in groups.items():
        prompts = torch.from_numpy(np.stack([p for p, _ in reqs]).astype(
            np.int64)).to(device)
        tokens = torch.tensor([t for _, t in reqs], dtype=torch.int64,
                              device=device)
        mine = None if cell.control else _replay(
            cell, flat, reqs, _fillers(cell, plain, sample, length, new,
                                       len(reqs)))
        for j in range(len(reqs)):
            seq = torch.cat([prompts[j], tokens[j, :-1]])
            want = ref.logits(flat, model, seq, start=length - 1)
            if cell.control:
                got = ref.logits(flat, model, seq, start=length - 1,
                                 cast=fp8)
                drawn = _min_p_draws(got / temp, min_p, g)
            else:
                got, drawn = mine[j], tokens[j]
            d = (got - want).abs().max()
            logit_gap = max(logit_gap, float(d) if torch.isfinite(d)
                            else math.inf)
            scaled = want / temp
            tau = scaled.amax(-1) + log_f32(min_p)
            below = tau - scaled.gather(-1, drawn[:, None])[:, 0]
            token_gap = max(token_gap, float(below.max()))
            served += new
            del want, got
    found = {"wrong_requests": wrong, "logit_gap": logit_gap,
             "token_gap": token_gap, "checked": len(sample),
             "tokens": served}
    return check.judged(found, dict(cell.cfg["limits"])), found


def control(cell, seconds: float) -> dict:
    """The control's numbers over what a window of ``seconds`` served."""
    from clutchbench.run import run_cell

    result, _ = run_cell(cell.manifest, cell.name, cell.seed, seconds,
                         False, cell.device, cell.overrides, control=True)
    return result["checks"]
