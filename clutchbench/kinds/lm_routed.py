"""A decoder language model with sparse experts, served and judged as
kind ``lm`` is (:mod:`clutchbench.kinds.lm`), with two numbers more in
its check, over every position of the sampled requests:

* ``logit_gap_median``: the median, over positions, of each position's
  largest gap of an engine logit from the plain reference's (float32);
* ``dropped_share``: the share of positions whose drawn token lies
  below the reference's min-p threshold there (``token_gap`` above 0).

Where the experts are chosen on near-ties, a token routed otherwise in
a low precision moves its position's logits a long way, so the largest
gap over all positions (``logit_gap``) reads near what logits that no
longer agree read; the typical position does not.  The control is
``lm``'s: the reference with every weight in float8 e4m3 and its own
min-p draws.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from clutchbench import check, data
from clutchbench.data import derive
from clutchbench.kinds import lm
from clutchbench.kinds.lm import (  # noqa: F401  (the kind's interface)
    build,
    control,
    facts,
    label,
    model_config,
    values,
)


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
    gaps, belows = [], []
    g = data.generator(derive(cell.seed, 5), device)
    for (length, new), reqs in groups.items():
        prompts = torch.from_numpy(np.stack([p for p, _ in reqs]).astype(
            np.int64)).to(device)
        tokens = torch.tensor([t for _, t in reqs], dtype=torch.int64,
                              device=device)
        mine = None if cell.control else lm._replay(
            cell, flat, reqs, lm._fillers(cell, plain, sample, length, new,
                                          len(reqs)))
        for j in range(len(reqs)):
            seq = torch.cat([prompts[j], tokens[j, :-1]])
            want = ref.logits(flat, model, seq, start=length - 1)
            if cell.control:
                got = ref.logits(flat, model, seq, start=length - 1,
                                 cast=lm.fp8)
                drawn = lm._min_p_draws(got / temp, min_p, g)
            else:
                got, drawn = mine[j], tokens[j]
            gap = (got - want).abs().amax(-1)
            gaps.append(torch.where(torch.isfinite(gap), gap, math.inf))
            scaled = want / temp
            tau = scaled.amax(-1) + lm.log_f32(min_p)
            belows.append(tau - scaled.gather(-1, drawn[:, None])[:, 0])
            del want, got
    if gaps:
        gap, below = torch.cat(gaps).cpu(), torch.cat(belows).cpu()
        found = {"logit_gap": float(gap.max()),
                 "logit_gap_median": float(gap.median()),
                 "token_gap": max(0.0, float(below.max())),
                 "dropped_share": float((below > 0).float().mean())}
    else:
        found = dict.fromkeys(("logit_gap", "logit_gap_median",
                               "token_gap", "dropped_share"), math.inf)
    found.update(wrong_requests=wrong, checked=len(sample),
                 tokens=sum(len(t) for t in gaps))
    return check.judged(found, dict(cell.cfg["limits"])), found
