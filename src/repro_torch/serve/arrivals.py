"""Open-loop arrival generation for the PuD serving layer.

Counterpart of the reference package's ``serve/arrivals.py``, over
:mod:`repro_torch.pud.queries`.  The same seed gives the same arrivals
as the reference, float for float, and a trace file either package
writes loads in the other.

Serving model (generation side)
-------------------------------
An :class:`Arrival` is a :class:`~repro_torch.serve.pud_service.PudRequest`
stamped with an *absolute* arrival time on the simulated clock and a
priority-class name.  Arrivals are generated **open-loop**: timestamps
come from the arrival process alone (Poisson, bursty on/off, or a
replayed trace file), never from the server's completion times -- so
overload actually builds a backlog instead of silently throttling the
generator, which is what makes goodput-vs-offered-load curves
meaningful (the closed-loop ``PudService.flush`` harness cannot show
saturation).

A :class:`WorkloadMix` describes WHAT arrives: which table/forest
resources, the Q1-Q5/Compound query blend, the predict share, and the
priority classes (each with an arrival share and a relative
``deadline_ns`` SLO).  Everything is driven by one seeded
``numpy.random.Generator`` -- same seed, same trace, byte-for-byte.

Traces round-trip through JSON lines (:func:`save_trace` /
:func:`load_trace`); queries serialize via their wire tuples and
rebuild with :func:`query_from_tuple`, so a captured trace replays
bit-identically on another checkout.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Iterable, Sequence

import numpy as np

from repro_torch.pud.queries import Q1, Q2, Q3, Q4, Q5, Compound

from .pud_service import PudRequest


@dataclass(frozen=True)
class ClassSpec:
    """One priority class: its admission ``weight`` (relative service
    share under load), its arrival ``share`` (fraction of generated
    requests), and its relative ``deadline_ns`` SLO (``None`` = no
    deadline; the request can never be late)."""

    name: str
    weight: float = 1.0
    share: float = 1.0
    deadline_ns: float | None = None


@dataclass(frozen=True)
class Arrival:
    """One open-loop arrival: a request, its absolute arrival time on
    the simulated clock, and its priority class."""

    arrive_ns: float
    cls: str
    request: PudRequest

    @property
    def rid(self) -> int:
        return self.request.rid

    @property
    def deadline_abs_ns(self) -> float | None:
        """Absolute deadline: arrival time + the class's relative SLO
        budget carried on the request (``None`` = no deadline)."""
        if self.request.deadline_ns is None:
            return None
        return self.arrive_ns + self.request.deadline_ns


def query_from_tuple(t) -> Q1 | Q2 | Q3 | Q4 | Q5 | Compound:
    """Inverse of ``Query.to_tuple()`` (JSON lists accepted), used to
    rebuild queries when replaying a saved trace."""
    t = tuple(t)
    name = t[0]
    if name == "q1":
        return Q1(*map(int, t[1:]))
    if name == "q2":
        return Q2(*map(int, t[1:]))
    if name == "q3":
        return Q3(*map(int, t[1:]))
    if name == "q4":
        return Q4(*map(int, t[1:]))
    if name == "q5":
        return Q5(*map(int, t[1:]))
    if name == "compound":
        _, count, merge, ops, terms = t
        return Compound(terms=tuple(query_from_tuple(tt) for tt in terms),
                        ops=tuple(ops), count=bool(count), merge=merge)
    raise ValueError(f"unknown query tuple {t!r}")


@dataclass
class WorkloadMix:
    """What the arrival process generates.

    ``table`` / ``forest`` are session resource names; ``predict_frac``
    of requests are GBDT inference batches against the forest
    (``predict_batch`` instances each, features uniform in ``[0,
    v_max]``), the rest are queries drawn uniformly from ``kinds``
    with bounds that select a wide middle band (so Q4/Q5 averages stay
    well-defined).  ``classes`` gives the priority blend; each arrival
    samples its class by ``share`` and inherits that class's relative
    ``deadline_ns``."""

    table: str
    forest: str | None = None
    n_features: int = 8
    v_max: int = 255
    predict_frac: float = 0.0
    predict_batch: int = 4
    kinds: Sequence[str] = ("q1", "q2", "q3", "q4", "q5", "compound")
    classes: Sequence[ClassSpec] = field(
        default_factory=lambda: (ClassSpec("default"),))

    def _bounds(self, rng) -> tuple[int, int]:
        lo = int(rng.integers(0, max(self.v_max // 2, 1)))
        hi = int(rng.integers(self.v_max // 2 + 1, self.v_max + 1))
        return lo, hi

    def _feat(self, rng) -> int:
        return int(rng.integers(0, self.n_features))

    def sample_query(self, rng):
        kind = self.kinds[int(rng.integers(0, len(self.kinds)))]
        lo, hi = self._bounds(rng)
        if kind == "q1":
            return Q1(self._feat(rng), lo, hi)
        lo2, hi2 = self._bounds(rng)
        if kind == "q2":
            return Q2(self._feat(rng), lo, hi, self._feat(rng), lo2, hi2)
        if kind == "q3":
            return Q3(self._feat(rng), lo, hi, self._feat(rng), lo2, hi2)
        if kind == "q4":
            return Q4(self._feat(rng), self._feat(rng), lo, hi,
                      self._feat(rng), lo2, hi2)
        if kind == "q5":
            return Q5(self._feat(rng), self._feat(rng), self._feat(rng),
                      lo, hi, self._feat(rng), lo2, hi2)
        if kind == "compound":
            n_terms = int(rng.integers(2, 4))
            terms = tuple(Q1(self._feat(rng), *self._bounds(rng))
                          for _ in range(n_terms))
            ops = tuple("and" if rng.random() < 0.5 else "or"
                        for _ in range(n_terms - 1))
            return Compound(terms=terms, ops=ops, count=True, merge="dram")
        raise ValueError(f"unknown query kind {kind!r}")

    def sample_class(self, rng) -> ClassSpec:
        shares = np.array([c.share for c in self.classes], float)
        shares /= shares.sum()
        return self.classes[int(rng.choice(len(self.classes), p=shares))]

    def sample_request(self, rng, rid: int,
                       arrive_ns: float) -> Arrival:
        spec = self.sample_class(rng)
        if self.forest is not None and rng.random() < self.predict_frac:
            X = rng.integers(0, self.v_max + 1,
                             (self.predict_batch, self.n_features))
            req = PudRequest(rid=rid, resource=self.forest, X=X,
                             deadline_ns=spec.deadline_ns)
        else:
            req = PudRequest(rid=rid, resource=self.table,
                             query=self.sample_query(rng),
                             deadline_ns=spec.deadline_ns)
        return Arrival(arrive_ns=arrive_ns, cls=spec.name, request=req)


def poisson_arrivals(mix: WorkloadMix, rate_rps: float, n: int,
                     seed: int = 0, start_ns: float = 0.0,
                     rid_base: int = 0) -> list[Arrival]:
    """``n`` Poisson arrivals at ``rate_rps`` requests/second of
    simulated time (exponential inter-arrival gaps), fixed seed."""
    if rate_rps <= 0:
        raise ValueError(f"rate must be positive, got {rate_rps}")
    rng = np.random.default_rng(seed)
    t = start_ns
    out = []
    for i in range(n):
        t += float(rng.exponential(1e9 / rate_rps))
        out.append(mix.sample_request(rng, rid_base + i, t))
    return out


def bursty_arrivals(mix: WorkloadMix, rate_rps: float, n: int,
                    seed: int = 0, on_ns: float = 2e6,
                    off_ns: float = 2e6, burst_factor: float = 4.0,
                    start_ns: float = 0.0,
                    rid_base: int = 0) -> list[Arrival]:
    """On/off (bursty) arrivals with the SAME average rate as
    :func:`poisson_arrivals` at ``rate_rps``: during an ``on_ns``
    window the instantaneous rate is ``burst_factor *`` the average
    (Poisson gaps); ``off_ns`` windows are silent.  The duty cycle is
    rescaled so offered load matches the nominal rate, letting load
    sweeps compare smooth vs bursty at identical offered load."""
    if burst_factor <= 1.0:
        raise ValueError("burst_factor must exceed 1")
    rng = np.random.default_rng(seed)
    # on-fraction making (burst_factor * rate) * duty == rate
    duty = 1.0 / burst_factor
    period = on_ns + off_ns
    on_eff = period * duty
    hot_rate = rate_rps * burst_factor
    t = start_ns
    out = []
    for i in range(n):
        t += float(rng.exponential(1e9 / hot_rate))
        # skip the silent tail of each on/off period
        while (t - start_ns) % period >= on_eff:
            t = start_ns + ((t - start_ns) // period + 1) * period
            t += float(rng.exponential(1e9 / hot_rate))
        out.append(mix.sample_request(rng, rid_base + i, t))
    return out


# --------------------------------------------------------------------- #
# Replayable trace files (JSON lines)
# --------------------------------------------------------------------- #
def save_trace(path: str, arrivals: Iterable[Arrival]) -> None:
    """Serialize arrivals to a JSON-lines trace replayable with
    :func:`load_trace` (queries via wire tuples, instances inline)."""
    with open(path, "w") as f:
        for a in arrivals:
            req = a.request
            rec = {
                "rid": req.rid,
                "arrive_ns": a.arrive_ns,
                "cls": a.cls,
                "resource": req.resource_name,
                "deadline_ns": req.deadline_ns,
                "query": list(req.query.to_tuple())
                if req.query is not None else None,
                "X": np.asarray(req.X).tolist()
                if req.X is not None else None,
            }
            f.write(json.dumps(rec) + "\n")


def load_trace(path: str) -> list[Arrival]:
    """Rebuild a :func:`save_trace` file into arrivals (queries via
    :func:`query_from_tuple`), sorted by arrival time."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            req = PudRequest(
                rid=int(rec["rid"]), resource=rec["resource"],
                query=query_from_tuple(rec["query"])
                if rec["query"] is not None else None,
                X=np.asarray(rec["X"])
                if rec["X"] is not None else None,
                deadline_ns=rec["deadline_ns"])
            out.append(Arrival(arrive_ns=float(rec["arrive_ns"]),
                               cls=rec["cls"], request=req))
    return sorted(out, key=lambda a: a.arrive_ns)
