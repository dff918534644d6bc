"""The query generator: draws a cell's queries from the seed by the
entries of its mix file.

A query request is a plain tuple in column indices of the
configuration, with the paper's exclusive bounds ``x0 < f < x1``:

    ("q1", f, x0, x1)
    ("q2" | "q3", fi, x0, x1, fj, y0, y1)
    ("q4", fk, fi, x0, x1, fj, y0, y1)
    ("q5", fl, fk, fi, x0, x1, fj, y0, y1)
    ("compound", count, ops, terms)          terms: q1/q2/q3 tuples

Queries come in blocks of ``block`` requests, each entry as many times
a block as its ``share`` gives.  An entry names its query (``Q1``-``Q5``
or ``compound``) and its ranges, each in one of these forms (bounds
inclusive where TPC-H states them so, mapped to ``x0 < f < x1``):

* ``fresh``: two distinct draws inside the column's declared range; no
  column and bounds are drawn twice in a run.
* ``between``: ``D`` uniform in ``lo``; selects ``D <= f <= D + width``.
* ``below``: ``Q`` uniform in ``limit``; selects ``f < Q``.
* ``date_span``: a start uniform over the ``unit`` (year or month)
  starts from ``first`` to ``last``; selects ``[start, start + unit)``.
* ``date_upto``: ``DELTA`` uniform in ``minus_days``; selects
  ``f <= date - DELTA``.

``col`` ``"*"`` draws a column among those the mix lists under the key
that ``among`` names (every column where ``among`` is not given),
distinct from the query's other ranges.  Draws come from
``random.Random``, whose sequence for a given seed is the same in every
Python release.
"""

from __future__ import annotations

import random

from clutchbench.data import day, derive

ENTRY = "query"


def _uniform(rng, bounds) -> int:
    lo, hi = bounds if isinstance(bounds, (list, tuple)) else (bounds,
                                                                bounds)
    return rng.randint(lo, hi)


def _month_starts(first: str, last: str) -> list[str]:
    y, m = int(first[:4]), int(first[5:7])
    out = []
    while f"{y:04d}-{m:02d}-01" <= last:
        out.append(f"{y:04d}-{m:02d}-01")
        y, m = (y + 1, 1) if m == 12 else (y, m + 1)
    return out


def _next(start: str, unit: str) -> str:
    y, m = int(start[:4]), int(start[5:7])
    if unit == "year":
        return f"{y + 1:04d}-{m:02d}-01"
    y, m = (y + 1, 1) if m == 12 else (y, m + 1)
    return f"{y:04d}-{m:02d}-01"


class Generator:
    """A query mix bound to a configuration and a run's seed."""

    entry = ENTRY

    def __init__(self, spec: dict, cfg: dict, seed: int, device=None
                 ) -> None:
        self.spec = spec
        self.columns = list(cfg["columns"])
        self.ranges = [tuple(cfg["columns"][c]) for c in self.columns]
        self.epoch = cfg.get("epoch", "1992-01-01")
        self.rng = random.Random(derive(seed, 1))
        self.seed = seed
        #: every ``fresh`` range drawn in this run
        self.seen: set = set()
        shares = [e["share"] for e in spec["mix"]]
        size = spec["block"]
        counts = [x * size / sum(shares) for x in shares]
        if any(c < 1 or abs(c - round(c)) > 1e-9 for c in counts):
            raise ValueError(f"the shares do not divide a block of "
                             f"{size} requests")
        #: a block's entries, each as often as its share
        self.block = [k for k, c in enumerate(counts)
                      for _ in range(round(c))]

    # ---------------------------------------------------------------- #
    def _col(self, rng, spec: dict, taken: set) -> int:
        if spec["col"] != "*":
            return self.columns.index(spec["col"])
        among = self.spec[spec["among"]] if "among" in spec \
            else self.columns
        pool = [self.columns.index(c) for c in among]
        while True:
            f = pool[rng.randrange(len(pool))]
            if f not in taken:
                return f

    def _fresh(self, rng, f: int, lo: int, hi: int) -> tuple:
        while True:
            a, b = rng.randint(max(lo - 1, 0), hi + 1), \
                rng.randint(max(lo - 1, 0), hi + 1)
            r = (f, min(a, b), max(a, b))
            if a != b and r not in self.seen:
                self.seen.add(r)
                return r

    def _range(self, rng, spec: dict, taken: set) -> tuple[int, int, int]:
        f = self._col(rng, spec, taken)
        taken.add(f)
        lo, hi = self.ranges[f]
        form = spec["form"]
        if form == "fresh":
            return self._fresh(rng, f, lo, hi)
        if form == "between":
            d = _uniform(rng, spec["lo"])
            return f, d - 1, d + spec["width"] + 1
        if form == "below":
            if lo < 1:
                raise ValueError(f"'below' needs a column whose least "
                                 f"value is at least 1: {spec['col']}")
            return f, lo - 1, _uniform(rng, spec["limit"])
        if form == "date_span":
            if spec["unit"] == "year":
                y0, y1 = int(spec["first"][:4]), int(spec["last"][:4])
                start = f"{rng.randint(y0, y1):04d}" \
                    + spec["first"][4:]
            else:
                starts = _month_starts(spec["first"], spec["last"])
                start = starts[rng.randrange(len(starts))]
            return (f, day(start, self.epoch) - 1,
                    day(_next(start, spec["unit"]), self.epoch))
        if form == "date_upto":
            if lo < 1:
                raise ValueError("'date_upto' needs a least value of 1")
            delta = _uniform(rng, spec["minus_days"])
            return f, lo - 1, day(spec["date"], self.epoch) - delta + 1
        raise ValueError(f"unknown range form {form!r}")

    def _pair(self, rng, ranges: list) -> tuple:
        taken: set = set()
        return self._range(rng, ranges[0], taken) \
            + self._range(rng, ranges[1], taken)

    def _term(self, rng, kind: str, ranges: list) -> tuple:
        if kind == "Q1":
            return ("q1",) + self._range(rng, ranges[0], set())
        return (kind.lower(),) + self._pair(rng, ranges)

    def _query(self, rng, e: dict) -> tuple:
        q = e["query"]
        if q in ("Q1", "Q2", "Q3"):
            return self._term(rng, q, e["ranges"])
        if q == "Q4":
            fk = self.columns.index(
                e["avg_of"][rng.randrange(len(e["avg_of"]))])
            return ("q4", fk) + self._pair(rng, e["ranges"])
        if q == "Q5":
            fk = self.columns.index(
                e["avg_of"][rng.randrange(len(e["avg_of"]))])
            fl = self.columns.index(e["count_of"])
            return ("q5", fl, fk) + self._pair(rng, e["ranges"])
        if q == "compound":
            terms_spec = e["terms"]
            if isinstance(terms_spec, list):
                terms = tuple(self._term(rng, t["query"], t["ranges"])
                              for t in terms_spec)
                ops = tuple(e["ops"])
            else:
                n = _uniform(rng, terms_spec["n"])
                kinds = terms_spec["kinds"]
                rs = [terms_spec["range"]] * 2
                terms = tuple(self._term(
                    rng, kinds[rng.randrange(len(kinds))], rs)
                    for _ in range(n))
                choice = e["ops_choice"]
                ops = tuple(choice[rng.randrange(len(choice))]
                            for _ in range(n - 1))
            return ("compound", bool(e.get("count", False)), ops, terms)
        raise ValueError(f"unknown query {q!r}")

    def _queries(self, rng: random.Random, n: int) -> list[tuple]:
        entries, out = self.spec["mix"], []
        while len(out) < n:
            order = list(self.block)
            rng.shuffle(order)
            out += [self._query(rng, entries[k]) for k in order]
        return out[:n]

    def draw(self, n: int) -> list[tuple]:
        """The run's next ``n`` queries: every ``block`` requests hold
        each entry its share of times, in an order drawn anew, so that
        every seed gets the same mix of work."""
        return self._queries(self.rng, n)

    def warmup(self) -> list[tuple]:
        """Every entry of the mix twice, then draws to ``warmup``."""
        rng = random.Random(derive(self.seed, 2))
        out = [self._query(rng, e) for e in self.spec["mix"]
               for _ in range(2)]
        return out + self._queries(rng, max(0, self.spec["warmup"]
                                            - len(out)))
