"""Declarative query descriptions for the :mod:`repro_torch.pud` session.

``Q1``-``Q5`` describe the paper's section 6.2 benchmark queries;
``Compound`` composes Q1/Q2/Q3 terms with explicit connectives.  They
are the same dataclasses as the reference package's ``pud/queries.py``
(same fields, same wire tuples), with ``reference`` computed by the
port's own :mod:`repro_torch.apps.predicate`:

    session.query(table, Q1(fi=0, x0=10, x1=90))
    session.query(table, [Q2(...), Q3(...), Q5(...)])

Each query knows its wire form (:meth:`to_tuple`, the executor's batch
format), its NumPy ground truth (:meth:`reference`), and how to compare
a result against it (:meth:`check` -- exact for bitmaps and counts,
1e-9-tolerant for Q4's float average).

Semantics (bounds are exclusive, matching the paper):

* ``Q1``  -- WHERE x0 < f_i < x1                       -> bool bitmap
* ``Q2``  -- WHERE range(f_i) AND range(f_j)           -> bool bitmap
* ``Q3``  -- COUNT(WHERE range(f_i) OR range(f_j))     -> int
* ``Q4``  -- AVERAGE(f_k) over Q2's WHERE              -> float
* ``Q5``  -- WITH avg = AVERAGE(f_k) over Q3's WHERE:
             COUNT(WHERE avg < f_l < 2*avg)            -> int
  (the phase-2 scan's bounds exist only after a host round trip)

``Compound((q1, q2, q3), ("and", "or"))`` is ``q1 AND q2 OR q3``,
left-associative: each term's bitmap first (Q2's internal AND, Q3's
internal OR), then the connectives.  ``count=True`` returns the row
count instead of the bitmap.  ``merge`` names the reference DRAM
model's combine strategy (``"dram"`` or ``"host"``); the port runs
every compound as one kernel launch, so both give the same result.
"""

from __future__ import annotations

from dataclasses import dataclass


class _QueryBase:
    def check(self, table, got) -> bool:
        """Whether ``got`` (a session/job result) matches this query's
        NumPy ground truth over ``table``: element-exact for bitmaps
        (Q1/Q2) and counts (Q3/Q5), 1e-9-tolerant for the float
        average (Q4)."""
        want = self.reference(table)
        if hasattr(want, "all"):
            return bool((got == want).all())
        if isinstance(want, float):
            return abs(got - want) < 1e-9
        return got == want


@dataclass(frozen=True)
class Q1(_QueryBase):
    fi: int
    x0: int
    x1: int

    def to_tuple(self) -> tuple:
        return ("q1", self.fi, self.x0, self.x1)

    def reference(self, table):
        from repro_torch.apps.predicate import reference_q1
        return reference_q1(table, self.fi, self.x0, self.x1)


@dataclass(frozen=True)
class Q2(_QueryBase):
    fi: int
    x0: int
    x1: int
    fj: int
    y0: int
    y1: int

    def to_tuple(self) -> tuple:
        return ("q2", self.fi, self.x0, self.x1, self.fj, self.y0, self.y1)

    def reference(self, table):
        from repro_torch.apps.predicate import reference_q2
        return reference_q2(table, self.fi, self.x0, self.x1,
                            self.fj, self.y0, self.y1)


@dataclass(frozen=True)
class Q3(_QueryBase):
    fi: int
    x0: int
    x1: int
    fj: int
    y0: int
    y1: int

    def to_tuple(self) -> tuple:
        return ("q3", self.fi, self.x0, self.x1, self.fj, self.y0, self.y1)

    def reference(self, table):
        from repro_torch.apps.predicate import reference_q3
        return reference_q3(table, self.fi, self.x0, self.x1,
                            self.fj, self.y0, self.y1)


@dataclass(frozen=True)
class Q4(_QueryBase):
    fk: int
    fi: int
    x0: int
    x1: int
    fj: int
    y0: int
    y1: int

    def to_tuple(self) -> tuple:
        return ("q4", self.fk, self.fi, self.x0, self.x1,
                self.fj, self.y0, self.y1)

    def reference(self, table):
        from repro_torch.apps.predicate import reference_q4
        return reference_q4(table, self.fk, self.fi, self.x0, self.x1,
                            self.fj, self.y0, self.y1)


@dataclass(frozen=True)
class Q5(_QueryBase):
    fl: int
    fk: int
    fi: int
    x0: int
    x1: int
    fj: int
    y0: int
    y1: int

    def to_tuple(self) -> tuple:
        return ("q5", self.fl, self.fk, self.fi, self.x0, self.x1,
                self.fj, self.y0, self.y1)

    def reference(self, table):
        from repro_torch.apps.predicate import reference_q5
        return reference_q5(table, self.fl, self.fk, self.fi, self.x0,
                            self.x1, self.fj, self.y0, self.y1)


def _term_bitmap(table, term: "Q1 | Q2 | Q3"):
    """NumPy ground-truth bitmap of ONE compound term.  A Q3 term is
    its WHERE clause (range OR range) -- the COUNT applies only when
    Q3 runs standalone."""
    from repro_torch.apps.predicate import reference_q1, reference_q2
    if isinstance(term, Q1):
        return reference_q1(table, term.fi, term.x0, term.x1)
    if isinstance(term, Q2):
        return reference_q2(table, term.fi, term.x0, term.x1,
                            term.fj, term.y0, term.y1)
    return reference_q1(table, term.fi, term.x0, term.x1) \
        | reference_q1(table, term.fj, term.y0, term.y1)


@dataclass(frozen=True)
class Compound(_QueryBase):
    """``terms[0] <ops[0]> terms[1] <ops[1]> ...``, left-associative.

    ``terms`` are Q1/Q2/Q3 instances (each contributes its WHERE-clause
    bitmap); ``ops`` are ``len(terms) - 1`` connectives from
    ``{"and", "or"}``.  ``merge`` (``"dram"`` or ``"host"``) is kept in
    the wire tuple for parity with the reference; the port's single
    launch gives the same result for both.  ``count=True`` returns the
    matching-row count instead of the bitmap."""

    terms: tuple
    ops: tuple[str, ...]
    count: bool = False
    merge: str = "dram"

    def __post_init__(self):
        if not self.terms:
            raise ValueError("Compound needs at least one term")
        if any(not isinstance(t, (Q1, Q2, Q3)) for t in self.terms):
            raise TypeError("Compound terms must be Q1/Q2/Q3 instances")
        if len(self.ops) != len(self.terms) - 1:
            raise ValueError(
                f"need {len(self.terms) - 1} connectives, got "
                f"{len(self.ops)}")
        if any(op not in ("and", "or") for op in self.ops):
            raise ValueError(f"connectives must be 'and'/'or': {self.ops}")
        if self.merge not in ("dram", "host"):
            raise ValueError(f"merge must be 'dram' or 'host': {self.merge}")

    def to_tuple(self) -> tuple:
        return ("compound", self.count, self.merge, tuple(self.ops),
                tuple(t.to_tuple() for t in self.terms))

    def reference(self, table):
        bm = _term_bitmap(table, self.terms[0])
        for op, term in zip(self.ops, self.terms[1:]):
            nxt = _term_bitmap(table, term)
            bm = (bm & nxt) if op == "and" else (bm | nxt)
        return int(bm.sum()) if self.count else bm


Query = Q1 | Q2 | Q3 | Q4 | Q5 | Compound
