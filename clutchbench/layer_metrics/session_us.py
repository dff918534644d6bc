"""The session's own microseconds a request: ``pud.query`` or
``pud.predict`` less the ``pud.*`` steps inside it (executor lookup, the
wire tuples, the final synchronise)."""

from clutchbench.tally import of, per_request_us


def read(s: dict):
    outer = "pud.query" if s["entry"] == "query" else "pud.predict"
    job = per_request_us(s, [outer])
    if job is None:
        return None
    steps = [n for n in of(s)["spans"] if n.startswith("pud.") and n != outer]
    return job - (per_request_us(s, steps) or 0.0)
