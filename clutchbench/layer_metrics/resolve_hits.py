"""Share of the scalar lookups of index resolution that its caches
served: 100 * (1 - ``resolve.computed`` / ``resolve.lookups``), the
program's counts over the traced window."""

from clutchbench.tally import of


def read(s: dict):
    tally = of(s)
    if not tally or s["entry"] != "query" or s["requests"] <= 0:
        return None
    counts = tally["counters"]
    lookups = counts.get("resolve.lookups", 0)
    if lookups <= 0:
        return None
    return 100.0 * (1.0 - counts.get("resolve.computed", 0) / lookups)
