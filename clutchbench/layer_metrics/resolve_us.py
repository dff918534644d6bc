"""Index resolution's microseconds a request: the ``pud.resolve`` spans
(Algorithm 1 and its caches; a forest's per-feature resolution)."""

from clutchbench.tally import per_request_us


def read(s: dict):
    return per_request_us(s, ["pud.resolve"])
