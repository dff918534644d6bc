"""The result path's microseconds a request: a query's ``pud.count``,
``pud.bitmap`` and ``pud.finish`` spans (the wait for the kernel, the
copy back, the unpack, the NumPy finish), a predict's ``pud.addrs`` and
``pud.assemble``."""

from clutchbench.tally import per_request_us

SPANS = {"query": ["pud.count", "pud.bitmap", "pud.finish"],
         "predict": ["pud.addrs", "pud.assemble"]}


def read(s: dict):
    return per_request_us(s, SPANS[s["entry"]])
