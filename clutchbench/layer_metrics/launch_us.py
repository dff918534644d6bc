"""The kernel wrappers' microseconds a request: the ``pud.launch`` spans
(index upload, the host bounds check, the launch)."""

from clutchbench.tally import per_request_us


def read(s: dict):
    return per_request_us(s, ["pud.launch"])
