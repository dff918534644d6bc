"""Kernels the profiler saw in the traced calls, the program's and
PyTorch's alike, a serving call: the mix's ``trace_calls`` are decode
steps of every slot, with no prefill in them."""


def read(s: dict):
    if s["entry"] != "generate" or s["steps"] <= 0:
        return None
    return s["kernels"] / s["steps"]
