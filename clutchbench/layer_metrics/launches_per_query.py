"""Kernels the profiler saw in the window, the program's and PyTorch's
alike, a query."""


def read(s: dict):
    if s["entry"] != "query" or s["requests"] <= 0:
        return None
    return s["kernels"] / s["requests"]
