"""Kernels the profiler saw in the window, the program's and PyTorch's
alike, a predict request."""


def read(s: dict):
    if s["entry"] != "predict" or s["requests"] <= 0:
        return None
    return s["kernels"] / s["requests"]
