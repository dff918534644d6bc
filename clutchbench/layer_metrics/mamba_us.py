"""The mamba mixers' host microseconds a traced call: the program's
``lm.mamba`` spans (each block's Mamba mixer in a decode step or a
prefill), tallied while the profiler records."""

from clutchbench.tally import per_request_us


def read(s: dict):
    return per_request_us(s, ["lm.mamba"])
