"""The MoE FFNs' host microseconds a traced call: the program's
``lm.moe`` spans (each sparse-expert FFN in a decode step or a
prefill), tallied while the profiler records."""

from clutchbench.tally import per_request_us


def read(s: dict):
    return per_request_us(s, ["lm.moe"])
