"""The whole job's share of the chip's peak in a language-model cell:
the least time for the window's calls that the profiler did not
record (counted from the built tensors by ``work.DecoderWork``), over
those calls' own seconds; the traced stretch, which the profiler's
records slow, is left out."""


def read(s: dict):
    if s.get("job_s", 0) <= 0:
        return None
    return 100.0 * s["job_least_s"] / s["job_s"]
