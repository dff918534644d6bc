"""Bytes copied from the card to the host an instance scored (the
profiler's device-to-host copies)."""


def read(s: dict):
    if s["entry"] != "predict" or s["rows"] <= 0:
        return None
    return s["d2h_bytes"] / s["rows"]
