"""Bytes copied from the card to the host a query (the profiler's
device-to-host copies), for cells whose answers are a few bytes."""


def read(s: dict):
    if s["entry"] != "query" or s["requests"] <= 0:
        return None
    return s["d2h_bytes"] / s["requests"]
