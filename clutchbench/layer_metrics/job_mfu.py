"""The whole job's share of the chip's peak: the least time for the
window's requests (counted from the requests by ``work.py``) over the
window's wall-clock."""


def read(s: dict):
    if s["window_s"] <= 0:
        return None
    return 100.0 * s["least_s"] / s["window_s"]
