"""The least time the chip could take for the window's requests
(counted from the requests by ``work.py``) over the device time of
every kernel in the window."""


def read(s: dict):
    if s["kernel_s"] <= 0:
        return None
    return 100.0 * s["least_s"] / s["kernel_s"]
