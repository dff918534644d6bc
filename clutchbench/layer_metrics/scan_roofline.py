"""The selective-scan kernel's share of its roofline over the traced
calls: the least time for the bytes its launches move
(``clutchbench/scan_work.py``, from the program's ``ssm.scan_*``
counters) over the kernel's device time (its entry in the summary's
``device_ops``)."""

from clutchbench.scan_work import least_seconds
from clutchbench.tally import of

#: the kernel's name as the profiler records it, in part
KERNEL = "selective_scan"


def read(s: dict):
    tally = of(s)
    if not tally:
        return None
    device_s = sum(t for name, t in s["device_ops"] if KERNEL in name)
    least = least_seconds(tally["counters"])
    if device_s <= 0 or not least:
        return None
    return 100.0 * least / device_s
