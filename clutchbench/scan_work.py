"""The least time of the selective scan's launches, from the program's
counters alone (``repro_torch.kernels.selective_scan`` counts them from
the shapes on the host while a profiler records):

* ``ssm.scan_channels``: (token, channel) elements; each reads x, dt and
  z and writes y once, 2 bytes each (bfloat16 activations);
* ``ssm.scan_states``: float32 state elements written, and read where a
  state came in, 4 bytes each.

Left out, so the bound stays a lower bound: B and C (2 * d_state
elements a token, under 0.1 % of a token's bytes at d_inner 8,192) and
the per-channel parameters.  Bytes bound it: the arithmetic, about 100
float32 operations a (token, channel) element (an exp and three
products for each of 16 state elements, the softplus and the gate),
takes 1.5 ps at the card's 67 T/s against 2.4 ps for its 8 bytes.  (The
exps run on the special-function units, slower than that rate; this
bound leaves that out.)
"""

from __future__ import annotations

from clutchbench.work import PEAK_BYTES_S

ACT_BYTES = 2
STATE_BYTES = 4


def least_bytes(counters: dict) -> float:
    return (4 * ACT_BYTES * counters.get("ssm.scan_channels", 0)
            + STATE_BYTES * counters.get("ssm.scan_states", 0))


def least_seconds(counters: dict) -> float:
    """Least seconds of the scans counted in ``counters``."""
    return least_bytes(counters) / PEAK_BYTES_S
