"""The PuD architecture names the port keeps as layout parameters.

The port runs no DRAM simulator; ``PuDArch`` only selects the paper's
chunk counts (:data:`repro_torch.apps.predicate.PAPER_PREDICATE_CHUNKS`)
and the row-budget fit, so the port lays tables out exactly as the
reference session would.  ``NUM_RESERVED`` is the reference subarray's
count of rows no LUT may use (compute rows, DCC row, constant rows).
"""

from __future__ import annotations

import enum

NUM_RESERVED = 8


class PuDArch(str, enum.Enum):
    UNMODIFIED = "unmodified"
    MODIFIED = "modified"  # SIMDRAM / Ambit
