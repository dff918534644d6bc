"""The port's session API: :class:`PudSession` (machine and fused
backends), queries, handles, and the placement :class:`Planner`."""

from .planner import Planner, Resource  # noqa: F401
from .queries import Q1, Q2, Q3, Q4, Q5, Compound, Query  # noqa: F401
from .session import (  # noqa: F401
    ForestHandle,
    JobResult,
    PudSession,
    ResourceHandle,
    TableHandle,
)
