"""The port's session API: :class:`PudSession`, queries and handles."""

from .queries import Q1, Q2, Q3, Q4, Q5, Compound, Query  # noqa: F401
from .session import (  # noqa: F401
    ForestHandle,
    JobResult,
    PudSession,
    TableHandle,
)
