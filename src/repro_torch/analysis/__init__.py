"""Static analysis of PuD command streams and scheduled timelines.

The reference package's ``analysis`` under the same names.  ``pudlint``
verifies recorded :class:`~repro_torch.core.machine.CommandTrace`
streams and scheduled :class:`~repro_torch.core.scheduler.Timeline`\\ s
*without executing them*: per-bank row-state dataflow (PL1xx),
inter-segment hazard/race detection (PL2xx), protocol/capability
conformance on placed waves (PL3xx), serving-layer admission
conformance (PL4xx -- dispatched requests whose admitted deadline
precedes their predicted start), and adaptive-representation
conformance (PL5xx -- encoded LUT layouts versus the session's
declared per-column plans).  ``mutations`` is the seeded-fault
harness proving the analyzer is non-vacuous.
"""

from .pudlint import (
    CODES,
    Diagnostic,
    LintReport,
    PudLintError,
    TraceCollector,
    clone_confinement_diags,
    enforce,
    lint_device,
    lint_stream,
    lint_streams,
    lint_subarray,
    lint_timeline,
    representation_diags,
    serving_admission_diags,
    wave_accesses,
)

__all__ = [
    "CODES",
    "Diagnostic",
    "LintReport",
    "PudLintError",
    "TraceCollector",
    "clone_confinement_diags",
    "enforce",
    "lint_device",
    "lint_stream",
    "lint_streams",
    "lint_subarray",
    "lint_timeline",
    "representation_diags",
    "serving_admission_diags",
    "wave_accesses",
]
