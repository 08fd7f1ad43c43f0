"""The port's analysis stack (JAX ``stateright_tpu/analysis/``): the
dynamic half of the sanitizer, checked execution mode (``sanitizer.py``),
and the passes that need no traced graph: the audit report
(``report.py``), the actor-handler lint (``handler_lint.py``) and the
config-lifecycle rules with the audit driver (``audit.py``).  The graph
passes come with the ROADMAP item "the analysis stack"."""

from .audit import audit_model, config_signature
from .report import AuditError, AuditFinding, AuditReport, Severity
from .sanitizer import (
    CheckedExecutionError,
    CheckedGuard,
    checked_kernels,
    error_flag,
    localize_checked_failure,
)

__all__ = [
    "AuditError",
    "AuditFinding",
    "AuditReport",
    "CheckedExecutionError",
    "CheckedGuard",
    "Severity",
    "audit_model",
    "checked_kernels",
    "config_signature",
    "error_flag",
    "localize_checked_failure",
]
