"""The port's analysis stack (JAX ``stateright_tpu/analysis/``): the
dynamic half of the sanitizer, checked execution mode (``sanitizer.py``),
and the passes that need no traced graph: the audit report
(``report.py``), the actor-handler lint (``handler_lint.py``) and the
config-lifecycle rules with the audit driver (``audit.py``); and the
first graph passes, on a kernel captured with ``make_fx``
(``graph.py``): the footprint pass (``footprint.py``) and the
independence analysis that plans partial-order reduction
(``independence.py``).  The other graph passes come with the ROADMAP item
"the analysis stack"."""

from .audit import audit_model, config_signature
from .footprint import extract_footprints
from .independence import por_plan, run_independence
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
    "extract_footprints",
    "localize_checked_failure",
    "por_plan",
    "run_independence",
]
