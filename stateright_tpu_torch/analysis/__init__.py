"""The port's analysis stack (JAX ``stateright_tpu/analysis/``).

 - the audit report (``report.py``), the actor-handler lint
   (``handler_lint.py``) and the config-lifecycle rules with the audit
   driver (``audit.py``: the ``spawn_gpu`` preflight);
 - the graph passes, on a kernel captured with ``make_fx``
   (``graph.py``): the kernel audit (``kernel_audit.py``: JX000-JX107),
   the interval sanitizer (``interval.py``, ``sanitizer.py``'s static
   half: JX200-JX205) with checked mode, its dynamic guard
   (``sanitizer.py``), the footprint pass (``footprint.py``), the
   independence analysis that plans partial-order reduction
   (``independence.py``: JX300-JX305) and the cost model
   (``costmodel.py``: the stages' FLOPs and bytes, JX400-JX402).
"""

from .audit import audit_model, config_signature
from .costmodel import CostReport, kernel_cost, wavefront_costs
from .footprint import extract_footprints
from .kernel_audit import run_kernel_audit
from .independence import por_plan, run_independence
from .report import AuditError, AuditFinding, AuditReport, Severity
from .sanitizer import (
    CheckedExecutionError,
    CheckedGuard,
    checked_kernels,
    error_flag,
    localize_checked_failure,
    run_sanitizer,
)

__all__ = [
    "AuditError",
    "AuditFinding",
    "AuditReport",
    "CheckedExecutionError",
    "CheckedGuard",
    "CostReport",
    "Severity",
    "audit_model",
    "checked_kernels",
    "config_signature",
    "error_flag",
    "extract_footprints",
    "kernel_cost",
    "localize_checked_failure",
    "por_plan",
    "run_independence",
    "run_kernel_audit",
    "run_sanitizer",
    "wavefront_costs",
]
