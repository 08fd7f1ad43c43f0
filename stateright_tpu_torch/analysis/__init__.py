"""The port's analysis stack: for now the dynamic half of the sanitizer,
checked execution mode (``sanitizer.py``; JAX ``stateright_tpu/analysis/``).
The static passes come with the ROADMAP item "the analysis stack"."""

from .sanitizer import (
    CheckedExecutionError,
    CheckedGuard,
    checked_kernels,
    error_flag,
    localize_checked_failure,
)

__all__ = [
    "CheckedExecutionError",
    "CheckedGuard",
    "checked_kernels",
    "error_flag",
    "localize_checked_failure",
]
