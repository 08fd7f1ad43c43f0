"""Test-support machinery shipped with the port (not test code): the
deterministic fault-injection layer (``faults.py``; JAX
``stateright_tpu/testing/``)."""

from . import faults  # noqa: F401

__all__ = ["faults"]
