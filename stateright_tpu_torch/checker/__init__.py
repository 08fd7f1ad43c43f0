"""Checker builder, result surface and paths (``stateright_tpu/checker/``)."""

from .base import Checker, CheckerBuilder
from .path import Path

__all__ = ["Checker", "CheckerBuilder", "Path"]
