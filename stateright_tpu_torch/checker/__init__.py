"""Checker builder, result surface, host checkers and paths
(``stateright_tpu/checker/``)."""

from .base import JOB_BLOCK_SIZE, Checker, CheckerBuilder
from .path import Path
from .visitor import CheckerVisitor, FnVisitor, PathRecorder, StateRecorder

__all__ = [
    "Checker",
    "CheckerBuilder",
    "JOB_BLOCK_SIZE",
    "Path",
    "CheckerVisitor",
    "FnVisitor",
    "PathRecorder",
    "StateRecorder",
]
