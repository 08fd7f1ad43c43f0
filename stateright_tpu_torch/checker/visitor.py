"""Per-evaluated-state callbacks (reference ``src/checker/visitor.rs``).

The port's own copy of ``stateright_tpu/checker/visitor.py``.  A visitor
observes every state the host checkers evaluate and receives the full
:class:`~stateright_tpu_torch.checker.path.Path` that led there.  The GPU
engine never materializes states, so it refuses visitors.
"""

from __future__ import annotations

import threading
from typing import Callable

from .path import Path


class CheckerVisitor:
    def visit(self, model, path: Path) -> None:  # pragma: no cover - interface
        raise NotImplementedError


class FnVisitor(CheckerVisitor):
    """Wrap a plain callable (reference ``visitor.rs:23-30``)."""

    def __init__(self, fn: Callable[[object, Path], None]):
        self._fn = fn

    def visit(self, model, path: Path) -> None:
        self._fn(model, path)


class PathRecorder(CheckerVisitor):
    """Records the set of visited paths (reference ``visitor.rs:46-67``)."""

    def __init__(self):
        self.paths: set[Path] = set()
        self._lock = threading.Lock()

    def visit(self, model, path: Path) -> None:
        with self._lock:
            self.paths.add(path)


class StateRecorder(CheckerVisitor):
    """Records the final states of visited paths in visit order
    (reference ``visitor.rs:81-100``)."""

    def __init__(self):
        self.states: list = []
        self._lock = threading.Lock()

    def visit(self, model, path: Path) -> None:
        with self._lock:
            self.states.append(path.final_state())
