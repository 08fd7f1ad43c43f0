"""Register reference semantics (reference ``src/semantics/register.rs``).

The port's own copy of ``stateright_tpu/semantics/register.py``.

Ops: ``("write", v)`` / ``("read",)``.
Rets: ``("write_ok",)`` / ``("read_ok", v)``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from . import SequentialSpec


def write(v) -> tuple:
    return ("write", v)


READ = ("read",)
WRITE_OK = ("write_ok",)


def read_ok(v) -> tuple:
    return ("read_ok", v)


@dataclass(frozen=True)
class Register(SequentialSpec):
    """A simple read/write register (reference ``register.rs:10-48``)."""

    value: Any = None

    def invoke(self, op):
        if op[0] == "write":
            return Register(op[1]), WRITE_OK
        if op[0] == "read":
            return self, ("read_ok", self.value)
        raise ValueError(f"unknown register op {op!r}")

    def is_valid_step(self, op, ret):
        if op[0] == "write":
            return ret == WRITE_OK, Register(op[1])
        if op[0] == "read":
            return ret == ("read_ok", self.value), self
        return False, self
