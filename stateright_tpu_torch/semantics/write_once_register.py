"""Write-once register semantics (reference ``src/semantics/write_once_register.rs``).

The port's own copy of ``stateright_tpu/semantics/write_once_register.py``.

A write succeeds if the register is empty or already holds an equal value;
otherwise it fails with ``("write_fail",)``.  Reads return
``("read_ok", value_or_None)``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

from . import SequentialSpec

WRITE_OK = ("write_ok",)
WRITE_FAIL = ("write_fail",)


@dataclass(frozen=True)
class WORegister(SequentialSpec):
    value: Optional[Any] = None

    def invoke(self, op):
        if op[0] == "write":
            if self.value is None or self.value == op[1]:
                return WORegister(op[1]), WRITE_OK
            return self, WRITE_FAIL
        if op[0] == "read":
            return self, ("read_ok", self.value)
        raise ValueError(f"unknown WO-register op {op!r}")

    def is_valid_step(self, op, ret):
        if op[0] == "write":
            if self.value is None:
                return ret == WRITE_OK, WORegister(op[1])
            if self.value == op[1]:
                return ret == WRITE_OK, self
            return ret == WRITE_FAIL, self
        if op[0] == "read":
            return ret == ("read_ok", self.value), self
        return False, self
