"""Stack (Vec) reference semantics (reference ``src/semantics/vec.rs``).

The port's own copy of ``stateright_tpu/semantics/vec.py``.
Ops: ``("push", v)`` / ``("pop",)`` / ``("len",)``.
Rets: ``("push_ok",)`` / ``("pop_ok", v_or_None)`` / ``("len_ok", n)``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

from . import SequentialSpec

PUSH_OK = ("push_ok",)


@dataclass(frozen=True)
class VecSpec(SequentialSpec):
    items: Tuple = ()

    def invoke(self, op):
        if op[0] == "push":
            return VecSpec(self.items + (op[1],)), PUSH_OK
        if op[0] == "pop":
            if self.items:
                return VecSpec(self.items[:-1]), ("pop_ok", self.items[-1])
            return self, ("pop_ok", None)
        if op[0] == "len":
            return self, ("len_ok", len(self.items))
        raise ValueError(f"unknown vec op {op!r}")
