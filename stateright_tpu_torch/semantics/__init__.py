"""Consistency semantics (reference L7: ``src/semantics.rs`` + ``src/semantics/``).

The port's own copy of ``stateright_tpu/semantics/__init__.py``, cut to
what the ported models check: :class:`SequentialSpec`,
:class:`ConsistencyTester`, the register and write-once register specs and
the linearizability tester.  The vector spec and the sequential
consistency tester come with the slices that check them.

Correctness of a concurrent system is defined against a *sequential
reference object* (:class:`SequentialSpec`): "this system should behave like
a register".  A :class:`ConsistencyTester` records a potentially concurrent
operation history — invocations and returns per abstract thread — and
decides whether some legal total order explains it.

The testers run *inside* the checker as auxiliary history state: an
``ActorModel`` threads one through ``record_msg_in``/``record_msg_out`` and a
property asks ``is_consistent()`` per state (reference
``examples/paxos.rs:252-254``).  System states are immutable, so testers are
persistent values: ``on_invoke``/``on_return`` return a *new* tester.

Ops and returns are plain tuples (``("write", v)`` / ``("write_ok",)``).
"""

from __future__ import annotations

from typing import Any, Iterable, Tuple

__all__ = [
    "SequentialSpec",
    "ConsistencyTester",
    "Register",
    "WORegister",
    "LinearizabilityTester",
]


class SequentialSpec:
    """A sequential reference object (reference ``semantics.rs:73-99``).
    Persistent: ``invoke`` returns ``(next_spec, ret)``."""

    def invoke(self, op) -> Tuple["SequentialSpec", Any]:
        raise NotImplementedError

    def is_valid_step(self, op, ret) -> Tuple[bool, "SequentialSpec"]:
        nxt, actual = self.invoke(op)
        return actual == ret, nxt

    def is_valid_history(self, ops_rets: Iterable[Tuple[Any, Any]]) -> bool:
        spec = self
        for op, ret in ops_rets:
            ok, spec = spec.is_valid_step(op, ret)
            if not ok:
                return False
        return True


class ConsistencyTester:
    """Records per-thread invocations/returns; decides consistency
    (reference ``consistency_tester.rs:15-38``).  Persistent interface."""

    def on_invoke(self, thread_id, op) -> "ConsistencyTester":
        raise NotImplementedError

    def on_return(self, thread_id, ret) -> "ConsistencyTester":
        raise NotImplementedError

    def on_invret(self, thread_id, op, ret) -> "ConsistencyTester":
        return self.on_invoke(thread_id, op).on_return(thread_id, ret)

    def is_consistent(self) -> bool:
        raise NotImplementedError


from .register import Register  # noqa: E402
from .linearizability import LinearizabilityTester  # noqa: E402
from .write_once_register import WORegister  # noqa: E402
