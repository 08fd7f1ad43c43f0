"""Shared counter with a lock (reference ``examples/increment_lock.rs``).

The port's own copy of ``stateright_tpu/models/increment_lock.py``.  The
same as :mod:`.increment`, but each thread takes a global lock around its
read-modify-write, so ``always "fin"`` holds, and ``always "mutex"`` pins
that at most one thread is in the critical section.  The model has no
tensor form: it checks on the host engines.

Run: ``python -m stateright_tpu_torch.models.increment_lock check|check-sym|check-auto [THREAD_COUNT]``.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, replace

from ..core import Model, Property
from ._cli import (
    auto,
    check_main,
    explore,
    host_dfs,
    host_sym_dfs,
    make_independence_cmd,
)


@dataclass(frozen=True)
class LockState:
    i: int
    lock: bool
    s: tuple  # per-thread (local value t, program counter pc)

    def representative(self) -> "LockState":
        return LockState(i=self.i, lock=self.lock, s=tuple(sorted(self.s)))


@dataclass
class IncrementLock(Model):
    thread_count: int

    def init_states(self):
        return [LockState(i=0, lock=False, s=((0, 0),) * self.thread_count)]

    def actions(self, state: LockState):
        acts = []
        for n, (_t, pc) in enumerate(state.s):
            if pc == 0 and not state.lock:
                acts.append(("lock", n))
            elif pc == 1:
                acts.append(("read", n))
            elif pc == 2:
                acts.append(("write", n))
            elif pc == 3 and state.lock:
                acts.append(("release", n))
        return acts

    def next_state(self, state: LockState, action):
        kind, n = action
        s = list(state.s)
        t, pc = s[n]
        if kind == "lock":
            s[n] = (t, 1)
            return replace(state, s=tuple(s), lock=True)
        if kind == "read":
            s[n] = (state.i, 2)
            return replace(state, s=tuple(s))
        if kind == "write":
            s[n] = (t, 3)
            return replace(state, s=tuple(s), i=(t + 1) % 256)
        s[n] = (t, 4)
        return replace(state, s=tuple(s), lock=False)

    def properties(self):
        return [
            Property.always(
                "fin",
                lambda m, st: sum(1 for _t, pc in st.s if pc >= 3) == st.i,
            ),
            Property.always(
                "mutex",
                lambda m, st: sum(1 for _t, pc in st.s if 1 <= pc < 4) <= 1,
            ),
        ]


def _audit_models(rest=()):
    """The configurations of the static audit (the ``audit`` verb and
    ``_cli.fleet_audit``; JAX ``models/increment_lock.py``'s hook)."""
    n = int(rest[0]) if rest else 2
    return [(f"increment_lock threads={n}", IncrementLock(n))]


def main(argv=None) -> int:
    def n(rest):
        return int(rest[0]) if rest else 3

    return check_main(
        "increment_lock", "[THREAD_COUNT]", argv,
        lambda rest: IncrementLock(n(rest)),
        {
            "check": (lambda rest: (
                f"Model checking increment-lock with {n(rest)} threads."),
                host_dfs),
            "check-sym": (lambda rest: (
                f"Model checking increment-lock with {n(rest)} threads "
                "using symmetry reduction."), host_sym_dfs),
            "check-auto": (lambda rest: (
                f"Model checking increment-lock with {n(rest)} threads "
                "(auto engine)."), auto),
            "explore": (lambda rest: None, explore),
        },
        max_args=1,
        audit=_audit_models,
        independence=make_independence_cmd(_audit_models),
    )


if __name__ == "__main__":
    sys.exit(main())
