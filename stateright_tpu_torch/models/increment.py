"""Racy shared counter (reference ``examples/increment.rs``).

The port's own copy of ``stateright_tpu/models/increment.py``.  N threads
each run ``read; write(local+1)`` without synchronization; the ``always
"fin"`` property (the counter equals the number of finished threads) is
violated by interleaved read-modify-write races.  The reference's
docstring enumerates the full 13-state space at 2 threads and its 8-state
symmetric reduction (``increment.rs:36-105``).  The model has no tensor
form: it checks on the host engines.

Run: ``python -m stateright_tpu_torch.models.increment check|check-sym|check-auto [THREAD_COUNT]``.
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
class IncState:
    i: int  # shared counter
    s: tuple  # per-thread (local value t, program counter pc)

    def representative(self) -> "IncState":
        return IncState(i=self.i, s=tuple(sorted(self.s)))


@dataclass
class Increment(Model):
    thread_count: int

    def init_states(self):
        return [IncState(i=0, s=((0, 1),) * self.thread_count)]

    def actions(self, state: IncState):
        acts = []
        for n, (_t, pc) in enumerate(state.s):
            if pc == 1:
                acts.append(("read", n))
            elif pc == 2:
                acts.append(("write", n))
        return acts

    def next_state(self, state: IncState, action):
        kind, n = action
        s = list(state.s)
        if kind == "read":
            s[n] = (state.i, 2)
            return replace(state, s=tuple(s))
        t, _pc = s[n]
        s[n] = (t, 3)
        return IncState(i=(t + 1) % 256, s=tuple(s))

    def properties(self):
        return [
            Property.always(
                "fin",
                lambda m, st: sum(1 for _t, pc in st.s if pc == 3) == st.i,
            )
        ]


def _audit_models(rest=()):
    """The configurations of the static audit (the ``audit`` verb and
    ``_cli.fleet_audit``; JAX ``models/increment.py``'s hook)."""
    n = int(rest[0]) if rest else 2
    return [(f"increment threads={n}", Increment(n))]


def main(argv=None) -> int:
    def n(rest):
        return int(rest[0]) if rest else 3

    return check_main(
        "increment", "[THREAD_COUNT]", argv, lambda rest: Increment(n(rest)),
        {
            "check": (lambda rest: (
                f"Model checking increment with {n(rest)} threads."),
                host_dfs),
            "check-sym": (lambda rest: (
                f"Model checking increment with {n(rest)} threads using "
                "symmetry reduction."), host_sym_dfs),
            "check-auto": (lambda rest: (
                f"Model checking increment with {n(rest)} threads (auto "
                "engine)."), auto),
            "explore": (lambda rest: None, explore),
        },
        max_args=1,
        audit=_audit_models,
        independence=make_independence_cmd(_audit_models),
    )


if __name__ == "__main__":
    sys.exit(main())
