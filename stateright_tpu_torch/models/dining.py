"""Dining philosophers — deadlock detection on the GPU.

The port's counterpart of ``stateright_tpu/models/dining.py`` (beyond the
reference's example set): the classic circular-wait deadlock, found as an
``eventually``-property counterexample whose trace ends in the deadlocked
terminal state (every philosopher holding their left fork, each waiting on
the right).  The actor compiler's general fragment gives the model its
device twin.

System: ``n`` philosophers (actors ``0..n-1``) and ``n`` forks (actors
``n..2n-1``).  Philosopher ``i`` uses forks ``n+i`` (left) and
``n+(i+1)%n`` (right), acquires left-then-right, eats once, releases both.
Forks grant to the lowest pending id first — determinism the checker
needs, not fairness the protocol needs.

Pinned count: 359 unique states for ``dining_model(3)`` when no early exit
applies.

Run: ``python -m stateright_tpu_torch.models.dining check-gpu 3``.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import Optional

from ..actor import Actor, ActorModel, Id, Network, Out
from ..actor.device_props import exists_actor, forall_actors
from ..core import Expectation
from ..parallel.tensor_model import TensorBackedModel
from ._cli import (
    auto,
    check_main,
    explore,
    gpu,
    host_bfs,
    make_independence_cmd,
)

HUNGRY, HAS_LEFT, DONE = 0, 1, 2


@dataclass(frozen=True)
class PhilosopherState:
    phase: int = HUNGRY


@dataclass(frozen=True)
class ForkState:
    #: Id of the current holder, or -1
    holder: int = -1
    #: Ids waiting for the fork
    pending: frozenset = frozenset()


class Philosopher(Actor):
    def __init__(self, left: Id, right: Id):
        self.left = left
        self.right = right

    def on_start(self, id: Id, out: Out):
        out.send(self.left, ("acquire",))
        return PhilosopherState(HUNGRY)

    def on_msg(self, id: Id, state, src: Id, msg, out: Out):
        if msg[0] != "granted":
            return None
        if state.phase == HUNGRY:
            out.send(self.right, ("acquire",))
            return PhilosopherState(HAS_LEFT)
        if state.phase == HAS_LEFT:
            # both forks held: eat, then release both
            out.send(self.left, ("release",))
            out.send(self.right, ("release",))
            return PhilosopherState(DONE)
        return None


class Fork(Actor):
    def on_start(self, id: Id, out: Out):
        return ForkState()

    def on_msg(self, id: Id, state, src: Id, msg, out: Out):
        if msg[0] == "acquire":
            if state.holder == -1:
                out.send(src, ("granted",))
                return ForkState(holder=Id(src), pending=state.pending)
            return ForkState(
                holder=state.holder, pending=state.pending | {Id(src)}
            )
        if msg[0] == "release":
            if state.pending:
                nxt = Id(min(state.pending))
                out.send(nxt, ("granted",))
                return ForkState(
                    holder=nxt, pending=state.pending - {nxt}
                )
            return ForkState()
        return None


class DiningModel(TensorBackedModel, ActorModel):
    """ActorModel with a mechanically compiled device twin (general
    fragment: factored properties, no history, no timers)."""

    def tensor_model(self):
        from ..parallel.actor_compiler import CompileError, compile_actor_model

        try:
            return compile_actor_model(self)
        except (CompileError, ValueError):
            return None


def dining_model(n: int = 3, network: Optional[Network] = None) -> DiningModel:
    """``n`` philosophers, ``n`` forks; the famous deadlock is reachable
    (and discovered) for every ``n >= 2``."""
    if network is None:
        network = Network.new_unordered_nonduplicating()
    m = DiningModel(cfg=None, init_history=None)
    for i in range(n):
        m.actor(Philosopher(left=Id(n + i), right=Id(n + (i + 1) % n)))
    for _ in range(n):
        m.actor(Fork())
    m.init_network_(network)
    phil = lambda i: i < n  # noqa: E731 - actors 0..n-1 are philosophers
    m.property(
        Expectation.EVENTUALLY,
        "everyone eats",
        forall_actors(lambda i, s: not phil(i) or s.phase == DONE),
    )
    m.property(
        Expectation.SOMETIMES,
        "someone eats",
        exists_actor(lambda i, s: phil(i) and s.phase == DONE),
    )
    return m


def _audit_models(rest=()):
    """The configurations of the static audit (the ``audit`` verb and
    ``_cli.fleet_audit``; JAX ``models/dining.py``'s hook)."""
    n = int(rest[0]) if rest else 3
    return [(f"dining n={n}", dining_model(n))]


def main(argv=None) -> int:
    def what(rest):
        return (f"Model checking {int(rest[0]) if rest else 3} dining "
                "philosophers")

    return check_main(
        "dining", "[PHILOSOPHER_COUNT]", argv,
        lambda rest: dining_model(int(rest[0]) if rest else 3), {
            "check": (lambda rest: f"{what(rest)} (host BFS).", host_bfs),
            "check-gpu": (lambda rest: f"{what(rest)} on the GPU.", gpu),
            "check-auto": (lambda rest: f"{what(rest)} (auto engine).", auto),
            "explore": (lambda rest: None, explore),
        },
        max_args=1,
        audit=_audit_models,
        independence=make_independence_cmd(_audit_models),
    )


if __name__ == "__main__":
    sys.exit(main())
