"""Factored, device-compilable property predicates for actor systems.

The port's own copy of ``stateright_tpu/actor/device_props.py``.

Reference properties are arbitrary closures over the whole system state
(``lib.rs:247``) — fine for host checking, opaque to compilation.  These
constructors express the common shapes that *factor through per-actor
states*:

 - :func:`forall_actors` / :func:`exists_actor` — a predicate of one
   actor's state, quantified over actors;
 - :func:`forall_actor_pairs` / :func:`exists_actor_pair` — a predicate
   of two actors' states, quantified over unordered pairs ``i < j``.

A factored predicate is an ordinary property condition — callable as
``cond(model, sys_state)`` and usable with every CPU checker — but the
actor compiler (``parallel/actor_compiler.py``) additionally recognizes
it and *tabulates* the predicate over the compiled per-actor state
universes, so the same property evaluates as table lookups fused over a
device wavefront.  Host and device agree by construction: both evaluate
the one predicate you wrote, the host directly and the device via its
tabulation.

Example — Raft's election safety::

    model.property(
        Expectation.ALWAYS,
        "at most one leader per term",
        forall_actor_pairs(
            lambda i, si, j, sj: not (
                si.role == LEADER and sj.role == LEADER
                and si.term == sj.term
            )
        ),
    )
"""

from __future__ import annotations

from itertools import combinations
from typing import Callable

__all__ = [
    "FactoredPredicate",
    "forall_actors",
    "exists_actor",
    "forall_actor_pairs",
    "exists_actor_pair",
]


class FactoredPredicate:
    """A property condition that factors through per-actor states.

    ``kind`` is one of ``"forall"``, ``"exists"`` (pred over one actor:
    ``pred(i, state_i)``) or ``"forall_pairs"``, ``"exists_pair"``
    (pred over an unordered pair ``i < j``:
    ``pred(i, state_i, j, state_j)``).
    """

    def __init__(self, kind: str, pred: Callable, label: str):
        assert kind in ("forall", "exists", "forall_pairs", "exists_pair")
        self.kind = kind
        self.pred = pred
        self._label = label

    def __repr__(self) -> str:
        return f"{self._label}({self.pred!r})"

    def __call__(self, model, sys_state) -> bool:
        states = sys_state.actor_states
        if self.kind == "forall":
            return all(self.pred(i, s) for i, s in enumerate(states))
        if self.kind == "exists":
            return any(self.pred(i, s) for i, s in enumerate(states))
        pairs = combinations(range(len(states)), 2)
        if self.kind == "forall_pairs":
            return all(
                self.pred(i, states[i], j, states[j]) for i, j in pairs
            )
        return any(self.pred(i, states[i], j, states[j]) for i, j in pairs)


def forall_actors(pred: Callable) -> FactoredPredicate:
    """True iff ``pred(i, state_i)`` holds for every actor."""
    return FactoredPredicate("forall", pred, "forall_actors")


def exists_actor(pred: Callable) -> FactoredPredicate:
    """True iff ``pred(i, state_i)`` holds for some actor."""
    return FactoredPredicate("exists", pred, "exists_actor")


def forall_actor_pairs(pred: Callable) -> FactoredPredicate:
    """True iff ``pred(i, s_i, j, s_j)`` holds for every pair ``i < j``."""
    return FactoredPredicate("forall_pairs", pred, "forall_actor_pairs")


def exists_actor_pair(pred: Callable) -> FactoredPredicate:
    """True iff ``pred(i, s_i, j, s_j)`` holds for some pair ``i < j``."""
    return FactoredPredicate("exists_pair", pred, "exists_actor_pair")
