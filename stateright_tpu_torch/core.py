"""Core model abstraction: ``Model``, ``Property``, ``Expectation``.

The port's own copy of ``stateright_tpu/core.py``; ``Model.checker()``
returns the port's :class:`~stateright_tpu_torch.checker.CheckerBuilder`.

Mirrors the reference's L1 layer (reference: ``src/lib.rs:155-300``) with a
Python-idiomatic surface.  A :class:`Model` is a nondeterministic state
machine: initial states, enabled actions per state, and a (partial) transition
function.  Properties are named predicates with one of three expectations:

 - ``ALWAYS``   — must hold in every reachable state; a violating state is a
                  *counterexample* discovery.
 - ``SOMETIMES``— must hold in at least one reachable state; a satisfying
                  state is an *example* discovery.
 - ``EVENTUALLY`` — must hold at some point along every maximal path; a
                  terminal path that never satisfied it is a counterexample.
                  (We replicate the reference's path-bit semantics, including
                  its documented cycle false-negative — reference
                  ``src/checker.rs:341-414``.)

Unlike the reference (one trait, one implementation strategy) this framework
has *two coexisting model forms*:

 - the **object form** defined here, used by the CPU oracle checkers, the
   Explorer, and path reconstruction;
 - the **tensor form** (:mod:`stateright_tpu_torch.parallel.tensor_model`),
   a fixed-width 64-bit row encoding with a batched PyTorch transition
   function, executed by the GPU wavefront engine.

Both forms of the same system must agree on fingerprints bit-for-bit; that
equivalence is a test obligation (see ``tests/test_torch_*``).
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import Any, Callable, Generic, Iterable, Optional, Sequence, TypeVar

from .fingerprint import fingerprint as _fingerprint

State = TypeVar("State")
Action = TypeVar("Action")


class Expectation(Enum):
    """How a property's condition relates to the state space
    (reference ``src/lib.rs:293-300``)."""

    ALWAYS = "always"
    SOMETIMES = "sometimes"
    EVENTUALLY = "eventually"


@dataclass(frozen=True)
class Property(Generic[State]):
    """A named predicate over (model, state) (reference ``src/lib.rs:244-278``)."""

    expectation: Expectation
    name: str
    condition: Callable[[Any, State], bool]

    @staticmethod
    def always(name: str, condition: Callable[[Any, State], bool]) -> "Property":
        return Property(Expectation.ALWAYS, name, condition)

    @staticmethod
    def sometimes(name: str, condition: Callable[[Any, State], bool]) -> "Property":
        return Property(Expectation.SOMETIMES, name, condition)

    @staticmethod
    def eventually(name: str, condition: Callable[[Any, State], bool]) -> "Property":
        return Property(Expectation.EVENTUALLY, name, condition)


class Model(Generic[State, Action]):
    """A nondeterministic state machine (reference ``src/lib.rs:155-237``).

    Subclasses implement ``init_states``, ``actions``, ``next_state``; they may
    override ``properties``, ``within_boundary``, display hooks, and
    ``fingerprint_state`` (tensor-form models delegate the latter to the row
    hash so host and device fingerprints coincide).
    """

    # -- transition structure ------------------------------------------------

    def init_states(self) -> Sequence[State]:
        raise NotImplementedError

    def actions(self, state: State) -> Iterable[Action]:
        """Actions enabled in ``state`` (reference ``src/lib.rs:166``)."""
        raise NotImplementedError

    def next_state(self, state: State, action: Action) -> Optional[State]:
        """Apply ``action``; ``None`` means the action is ignored in this state
        (prunes the transition — reference ``src/lib.rs:170``)."""
        raise NotImplementedError

    # -- derived helpers (reference ``src/lib.rs:192-212``) ------------------

    def next_steps(self, state: State) -> list[tuple[Action, State]]:
        out = []
        for action in self.actions(state):
            nxt = self.next_state(state, action)
            if nxt is not None:
                out.append((action, nxt))
        return out

    def next_states(self, state: State) -> list[State]:
        return [s for _, s in self.next_steps(state)]

    # -- properties & bounds -------------------------------------------------

    def properties(self) -> Sequence[Property]:
        return []

    def property_by_name(self, name: str) -> Property:
        for p in self.properties():
            if p.name == name:
                return p
        raise KeyError(name)

    def within_boundary(self, state: State) -> bool:
        """States outside the boundary are not expanded (reference
        ``src/lib.rs:228``)."""
        return True

    # -- identity ------------------------------------------------------------

    def _config_mutated(self) -> None:
        """Hook called by builder-style subclasses when configuration changes
        after construction; tensor-backed models use it to invalidate cached
        eligibility decisions."""

    def fingerprint_state(self, state: State) -> int:
        """Stable nonzero 64-bit state identity.  Tensor-form models override
        this with the device row hash of ``encode_state`` for bit-parity."""
        return _fingerprint(state)

    # -- display hooks (reference ``src/lib.rs:173-189``) --------------------

    def format_action(self, action: Action) -> str:
        return repr(action)

    def format_step(self, last_state: State, action: Action) -> Optional[str]:
        nxt = self.next_state(last_state, action)
        return None if nxt is None else repr(nxt)

    def as_svg(self, path: "Any") -> Optional[str]:
        return None

    # -- entry point ---------------------------------------------------------

    def checker(self) -> "Any":
        """Begin configuring a checker run (reference ``src/lib.rs:231-236``)."""
        from .checker import CheckerBuilder

        return CheckerBuilder(self)
