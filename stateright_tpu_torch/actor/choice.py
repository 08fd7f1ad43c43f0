"""Explicit ``Choice`` actor composition (reference ``src/actor.rs:298-426``).

The port's own copy of ``stateright_tpu/actor/choice.py``, with the
wire-serialization delegates the UDP runtime (``spawn.py``) calls.

Python's duck typing already lets :class:`~stateright_tpu_torch.actor.ActorModel`
mix actor classes freely, but that leaves one hole the reference's
``Choice`` combinator exists to close: two *different* actor types whose
states happen to compare equal (say an ``int``-state counter and an
``int``-state timer) would collide in fingerprinting and symmetry
reduction.  ``Choice`` wraps each actor with a variant index and tags its
state with :class:`ChoiceState`, so states of different variants are
distinct values no matter what the inner states are: the same guarantee
the reference gets from the nested ``Choice::L``/``Choice::R`` tags.

Mirroring the reference's builder shape (``Choice::new(a)``,
``.or()``)::

    sys = (
        ActorModel()
        .actor(Choice.new(A()))            # variant 0
        .actor(Choice.new(B()).or_())      # variant 1
        .actor(Choice.new(C()).or_().or_())  # variant 2
    )

``ChoiceState`` is a frozen dataclass, so it fingerprints and rewrites
structurally like any other state value.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from . import Actor, Id, Out

__all__ = ["Choice", "ChoiceState"]


@dataclass(frozen=True)
class ChoiceState:
    """A wrapped actor's state, tagged with its variant index (the analogue
    of the reference's nested ``Choice<L, R>`` state tags)."""

    index: int
    state: Any


class Choice(Actor):
    """Wraps an actor as one variant of a tagged union of actor types.

    ``Choice.new(actor)`` is variant 0; each ``.or_()`` shifts the wrapper
    one variant deeper, mirroring the reference's ``Choice::new(x).or()``
    chains (``actor.rs:355-370``).  Handlers delegate to the wrapped actor
    and re-tag the resulting state; a ``None`` (no-op) result stays ``None``
    so no-op pruning is preserved.
    """

    def __init__(self, actor: Actor, index: int = 0):
        self.actor = actor
        self.index = index

    @staticmethod
    def new(actor: Actor) -> "Choice":
        return Choice(actor, 0)

    def or_(self) -> "Choice":
        return Choice(self.actor, self.index + 1)

    def __repr__(self) -> str:
        return f"Choice({self.actor!r}, index={self.index})"

    def _check_variant(self, state: ChoiceState) -> None:
        if state.index != self.index:  # unreachable by construction
            raise AssertionError(
                f"Choice variant mismatch: actor {self.index}, "
                f"state {state.index} (reference actor.rs:400 unreachable!)"
            )

    def on_start(self, id: Id, out: Out):
        return ChoiceState(self.index, self.actor.on_start(id, out))

    def on_msg(self, id: Id, state: ChoiceState, src: Id, msg, out: Out):
        self._check_variant(state)
        inner = self.actor.on_msg(id, state.state, src, msg, out)
        return None if inner is None else ChoiceState(self.index, inner)

    def on_timeout(self, id: Id, state: ChoiceState, out: Out):
        self._check_variant(state)
        inner = self.actor.on_timeout(id, state.state, out)
        return None if inner is None else ChoiceState(self.index, inner)

    # -- runtime serde delegates (spawn) -------------------------------------

    def serialize(self, msg) -> bytes:
        return self.actor.serialize(msg)

    def deserialize(self, data: bytes):
        return self.actor.deserialize(data)
