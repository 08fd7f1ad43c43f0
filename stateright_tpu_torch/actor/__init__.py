"""Actor framework (reference L4–L6, ``src/actor.rs`` + ``src/actor/``).

The port's own copy of ``stateright_tpu/actor/__init__.py``: ids (an
index for model checking, an IPv4 socket address for the UDP runtime),
commands, the ``Out`` buffer, the ``Actor`` interface with its wire
serialization hooks, the ``Choice`` combinator (``choice.py``),
``ScriptedActor``, the model helpers and the UDP runtime
(:func:`~stateright_tpu_torch.actor.spawn.spawn`), which deploys the same
actor code that was model checked.

An :class:`Actor` is an event-driven state machine: ``on_start`` produces
the initial state, ``on_msg``/``on_timeout`` react to events by returning an
updated state (or ``None`` for "unchanged") and emitting commands into an
:class:`Out` buffer.  An :class:`~stateright_tpu_torch.actor.model.ActorModel`
compiles a set of actors, a network semantics and properties into a
checkable :class:`~stateright_tpu_torch.core.Model`.  Handlers return the
new state instead of mutating it; returning ``None`` with no commands marks
the no-op transitions the model prunes (reference ``actor.rs:238-240``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterable, Sequence, Tuple

__all__ = [
    "Id",
    "Send",
    "SetTimer",
    "CancelTimer",
    "Out",
    "Actor",
    "Choice",
    "ChoiceState",
    "ScriptedActor",
    "majority",
    "model_peers",
    "model_timeout",
    "Envelope",
    "Network",
    "ActorModel",
    "ActorModelState",
    "Deliver",
    "Drop",
    "Timeout",
    "spawn",
]


class Id(int):
    """Actor identity: an index for model checking, an IPv4 socket address
    for the UDP runtime (reference ``actor.rs:107-153``,
    ``spawn.rs:9-33``)."""

    def __repr__(self) -> str:
        return f"Id({int(self)})"

    # -- sockaddr packing (reference ``spawn.rs:9-33``) ----------------------

    @staticmethod
    def from_addr(ip: str, port: int) -> "Id":
        parts = [int(p) for p in ip.split(".")]
        if len(parts) != 4:
            raise ValueError(f"not an IPv4 address: {ip!r}")
        v = 0
        for p in parts:
            v = (v << 8) | p
        return Id((v << 16) | port)

    def to_addr(self) -> tuple[str, int]:
        port = int(self) & 0xFFFF
        ip_bits = int(self) >> 16
        ip = ".".join(str((ip_bits >> s) & 0xFF) for s in (24, 16, 8, 0))
        return ip, port


# -- commands (reference ``actor.rs:155-234``) -------------------------------


@dataclass(frozen=True)
class Send:
    dst: Id
    msg: Any


@dataclass(frozen=True)
class SetTimer:
    #: (low, high) seconds; irrelevant for model checking
    duration: Tuple[float, float] = (0.0, 0.0)


@dataclass(frozen=True)
class CancelTimer:
    pass


def model_timeout() -> Tuple[float, float]:
    """Arbitrary timer range for model checking, where the specific value is
    irrelevant (reference ``model.rs:62-64``)."""
    return (0.0, 0.0)


class Out:
    """Buffer of commands an actor emits during a handler
    (reference ``actor.rs:156-234``)."""

    def __init__(self):
        self.commands: list = []

    def send(self, dst: Id, msg: Any) -> None:
        self.commands.append(Send(Id(dst), msg))

    def broadcast(self, dsts: Iterable[Id], msg: Any) -> None:
        for dst in dsts:
            self.send(dst, msg)

    def set_timer(self, duration: Tuple[float, float] = (0.0, 0.0)) -> None:
        self.commands.append(SetTimer(duration))

    def cancel_timer(self) -> None:
        self.commands.append(CancelTimer())

    def __iter__(self):
        return iter(self.commands)

    def __len__(self):
        return len(self.commands)

    def __repr__(self):
        return f"Out({self.commands!r})"


class Actor:
    """Event-driven actor (reference ``actor.rs:246-296``).

    States must be immutable hashable values.  ``on_msg``/``on_timeout``
    return the updated state, or ``None`` to signal "state unchanged"; an
    unchanged state with no emitted commands is a no-op transition, which
    the model checker prunes (reference ``model.rs:253-260``).
    """

    def on_start(self, id: Id, out: Out):
        raise NotImplementedError

    def on_msg(self, id: Id, state, src: Id, msg, out: Out):
        return None  # no-op by default

    def on_timeout(self, id: Id, state, out: Out):
        return None  # no-op by default

    # -- wire serialization (overridable; used by spawn) ----------------------

    def serialize(self, msg) -> bytes:
        import json

        return json.dumps(msg).encode()

    def deserialize(self, data: bytes):
        import json

        def tuplize(v):
            if isinstance(v, list):
                return tuple(tuplize(x) for x in v)
            if isinstance(v, dict):
                return {k: tuplize(x) for k, x in v.items()}
            return v

        # JSON arrays become tuples, so wire messages compare equal to the
        # tuples used in model checking
        return tuplize(json.loads(data.decode()))


@dataclass
class ScriptedActor(Actor):
    """Sends a scripted series of messages, one after each delivery it
    receives: useful for testing actor systems (reference
    ``actor.rs:440-469``, ``impl Actor for Vec<(Id, Msg)>``)."""

    script: Sequence[Tuple[Id, Any]]

    def on_start(self, id: Id, out: Out):
        if self.script:
            dst, msg = self.script[0]
            out.send(dst, msg)
            return 1
        return 0

    def on_msg(self, id: Id, state, src: Id, msg, out: Out):
        if state < len(self.script):
            dst, m = self.script[state]
            out.send(dst, m)
            return state + 1
        return None


def majority(cluster_size: int) -> int:
    """Number of nodes constituting a majority (reference ``actor.rs:472-474``)."""
    return cluster_size // 2 + 1


def model_peers(self_ix: int, count: int) -> list[Id]:
    """All ids except one's own (reference ``model.rs:68-73``)."""
    return [Id(j) for j in range(count) if j != self_ix]


from .network import Envelope, Network  # noqa: E402
from .model import ActorModel, ActorModelState, Deliver, Drop, Timeout  # noqa: E402
from .spawn import spawn  # noqa: E402
from .choice import Choice, ChoiceState  # noqa: E402
