"""An ordered reliable link system compiled for the GPU engine.

The sender/receiver pair of ``tests/test_orl_compile.py`` (the reference's
own ORL test shape, ``src/actor/ordered_reliable_link.rs:150-244``): the
sender sends 42 then 43 to the receiver, and both are wrapped in an
:class:`~stateright_tpu_torch.actor.ordered_reliable_link.OrderedReliableLink`
over a lossy duplicating network, with resend timers and at-most-once
watermarks.  The system is finite without any boundary, so the actor
compiler's general fragment compiles it as it stands.

Properties (all factored, so the compiled twin tabulates them): "no
redelivery" and "ordered" must never be violated; "delivered" is the
witness that the receiver got both messages in order.  Pinned: 148 unique
states, on the host BFS and on the GPU engine alike.

Run: ``python -m stateright_tpu_torch.models.orl check-gpu`` (or ``check``,
``check-auto``).
"""

from __future__ import annotations

import sys

from ..actor import Actor, ActorModel, Id, Network
from ..actor.device_props import exists_actor, forall_actors
from ..actor.ordered_reliable_link import OrderedReliableLink
from ..core import Expectation
from ..parallel.tensor_model import TensorBackedModel
from ._cli import auto, check_main, gpu, host_bfs

ORL_UNIQUE = 148


class OrlSender(Actor):
    """A fixed two-message script: the whole system is finite."""

    def __init__(self, receiver: Id):
        self.receiver = receiver

    def on_start(self, id, out):
        out.send(self.receiver, 42)
        out.send(self.receiver, 43)
        return ()

    def on_msg(self, id, state, src, msg, out):
        return state + ((src, msg),)


class OrlReceiver(Actor):
    def on_start(self, id, out):
        return ()

    def on_msg(self, id, state, src, msg, out):
        return state + ((src, msg),)


class OrlModel(TensorBackedModel, ActorModel):
    """ActorModel with a mechanically compiled device twin."""

    def __init__(self):
        super().__init__(None, None)

    def tensor_model(self):
        from ..parallel.actor_compiler import CompileError, compile_actor_model

        try:
            return compile_actor_model(self)
        except (CompileError, ValueError):
            return None


def _received(s) -> list:
    return [m for _, m in s.wrapped_state]


def orl_model() -> OrlModel:
    return (
        OrlModel()
        .actor(OrderedReliableLink(OrlSender(Id(1))))
        .actor(OrderedReliableLink(OrlReceiver()))
        .init_network_(Network.new_unordered_duplicating())
        .lossy_network(True)
        .property(
            Expectation.ALWAYS,
            "no redelivery",
            forall_actors(
                lambda i, s: i != 1
                or (_received(s).count(42) < 2 and _received(s).count(43) < 2)
            ),
        )
        .property(
            Expectation.ALWAYS,
            "ordered",
            forall_actors(
                lambda i, s: i != 1 or _received(s) == sorted(_received(s))
            ),
        )
        .property(
            Expectation.SOMETIMES,
            "delivered",
            exists_actor(
                lambda i, s: i == 1
                and s.wrapped_state == ((Id(0), 42), (Id(0), 43))
            ),
        )
    )


def _audit_models(rest=()):
    """The configurations of the static audit (the ``audit`` verb and
    ``_cli.fleet_audit``)."""
    return [("orl", orl_model())]


def main(argv=None) -> int:
    what = ("Checking an ordered reliable link (a sender and a receiver "
            "over a lossy network)")
    return check_main(
        "orl", "", argv, lambda rest: orl_model(), {
            "check": (lambda rest: f"{what} (host BFS).", host_bfs),
            "check-gpu": (lambda rest: f"{what} on the GPU.", gpu),
            "check-auto": (lambda rest: (
                f"{what} (auto engine selection)."), auto),
        },
        max_args=0,
        audit=_audit_models,
    )


if __name__ == "__main__":
    sys.exit(main())
