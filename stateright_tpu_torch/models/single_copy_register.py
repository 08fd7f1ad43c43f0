"""Unreplicated single-copy register (reference
``examples/single-copy-register.rs``): each server exposes its own register
with no consensus.  One server is linearizable; two servers are not — the
checker finds the violating trace through the linearizability tester.

The port's counterpart of ``stateright_tpu/models/single_copy_register.py``:
the same object model, whose device twin is compiled mechanically
(``parallel/actor_compiler.py``); no closure bounds are needed, since a
server's state is just the stored value.

Pinned counts (reference ``single-copy-register.rs:100,121``): 93 unique
states @ 2 clients / 1 server; 20 @ 2 clients / 2 servers (violation found
early).  ``single_copy_model(4)``, the reference bench's ``single-copy 4``,
has 400,233 unique / 731,789 states (the JAX engine's count).

Run: ``python -m stateright_tpu_torch.models.single_copy_register check-gpu 4``
(optionally followed by a network name, e.g. ``ordered``).
"""

from __future__ import annotations

import sys
from typing import Optional

from ..actor import Actor, ActorModel, Id, Network, Out
from ..actor.register import (
    NULL_VALUE,
    GetOk,
    PutOk,
    RegisterClient,
    record_invocations,
    record_returns,
    value_chosen,
)
from ..core import Expectation
from ..parallel.tensor_model import TensorBackedModel
from ..semantics import LinearizabilityTester, Register
from ._cli import (
    auto,
    check_main,
    explore,
    gpu,
    host_bfs,
    make_independence_cmd,
)


class SingleCopyServer(Actor):
    """State is just the stored value (reference
    ``single-copy-register.rs:16-37``)."""

    def on_start(self, id: Id, out: Out):
        return NULL_VALUE

    def on_msg(self, id: Id, state, src: Id, msg, out: Out):
        kind = msg[0]
        if kind == "put":
            out.send(src, PutOk(msg[1]))
            return msg[2]
        if kind == "get":
            out.send(src, GetOk(msg[1], state))
            return state
        return None


class SingleCopyModel(TensorBackedModel, ActorModel):
    """ActorModel with a mechanically compiled device twin."""

    def tensor_model(self):
        from ..parallel.actor_compiler import CompileError, compile_actor_model

        try:
            return compile_actor_model(self)
        except (CompileError, ValueError):
            return None


def single_copy_model(
    client_count: int,
    server_count: int = 1,
    network: Optional[Network] = None,
    put_count: int = 1,
) -> SingleCopyModel:
    if network is None:
        network = Network.new_unordered_nonduplicating()
    m = SingleCopyModel(
        cfg=None, init_history=LinearizabilityTester(Register(NULL_VALUE))
    )
    for _ in range(server_count):
        m.actor(SingleCopyServer())
    for _ in range(client_count):
        m.actor(RegisterClient(put_count=put_count, server_count=server_count))
    m.init_network_(network)
    m.property(
        Expectation.ALWAYS,
        "linearizable",
        lambda model, s: s.history.is_consistent(),
    )
    m.property(Expectation.SOMETIMES, "value chosen", value_chosen)
    m.record_msg_in(record_returns)
    m.record_msg_out(record_invocations)
    return m


def _audit_models(rest=()):
    """The configurations of the static audit (the ``audit`` verb and
    ``_cli.fleet_audit``; JAX ``models/single_copy_register.py``'s hook)."""
    c = int(rest[0]) if rest else 1
    return [(f"single_copy_register clients={c}", single_copy_model(c))]


def udp_servers(rest) -> tuple:
    """The ``spawn`` verb's server (JAX ``single_copy_register.py``
    ``spawn_cmd``): one register server on 127.0.0.1:3000."""
    return [], [(Id.from_addr("127.0.0.1", 3000), SingleCopyServer())]


def main(argv=None) -> int:
    def what(rest):
        return ("Model checking a single-copy register with "
                f"{int(rest[0]) if rest else 2} clients")

    return check_main(
        "single_copy_register", "[CLIENT_COUNT] [NETWORK]", argv,
        lambda rest: single_copy_model(
            int(rest[0]) if rest else 2, 1,
            Network.from_name(rest[1]) if len(rest) > 1 else None), {
            "check": (lambda rest: f"{what(rest)} (host BFS).", host_bfs),
            "check-gpu": (lambda rest: f"{what(rest)} on the GPU.", gpu),
            "check-auto": (lambda rest: (
                f"{what(rest)} (auto engine selection)."), auto),
            "explore": (lambda rest: None, explore),
        },
        max_args=2,
        audit=_audit_models,
        independence=make_independence_cmd(_audit_models),
        udp=udp_servers,
    )


if __name__ == "__main__":
    sys.exit(main())
