"""Write-once register example: first write wins, later writes fail.

The port's counterpart of ``stateright_tpu/models/write_once_register.py``:
the same object model, whose device twin is compiled mechanically
(``parallel/actor_compiler.py``, the ``put_fail`` envelope kind and the
``wfail`` history field).  Each server stores at most one value: the first
``put`` is acknowledged with ``put_ok`` and every later one with
``put_fail`` (recorded as the spec's ``write_fail`` return); ``get``
returns the stored value.

With one server the system is linearizable against the
:class:`~stateright_tpu_torch.semantics.WORegister` spec.  With two
independent servers it is not — a client can read ``NULL`` from a server
that never saw the successful write — and the checker finds the violating
trace.  ``wo_register_model(2, 1)`` has 71 unique / 97 states (the JAX
engine's count, either network packing).

Run: ``python -m stateright_tpu_torch.models.write_once_register check-gpu
2 1`` (client count, server count, optionally a network name, and
``--per-channel``).
"""

from __future__ import annotations

import sys
from typing import Optional

from ..actor import Actor, ActorModel, Id, Network, Out
from ..actor.register import GetOk, NULL_VALUE, PutOk, record_invocations
from ..actor.write_once_register import (
    PutFail,
    WORegisterClient,
    record_returns,
    value_chosen,
)
from ..core import Expectation
from ..parallel.tensor_model import TensorBackedModel
from ..semantics import LinearizabilityTester, WORegister
from ._cli import check_gpu_main


class WOServer(Actor):
    """Stores the first value put; later puts fail (write-once)."""

    def on_start(self, id: Id, out: Out):
        return NULL_VALUE

    def on_msg(self, id: Id, state, src: Id, msg, out: Out):
        kind = msg[0]
        if kind == "put":
            if state == NULL_VALUE:
                out.send(src, PutOk(msg[1]))
                return msg[2]
            out.send(src, PutFail(msg[1]))
            return None
        if kind == "get":
            out.send(src, GetOk(msg[1], state))
            return None
        return None


class WORegisterModel(TensorBackedModel, ActorModel):
    """ActorModel with a mechanically compiled device twin."""

    def tensor_model(self):
        from ..parallel.actor_compiler import CompileError, compile_actor_model

        try:
            return compile_actor_model(self)
        except (CompileError, ValueError):
            return None


def wo_register_model(
    client_count: int, server_count: int = 1, network: Optional[Network] = None
) -> WORegisterModel:
    if network is None:
        network = Network.new_unordered_nonduplicating()
    m = WORegisterModel(
        cfg=None, init_history=LinearizabilityTester(WORegister(None))
    )
    for _ in range(server_count):
        m.actor(WOServer())
    for _ in range(client_count):
        m.actor(WORegisterClient(put_count=1, server_count=server_count))
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


def main(argv=None) -> int:
    def build(rest):
        return wo_register_model(
            int(rest[0]) if rest else 2,
            int(rest[1]) if len(rest) > 1 else 1,
            Network.from_name(rest[2]) if len(rest) > 2 else None,
        )

    return check_gpu_main(
        "write_once_register", "[CLIENT_COUNT] [SERVER_COUNT] [NETWORK]",
        argv, build,
        lambda rest: ("Model checking a write-once register with "
                      f"{int(rest[0]) if rest else 2} clients and "
                      f"{int(rest[1]) if len(rest) > 1 else 1} servers on "
                      "the GPU."),
        max_args=3,
    )


if __name__ == "__main__":
    sys.exit(main())
