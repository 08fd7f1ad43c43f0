"""Write-once register harness (reference ``src/actor/write_once_register.rs``).

The port's own copy of ``stateright_tpu/actor/write_once_register.py``.
Same vocabulary as :mod:`.register` plus a ``("put_fail", req_id)`` reply
mapping to the spec's ``("write_fail",)``; the client additionally treats
``put_fail`` as acknowledging its put.
"""

from __future__ import annotations

from dataclasses import dataclass

from .register import (  # noqa: F401  (the shared vocabulary)
    NULL_VALUE,
    Get,
    GetOk,
    Internal,
    Put,
    PutOk,
    RegisterClient,
    RegisterClientState,
    record_invocations,
    value_chosen,
)
from .register import record_returns as _record_returns


def PutFail(req_id) -> tuple:
    return ("put_fail", req_id)


def record_returns(cfg, history, env):
    """The write-once variant of :func:`.register.record_returns`:
    ``put_fail`` completes the write with the spec's ``("write_fail",)``,
    and a null read return becomes ``None``, the
    :class:`~stateright_tpu_torch.semantics.WORegister` spec's unset
    register (the wire protocol's null stays
    :data:`~stateright_tpu_torch.actor.register.NULL_VALUE`)."""
    if env.msg[0] == "put_fail":
        return history.on_return(env.dst, ("write_fail",))
    if env.msg[0] == "get_ok" and env.msg[2] == NULL_VALUE:
        return history.on_return(env.dst, ("read_ok", None))
    return _record_returns(cfg, history, env)


@dataclass
class WORegisterClient(RegisterClient):
    """Same workload as :class:`RegisterClient`, tolerating ``put_fail``
    (reference ``write_once_register.rs:119-241``)."""

    put_reply_kinds = ("put_ok", "put_fail")


WORegisterClientState = RegisterClientState
