"""Register-like actor interface + test client (reference ``src/actor/register.rs``).

The port's own copy of ``stateright_tpu/actor/register.py``.

``RegisterMsg`` is the wire vocabulary between clients and register servers,
as tagged tuples:

 - ``("internal", msg)`` — server-to-server protocol internals
 - ``("put", req_id, value)`` / ``("get", req_id)`` — client requests
 - ``("put_ok", req_id)`` / ``("get_ok", req_id, value)`` — server replies

:func:`record_invocations` / :func:`record_returns` bridge these messages into
a :class:`~stateright_tpu_torch.semantics.ConsistencyTester` history (pass to
``ActorModel.record_msg_out`` / ``record_msg_in``), and
:class:`RegisterClient` is the scripted workload: ``put_count`` puts then one
get, round-robining servers.  Servers must precede clients in the actor list
so client ids can derive server ids by modulo (reference
``register.rs:116-135``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..semantics.register import READ, write
from . import Actor, Id, Out

#: The register's initial value (reference uses Rust's ``char::default()``).
NULL_VALUE = "\0"


def Internal(msg) -> tuple:
    return ("internal", msg)


def Put(req_id, value) -> tuple:
    return ("put", req_id, value)


def Get(req_id) -> tuple:
    return ("get", req_id)


def PutOk(req_id) -> tuple:
    return ("put_ok", req_id)


def GetOk(req_id, value) -> tuple:
    return ("get_ok", req_id, value)


def record_invocations(cfg, history, env):
    """Record Read on Get, Write on Put (reference ``register.rs:37-58``).
    Pass to ``ActorModel.record_msg_out``."""
    kind = env.msg[0]
    if kind == "get":
        return history.on_invoke(env.src, READ)
    if kind == "put":
        return history.on_invoke(env.src, write(env.msg[2]))
    return None


def record_returns(cfg, history, env):
    """Record ReadOk on GetOk, WriteOk on PutOk (reference
    ``register.rs:64-87``).  Pass to ``ActorModel.record_msg_in``."""
    kind = env.msg[0]
    if kind == "get_ok":
        return history.on_return(env.dst, ("read_ok", env.msg[2]))
    if kind == "put_ok":
        return history.on_return(env.dst, ("write_ok",))
    return None


def value_chosen(model, state) -> bool:
    """``sometimes`` condition: a non-null value is being returned to a
    client (reference ``paxos.rs:255-262``)."""
    for env in state.network.iter_deliverable():
        if env.msg[0] == "get_ok" and env.msg[2] != NULL_VALUE:
            return True
    return False


@dataclass(frozen=True)
class RegisterClientState:
    awaiting: Optional[int]
    op_count: int


@dataclass
class RegisterClient(Actor):
    """Puts ``put_count`` values then gets, awaiting each response
    (reference ``register.rs:90-216``).  Request ids are unique per client
    (``(op_count+1) * index``); values are letters derived from the client
    index ('A'.. for the first put, 'Z'-.. for subsequent)."""

    put_count: int
    server_count: int

    #: reply kinds acknowledging a put
    put_reply_kinds = ("put_ok",)

    @staticmethod
    def put_value(index: int, server_count: int, op_index: int) -> str:
        """Value the ``op_index``-th put (0-based) of client ``index``
        writes: 'A'.. for the first put, 'Z'-.. for every later one
        (reference ``register.rs:140,178``)."""
        if op_index == 0:
            return chr(ord("A") + index - server_count)
        return chr(ord("Z") - (index - server_count))

    def on_start(self, id: Id, out: Out):
        index = int(id)
        if index < self.server_count:
            raise ValueError(
                "RegisterClient actors must be added to the model after servers."
            )
        if self.put_count == 0:
            return RegisterClientState(awaiting=None, op_count=0)
        req_id = index
        value = self.put_value(index, self.server_count, 0)
        out.send(Id(index % self.server_count), Put(req_id, value))
        return RegisterClientState(awaiting=req_id, op_count=1)

    def on_msg(self, id: Id, state, src: Id, msg, out: Out):
        if state.awaiting is None:
            return None
        index = int(id)
        kind = msg[0]
        if kind in self.put_reply_kinds and msg[1] == state.awaiting:
            req_id = (state.op_count + 1) * index
            if state.op_count < self.put_count:
                value = self.put_value(
                    index, self.server_count, state.op_count
                )
                out.send(
                    Id((index + state.op_count) % self.server_count),
                    Put(req_id, value),
                )
            else:
                out.send(
                    Id((index + state.op_count) % self.server_count),
                    Get(req_id),
                )
            return RegisterClientState(
                awaiting=req_id, op_count=state.op_count + 1
            )
        if kind == "get_ok" and msg[1] == state.awaiting:
            return RegisterClientState(
                awaiting=None, op_count=state.op_count + 1
            )
        return None
