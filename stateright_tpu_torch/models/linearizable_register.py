"""ABD linearizable quorum register (reference
``examples/linearizable-register.rs``), after "Sharing Memory Robustly in
Message-Passing Systems" by Attiya, Bar-Noy, and Dolev.

The port's counterpart of ``stateright_tpu/models/linearizable_register.py``:
the same object model, with the same closure bounds (``state_bound`` /
``env_bound``) for its mechanically compiled twin
(``parallel/actor_compiler.py``).

Each request runs two phases: a query phase establishing the latest
(sequencer, value) from a majority, then a record phase driving it (or the
new write, with a bumped sequencer) to a majority.  Sequencers are
``(logical clock, server id)`` pairs, so they are distinct across servers.

Pinned counts: 544 unique states @ 2 clients / 2 servers on an unordered
non-duplicating network (reference ``linearizable-register.rs:258,281``);
36,213 unique / 63,053 states @ 3 clients / 2 servers on an ordered network,
the reference bench's ``lin-reg 3 ordered`` (the JAX engine's count).

Run: ``python -m stateright_tpu_torch.models.linearizable_register check-gpu 3 ordered``.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, replace
from typing import Optional

from ..actor import Actor, ActorModel, Id, Network, Out, majority, model_peers
from ..actor.register import (
    NULL_VALUE,
    GetOk,
    Internal,
    PutOk,
    RegisterClient,
    record_invocations,
    record_returns,
    value_chosen,
)
from ..core import Expectation
from ..parallel.tensor_model import TensorBackedModel
from ..semantics import LinearizabilityTester, Register
from ._cli import check_gpu_main


def Query(req_id):
    return ("query", req_id)


def AckQuery(req_id, seq, value):
    return ("ack_query", req_id, seq, value)


def Record(req_id, seq, value):
    return ("record", req_id, seq, value)


def AckRecord(req_id):
    return ("ack_record", req_id)


@dataclass(frozen=True)
class AbdPhase1:
    request_id: int
    requester_id: Id
    write: Optional[str]  # value to write, None for reads
    responses: tuple  # sorted ((server id, (seq, value)), ...)


@dataclass(frozen=True)
class AbdPhase2:
    request_id: int
    requester_id: Id
    read: Optional[str]  # value read in phase 1, None for writes
    acks: frozenset  # server ids


@dataclass(frozen=True)
class AbdState:
    seq: tuple  # (logical clock, server id)
    val: str
    phase: Optional[object]  # AbdPhase1 | AbdPhase2 | None


@dataclass
class AbdServer(Actor):
    """One ABD replica (reference ``linearizable-register.rs:56-186``)."""

    peers: list

    def on_start(self, id: Id, out: Out):
        return AbdState(seq=(0, Id(id)), val=NULL_VALUE, phase=None)

    def _quorum(self) -> int:
        return majority(len(self.peers) + 1)

    def on_msg(self, id: Id, state: AbdState, src: Id, msg, out: Out):
        kind = msg[0]

        if kind in ("put", "get") and state.phase is None:
            req_id = msg[1]
            out.broadcast(self.peers, Internal(Query(req_id)))
            return replace(
                state,
                phase=AbdPhase1(
                    request_id=req_id,
                    requester_id=Id(src),
                    write=msg[2] if kind == "put" else None,
                    responses=((Id(id), (state.seq, state.val)),),
                ),
            )

        if kind != "internal":
            return None
        imsg = msg[1]
        ikind = imsg[0]

        if ikind == "query":
            out.send(src, Internal(AckQuery(imsg[1], state.seq, state.val)))
            return state

        if ikind == "ack_query":
            req_id, seq, val = imsg[1], imsg[2], imsg[3]
            ph = state.phase
            if not (isinstance(ph, AbdPhase1) and ph.request_id == req_id):
                return None
            responses = dict(ph.responses)
            responses[Id(src)] = (seq, val)
            resp_tuple = tuple(sorted(responses.items()))
            if len(resp_tuple) == self._quorum():
                # quorum: pick latest (sequencers are distinct), move to
                # phase 2 (reference ``linearizable-register.rs:107-147``)
                best_seq, best_val = max(
                    responses.values(), key=lambda sv: sv[0]
                )
                if ph.write is not None:
                    new_seq = (best_seq[0] + 1, Id(id))
                    new_val = ph.write
                    read = None
                else:
                    new_seq, new_val = best_seq, best_val
                    read = best_val
                out.broadcast(
                    self.peers, Internal(Record(req_id, new_seq, new_val))
                )
                # self-send Record
                seq2, val2 = state.seq, state.val
                if new_seq > state.seq:
                    seq2, val2 = new_seq, new_val
                return replace(
                    state,
                    seq=seq2,
                    val=val2,
                    phase=AbdPhase2(
                        request_id=req_id,
                        requester_id=ph.requester_id,
                        read=read,
                        acks=frozenset({Id(id)}),
                    ),
                )
            return replace(state, phase=replace(ph, responses=resp_tuple))

        if ikind == "record":
            req_id, seq, val = imsg[1], imsg[2], imsg[3]
            out.send(src, Internal(AckRecord(req_id)))
            if seq > state.seq:
                return replace(state, seq=seq, val=val)
            return state

        if ikind == "ack_record":
            req_id = imsg[1]
            ph = state.phase
            if not (
                isinstance(ph, AbdPhase2)
                and ph.request_id == req_id
                and Id(src) not in ph.acks
            ):
                return None
            acks = ph.acks | {Id(src)}
            if len(acks) == self._quorum():
                if ph.read is not None:
                    out.send(ph.requester_id, GetOk(req_id, ph.read))
                else:
                    out.send(ph.requester_id, PutOk(req_id))
                return replace(state, phase=None)
            return replace(state, phase=replace(ph, acks=acks))

        return None


class AbdModel(TensorBackedModel, ActorModel):
    """ActorModel with a mechanically compiled device twin
    (``parallel/actor_compiler.py``): unordered non-duplicating or ordered
    networks, ``put_count=1``."""

    def tensor_model(self):
        from ..actor.network import (
            OrderedNetwork,
            UnorderedNonDuplicatingNetwork,
        )
        from ..parallel.actor_compiler import CompileError, compile_actor_model

        if not isinstance(
            self.init_network,
            (UnorderedNonDuplicatingNetwork, OrderedNetwork),
        ):
            # the state_bound below assumes each message is delivered at most
            # once; under a duplicating network a redelivered put restarts a
            # write round, the clock exceeds the write total in REAL runs
            # (the space is unbounded), and the bound would poison reachable
            # transitions
            return None

        # total write ops: each bumps the ABD logical clock at most once
        W = sum(
            a.put_count
            for a in self.actors
            if isinstance(a, RegisterClient)
        )

        def state_bound(i, s):
            # ABD sequencers are (logical clock, server id); each of the W
            # writes bumps the clock by at most one, so clock <= W in any
            # real run — the bound only cuts closure over-approximation.
            return not isinstance(s, AbdState) or s.seq[0] <= W

        def env_bound(env):
            m = env.msg
            if m[0] == "internal" and m[1][0] in ("ack_query", "record"):
                return m[1][2][0] <= W
            return True

        try:
            return compile_actor_model(
                self, state_bound=state_bound, env_bound=env_bound
            )
        except (CompileError, ValueError):
            return None


def abd_model(
    client_count: int,
    server_count: int = 2,
    network: Optional[Network] = None,
    put_count: int = 1,
) -> AbdModel:
    """Build the checked system (reference ``linearizable-register.rs:195-230``;
    ``put_count`` as in reference ``register.rs:96,178-186``)."""
    if network is None:
        network = Network.new_unordered_nonduplicating()
    m = AbdModel(
        cfg=None, init_history=LinearizabilityTester(Register(NULL_VALUE))
    )
    for i in range(server_count):
        m.actor(AbdServer(peers=model_peers(i, server_count)))
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


def main(argv=None) -> int:
    return check_gpu_main(
        "linearizable_register", "[CLIENT_COUNT] [NETWORK]", argv,
        lambda rest: abd_model(
            int(rest[0]) if rest else 2, 2,
            Network.from_name(rest[1]) if len(rest) > 1 else None),
        lambda rest: ("Model checking a linearizable register with "
                      f"{int(rest[0]) if rest else 2} clients on the GPU."),
        max_args=2,
    )


if __name__ == "__main__":
    sys.exit(main())
