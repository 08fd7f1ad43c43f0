"""Single-decree Paxos under linearizability checking
(reference ``examples/paxos.rs``).

The port's counterpart of ``stateright_tpu/models/paxos.py``: the same
object model (``PaxosState``/``PaxosServer``/``paxos_model``), whose
benchmark configuration — 3 servers, 1..7 clients doing one put each,
unordered non-duplicating lossless network — has the hand-written device
twin :class:`~stateright_tpu_torch.models.paxos_tensor.PaxosTensor`.  Other
configurations on an ordered or non-duplicating network (lossy, or another
server count) fall back to the mechanical compiler
(``parallel/actor_compiler.py``); the duplicating network has no twin:
``tensor_model()`` returns None and ``spawn_gpu()`` raises.

Each server is simultaneously a potential leader (proposer) and an
acceptor.  A client ``put`` triggers a new ballot: the leader broadcasts
``prepare``, collects a majority of ``prepared`` replies (adopting the most
recently accepted proposal if any), broadcasts ``accept``, and on a
majority of ``accepted`` declares the value decided, replying ``put_ok``
and broadcasting ``decided``.  Clients then ``get``; servers only answer
once decided.

Pinned counts: 265 unique / 482 states @ 1 client, 16,668 unique @ 2
clients (reference ``examples/paxos.rs:291,311``), 1,194,428 unique @ 3
clients (the JAX engine's benchmark run); 99 unique @ 1 client on an
ordered network (compiled twin).

Run: ``python -m stateright_tpu_torch.models.paxos check-gpu 3``.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, replace
from typing import Optional

from ..actor import Actor, ActorModel, Id, Network, Out, majority, model_peers
from ..actor.network import UnorderedNonDuplicatingNetwork
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


def _ballot_zero() -> tuple:
    return (0, Id(0))


@dataclass(frozen=True)
class PaxosState:
    """Per-server state (reference ``paxos.rs:78-91``)."""

    ballot: tuple  # (round, leader id)
    # leader state
    proposal: Optional[tuple]  # (request id, requester id, value)
    prepares: tuple  # sorted ((acceptor id, last_accepted), ...)
    accepts: frozenset  # acceptor ids
    # acceptor state
    accepted: Optional[tuple]  # (ballot, proposal)
    is_decided: bool


def _accepted_key(last_accepted):
    """Total order on Option<(Ballot, Proposal)> matching the reference's
    ``max`` over ``prepares.values()`` (None is least)."""
    if last_accepted is None:
        return (0,)
    return (1, last_accepted)


@dataclass
class PaxosServer(Actor):
    """One Paxos server (reference ``paxos.rs:96-222``)."""

    peer_ids: list

    def on_start(self, id: Id, out: Out):
        return PaxosState(
            ballot=_ballot_zero(),
            proposal=None,
            prepares=(),
            accepts=frozenset(),
            accepted=None,
            is_decided=False,
        )

    def on_msg(self, id: Id, state: PaxosState, src: Id, msg, out: Out):
        kind = msg[0]
        if state.is_decided:
            if kind == "get":
                # A server that hasn't decided doesn't know whether a value
                # was decided elsewhere, so it never replies "no value"
                # (reference ``paxos.rs:117-129``).
                _ballot, proposal = state.accepted
                out.send(src, GetOk(msg[1], proposal[2]))
                return state  # reference registers a (possibly no-op) change
            return None

        if kind == "put" and state.proposal is None:
            req_id, value = msg[1], msg[2]
            ballot = (state.ballot[0] + 1, Id(id))
            out.broadcast(self.peer_ids, Internal(("prepare", ballot)))
            return replace(
                state,
                ballot=ballot,
                proposal=(req_id, Id(src), value),
                prepares=((Id(id), state.accepted),),  # self-send Prepared
                accepts=frozenset(),
            )

        if kind != "internal":
            return None
        imsg = msg[1]
        ikind = imsg[0]

        if ikind == "prepare":
            ballot = imsg[1]
            if state.ballot < ballot:
                out.send(src, Internal(("prepared", ballot, state.accepted)))
                return replace(state, ballot=ballot)
            return None

        if ikind == "prepared":
            ballot, last_accepted = imsg[1], imsg[2]
            if ballot != state.ballot:
                return None
            prepares = dict(state.prepares)
            prepares[Id(src)] = last_accepted
            new_prepares = tuple(sorted(prepares.items()))
            new_state = replace(state, prepares=new_prepares)
            quorum = majority(len(self.peer_ids) + 1)
            if len(new_prepares) == quorum:
                # leadership handoff: favor the most recently accepted
                # proposal from the prepare quorum (reference
                # ``paxos.rs:158-179``)
                best = max(
                    (la for _, la in new_prepares), key=_accepted_key
                )
                proposal = best[1] if best is not None else state.proposal
                out.broadcast(
                    self.peer_ids, Internal(("accept", ballot, proposal))
                )
                new_state = replace(
                    new_state,
                    proposal=proposal,
                    accepted=(ballot, proposal),  # self-send Accept
                    accepts=frozenset({Id(id)}),  # self-send Accepted
                )
            return new_state

        if ikind == "accept":
            ballot, proposal = imsg[1], imsg[2]
            if state.ballot <= ballot:
                out.send(src, Internal(("accepted", ballot)))
                return replace(
                    state, ballot=ballot, accepted=(ballot, proposal)
                )
            return None

        if ikind == "accepted":
            ballot = imsg[1]
            if ballot != state.ballot:
                return None
            accepts = state.accepts | {Id(src)}
            new_state = replace(state, accepts=accepts)
            quorum = majority(len(self.peer_ids) + 1)
            if len(accepts) == quorum:
                proposal = state.proposal
                out.broadcast(
                    self.peer_ids, Internal(("decided", ballot, proposal))
                )
                req_id, requester_id, _value = proposal
                out.send(requester_id, PutOk(req_id))
                new_state = replace(new_state, is_decided=True)
            return new_state

        if ikind == "decided":
            ballot, proposal = imsg[1], imsg[2]
            return replace(
                state,
                ballot=ballot,
                accepted=(ballot, proposal),
                is_decided=True,
            )

        return None


class PaxosModel(TensorBackedModel, ActorModel):
    """ActorModel specialization carrying a tensor (device) twin.

    The benchmark configuration uses the hand-written twin
    (``paxos_tensor.py``); other configurations, and every configuration
    that asks for the per-channel packing (``per_channel_()``, which only
    the compiler implements), fall back to the mechanical compiler
    (:meth:`_compiled_tensor`), and configurations neither supports have no
    twin.  Eligibility is derived from the live builder state."""

    def tensor_model(self):
        from .paxos_tensor import MAX_CLIENTS, PaxosTensor

        servers = sum(isinstance(a, PaxosServer) for a in self.actors)
        clients = self.actors[servers:]
        if (
            servers == 3
            and 1 <= len(clients) <= MAX_CLIENTS
            and all(
                isinstance(a, RegisterClient) and a.put_count == 1
                for a in clients
            )
            and not self.lossy
            and isinstance(self.init_network, UnorderedNonDuplicatingNetwork)
            and not self.per_channel_resolved()
        ):
            return PaxosTensor(self, len(clients))
        return self._compiled_tensor(len(clients))

    def _compiled_tensor(self, client_count: int):
        from ..actor.network import OrderedNetwork
        from ..parallel.actor_compiler import CompileError, compile_actor_model

        if not isinstance(
            self.init_network,
            (UnorderedNonDuplicatingNetwork, OrderedNetwork),
        ):
            # the ballot bound below assumes at-most-once delivery; a
            # redelivered put starts extra ballots, exceeding C in real runs
            return None

        C = client_count

        def state_bound(i, s):
            # Each of the C puts starts exactly one new ballot, so ballot
            # rounds never exceed C in a real run; the bound only cuts the
            # closure's over-approximation.
            return not isinstance(s, PaxosState) or s.ballot[0] <= C

        def env_bound(env):
            m = env.msg
            if m[0] == "internal":
                return m[1][1][0] <= C
            return True

        try:
            return compile_actor_model(
                self, state_bound=state_bound, env_bound=env_bound
            )
        except (CompileError, ValueError):
            return None


def paxos_model(
    client_count: int, server_count: int = 3, network: Optional[Network] = None
) -> PaxosModel:
    """Build the checked system (reference ``paxos.rs:231-266``)."""
    if network is None:
        network = Network.new_unordered_nonduplicating()
    m = PaxosModel(
        cfg=None,
        init_history=LinearizabilityTester(Register(NULL_VALUE)),
    )
    for i in range(server_count):
        m.actor(PaxosServer(peer_ids=model_peers(i, server_count)))
    for _ in range(client_count):
        m.actor(RegisterClient(put_count=1, server_count=server_count))
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
    ``_cli.fleet_audit``; JAX ``models/paxos.py``'s hook)."""
    c = int(rest[0]) if rest else 2
    return [(f"paxos clients={c} servers=3", paxos_model(c, 3))]


def sweep_family(n: int = 8):
    """The paxos default sweep (JAX ``paxos.py:314``; the ``sweep`` verb and
    ``STATERIGHT_TPU_SWEEP``): ``n`` single-client instances alternating
    network lossiness.  The lossless members run the hand-written twin, the
    lossy ones each its own compiled twin, so the sweep spans two shape
    cohorts; mixed table seeds widen the fuzz.  Every member must give its
    own sequential counts: 265 / 482 lossless, 2,378 / 8,197 lossy."""
    from ..sweep import SweepInstance, SweepSpec

    insts = []
    for i in range(max(1, int(n))):
        lossy = bool(i % 2)
        m = paxos_model(1, 3)
        if lossy:
            m.lossy_network(True)
        insts.append(SweepInstance(
            f"paxos1-{'lossy-' if lossy else ''}i{i}", m,
            params={"clients": 1, "lossy": lossy, "seed": i // 2},
            seed=i // 2,
        ))
    return SweepSpec(insts)


def udp_servers(rest) -> tuple:
    """The ``spawn`` verb's servers (JAX ``paxos.py`` ``spawn_cmd``): three
    single-decree Paxos servers on 127.0.0.1:3000 to :3002."""
    ids = [Id.from_addr("127.0.0.1", 3000 + i) for i in range(3)]
    banner = ["  A set of servers that implement Single Decree Paxos.",
              "  You can monitor and interact using tools such as nc."]
    return banner, [(i, PaxosServer(peer_ids=[p for p in ids if p != i]))
                    for i in ids]


def main(argv=None) -> int:
    from ._cli import (
        auto,
        check_main,
        explore,
        explore_addr,
        gpu,
        host_bfs,
        make_independence_cmd,
        make_sweep_cmd,
        supervised,
    )

    def what(rest):
        return ("Model checking Single Decree Paxos with "
                f"{int(rest[0]) if rest else 2} clients")

    return check_main(
        "paxos", "[CLIENT_COUNT]", argv,
        lambda rest: paxos_model(int(rest[0]) if rest else 2, 3), {
            "check": (lambda rest: f"{what(rest)} (host BFS).", host_bfs),
            "check-gpu": (lambda rest: f"{what(rest)} on the GPU.", gpu),
            "check-auto": (lambda rest: (
                f"{what(rest)} (auto engine selection)."), auto),
            "supervise": (lambda rest: (
                f"{what(rest)} on the GPU, supervised (autosave, retry "
                "with backoff, resume)."), supervised),
            "explore": (lambda rest: (
                "Exploring Paxos state space with "
                f"{int(rest[0]) if rest else 2} clients on "
                f"{explore_addr(rest)}."), explore),
        },
        max_args=1,
        audit=_audit_models,
        independence=make_independence_cmd(_audit_models),
        sweep=make_sweep_cmd(sweep_family),
        udp=udp_servers,
    )


if __name__ == "__main__":
    sys.exit(main())
