"""Raft leader election, checked on the GPU through the actor compiler.

The port's counterpart of ``stateright_tpu/models/raft.py``: the same object
model (beyond the reference's example set, which ships no Raft), whose twin
the actor compiler's *general* fragment builds — timeout-driven actors with
no auxiliary history, checked against factored properties
(``actor/device_props.py``).

The protocol is the election core of Raft (Ongaro & Ousterhout §5.2):
followers time out and become candidates, candidates solicit votes for a
fresh term, a majority elects a leader.  Terms are bounded by ``max_term``
so the space is finite: a server whose election timer fires at the cap
simply stops campaigning.

Checked properties:

 - **election safety** (always): at most one leader per term, as a
   ``forall_actor_pairs`` predicate;
 - **liveness witness** (sometimes): some execution elects a leader.

Pinned counts: 5,725 unique / 15,607 states for ``raft_model(3)``; 2,926
classes / 7,917 states under symmetry on the GPU engine.

Run: ``python -m stateright_tpu_torch.models.raft check-gpu 3``; with
symmetry, ``... check-sym-gpu 3`` (the GPU engine, through the compiler's
mechanical symmetry) and ``... check-sym 3`` (the host DFS).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import Optional

from ..actor import Actor, ActorModel, Id, Network, Out, majority, model_peers
from ..actor.device_props import exists_actor, forall_actor_pairs
from ..core import Expectation
from ..parallel.tensor_model import TensorBackedModel
from ._cli import (
    auto,
    check_main,
    explore,
    gpu,
    host_bfs,
    host_sym_dfs,
    make_independence_cmd,
    sym_gpu,
)

FOLLOWER, CANDIDATE, LEADER = 0, 1, 2


@dataclass(frozen=True)
class RaftState:
    role: int = FOLLOWER
    term: int = 0
    #: candidate Id this server voted for in `term` (-1: none).  Stored as
    #: Id (not int) so symmetry reduction rewrites them under actor
    #: permutations, on host and in the compiled twin's tables alike
    voted_for: int = -1
    #: granter Ids (candidates only); a frozenset rather than a bitmask so
    #: runtime sockaddr ids (~2^47) work as well as dense model ids
    votes: frozenset = frozenset()


class RaftServer(Actor):
    """Election-only Raft server.

    Messages: ``("req_vote", term)`` solicits, ``("grant", term)``
    grants.  A server votes at most once per term; a candidate counting a
    majority becomes leader and stops campaigning.
    """

    def __init__(
        self,
        peers: list[Id],
        cluster: int,
        max_term: int,
        timer_range=(0.0, 0.0),
    ):
        self.peers = peers
        self.cluster = cluster
        self.max_term = max_term
        # model checking ignores durations (any set timer may fire); a real
        # deployment passes Raft's randomized election timeout here
        self.timer_range = timer_range

    def on_start(self, id: Id, out: Out):
        out.set_timer(self.timer_range)  # election timer
        return RaftState()

    def on_timeout(self, id: Id, state: RaftState, out: Out):
        if state.role == LEADER or state.term >= self.max_term:
            return None  # stop campaigning (timer stays cleared)
        term = state.term + 1
        out.broadcast(self.peers, ("req_vote", term))
        out.set_timer(self.timer_range)  # elections may time out and retry
        return RaftState(
            role=CANDIDATE,
            term=term,
            voted_for=Id(id),
            votes=frozenset((Id(id),)),
        )

    def on_msg(self, id: Id, state: RaftState, src: Id, msg, out: Out):
        kind, term = msg
        if kind == "req_vote":
            if term > state.term:
                # newer term: step down and grant
                out.send(src, ("grant", term))
                return RaftState(term=term, voted_for=Id(src))
            if (
                term == state.term
                and state.role == FOLLOWER
                and state.voted_for in (-1, int(src))
            ):
                out.send(src, ("grant", term))
                if state.voted_for == int(src):
                    return None  # duplicate request, vote already recorded
                return RaftState(term=term, voted_for=Id(src))
            return None  # stale or already voted: ignore
        if kind == "grant":
            if state.role != CANDIDATE or term != state.term:
                return None  # stale grant
            if int(src) in state.votes:
                return None  # duplicate grant
            votes = state.votes | {Id(src)}
            role = (
                LEADER
                if len(votes) >= majority(self.cluster)
                else CANDIDATE
            )
            return RaftState(
                role=role,
                term=state.term,
                voted_for=state.voted_for,
                votes=votes,
            )
        return None


class RaftModel(TensorBackedModel, ActorModel):
    """ActorModel with a mechanically compiled device twin (general
    fragment: timers + factored properties, no history)."""

    max_term = 2

    def tensor_model(self):
        from ..parallel.actor_compiler import CompileError, compile_actor_model

        try:
            return compile_actor_model(
                self,
                # cut the closure's over-approximation at the term cap
                # (reachable states never cross it; poison pins that)
                state_bound=lambda i, s: s.term <= self.max_term,
                env_bound=lambda e: e.msg[1] <= self.max_term,
            )
        except (CompileError, ValueError):
            return None


def raft_model(
    server_count: int = 3,
    max_term: int = 2,
    network: Optional[Network] = None,
) -> RaftModel:
    """Election-safety model: ``server_count`` servers, terms bounded by
    ``max_term``."""
    if network is None:
        network = Network.new_unordered_nonduplicating()
    m = RaftModel(cfg=None, init_history=None)
    m.max_term = max_term
    for i in range(server_count):
        m.actor(
            RaftServer(
                peers=model_peers(i, server_count),
                cluster=server_count,
                max_term=max_term,
            )
        )
    m.init_network_(network)
    m.property(
        Expectation.ALWAYS,
        "election safety",
        forall_actor_pairs(
            lambda i, si, j, sj: not (
                si.role == LEADER and sj.role == LEADER and si.term == sj.term
            )
        ),
    )
    m.property(
        Expectation.SOMETIMES,
        "a leader is elected",
        exists_actor(lambda i, s: s.role == LEADER),
    )
    return m


def _audit_models(rest=()):
    """The configurations of the static audit (the ``audit`` verb and
    ``_cli.fleet_audit``; JAX ``models/raft.py``'s hook)."""
    n = int(rest[0]) if rest else 3
    return [(f"raft servers={n} max_term=2", raft_model(n))]


def udp_servers(rest) -> tuple:
    """The ``spawn`` verb's cluster (JAX ``raft.py`` ``spawn_cmd``):
    ``rest`` is ``[N] [BASE_PORT]`` (3 servers from port 3000 by default),
    with randomized election timeouts of 0.15-0.5 s."""
    n = int(rest[0]) if rest else 3
    base = int(rest[1]) if len(rest) > 1 else 3000
    ids = [Id.from_addr("127.0.0.1", base + i) for i in range(n)]
    banner = [f"Spawning a {n}-server Raft cluster on 127.0.0.1:"
              f"{base}..{base + n - 1} (ctrl-c to stop)"]
    return banner, [(ids[i], RaftServer(peers=[x for x in ids if x != ids[i]],
                                        cluster=n, max_term=1 << 20,
                                        timer_range=(0.15, 0.5)))
                    for i in range(n)]


def main(argv=None) -> int:
    def n(rest):
        return int(rest[0]) if rest else 3

    def what(rest):
        return f"Model checking Raft leader election with {n(rest)} servers"

    return check_main(
        "raft", "[SERVER_COUNT] [NETWORK]", argv,
        lambda rest: raft_model(
            n(rest),
            network=Network.from_name(rest[1]) if len(rest) > 1 else None), {
            "check": (lambda rest: f"{what(rest)} (host BFS).", host_bfs),
            "check-gpu": (lambda rest: f"{what(rest)} on the GPU.", gpu),
            "check-auto": (lambda rest: (
                f"{what(rest)} (auto engine selection)."), auto),
            "check-sym": (lambda rest: (
                f"{what(rest)} (symmetry-reduced DFS)."), host_sym_dfs),
            "check-sym-gpu": (lambda rest: (
                f"{what(rest)} on the GPU (mechanical symmetry "
                "reduction)."), sym_gpu),
            "explore": (lambda rest: None, explore),
        },
        max_args=2,
        audit=_audit_models,
        independence=make_independence_cmd(_audit_models),
        udp=udp_servers,
    )


if __name__ == "__main__":
    sys.exit(main())
