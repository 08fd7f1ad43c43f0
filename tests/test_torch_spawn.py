"""The port's UDP actor runtime (``stateright_tpu_torch/actor/spawn.py``)
on real loopback sockets: the five cases of ``tests/test_spawn.py`` on the
port's actors (a register server's put/get over UDP, a malformed datagram
dropped, the release of the sockets a partial bind took, an ordered
reliable link's resend after an injected drop, raft leader election with
real timer fires), each with its own timeout; then the socket-address ids
and the wire serialization against the JAX package's, ``Choice``'s serde
delegates, the ``spawn`` verbs and ``serve_fizzbuzz``.  Localhost only."""

import json
import socket
import time
import urllib.request
from dataclasses import dataclass

import pytest

from stateright_tpu import actor as jactor
from stateright_tpu_torch.actor import Actor, Choice, Id, Out
from stateright_tpu_torch.actor.ordered_reliable_link import (
    OrderedReliableLink,
)
from stateright_tpu_torch.actor.spawn import spawn
from stateright_tpu_torch.models.single_copy_register import SingleCopyServer


def free_port() -> int:
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def wait_until(pred, timeout=10.0, interval=0.01):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return pred()


def stop_all(handles):
    for h in handles:
        h.stop()
    for h in handles:
        h.join(2.0)


@pytest.fixture
def client_sock():
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.bind(("127.0.0.1", 0))
    s.settimeout(5.0)
    yield s
    s.close()


def test_register_server_put_get_over_udp(client_sock):
    """A single-copy register server on a real socket answers a put/get
    round trip of raw JSON datagrams, and its state converges to the
    written value."""
    port = free_port()
    handles = spawn([(Id.from_addr("127.0.0.1", port), SingleCopyServer())])
    try:
        addr = ("127.0.0.1", port)
        client_sock.sendto(json.dumps(["put", 1, "X"]).encode(), addr)
        reply, _ = client_sock.recvfrom(65536)
        assert json.loads(reply) == ["put_ok", 1]
        client_sock.sendto(json.dumps(["get", 2]).encode(), addr)
        reply, _ = client_sock.recvfrom(65536)
        assert json.loads(reply) == ["get_ok", 2, "X"]
        assert wait_until(lambda: handles[0].state == "X")
    finally:
        stop_all(handles)


def test_malformed_datagram_is_dropped(client_sock):
    """Garbage input is logged and dropped; the actor thread lives on and
    answers the next well-formed request."""
    port = free_port()
    handles = spawn([(Id.from_addr("127.0.0.1", port), SingleCopyServer())])
    try:
        addr = ("127.0.0.1", port)
        client_sock.sendto(b"\xff\xfenot json", addr)
        client_sock.sendto(json.dumps(["put", 7, "Y"]).encode(), addr)
        reply, _ = client_sock.recvfrom(65536)
        assert json.loads(reply) == ["put_ok", 7]
        assert handles[0].thread.is_alive()
    finally:
        stop_all(handles)


def test_partial_bind_failure_releases_the_bound_sockets():
    """A later actor's bind fails: the sockets already bound are closed
    before the error propagates, so their ports can be bound again."""
    ok_port = free_port()
    blocker = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    blocker.bind(("127.0.0.1", 0))
    taken_port = blocker.getsockname()[1]
    try:
        with pytest.raises(OSError):
            spawn([
                (Id.from_addr("127.0.0.1", ok_port), SingleCopyServer()),
                (Id.from_addr("127.0.0.1", taken_port), SingleCopyServer()),
            ])
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.bind(("127.0.0.1", ok_port))
        s.close()
    finally:
        blocker.close()


@dataclass
class BurstSender(Actor):
    """Sends a burst of messages at start; the link sequences them."""

    dst: int
    msgs: tuple

    def on_start(self, id: Id, out: Out):
        for m in self.msgs:
            out.send(Id(self.dst), m)
        return ()


class Recorder(Actor):
    """Accumulates every delivered message, in order."""

    def on_start(self, id: Id, out: Out):
        return ()

    def on_msg(self, id: Id, state, src: Id, msg, out: Out):
        return state + (msg,)


def test_orl_resends_until_acked_after_an_injected_drop():
    """Both messages go to a port nobody has bound (the datagrams vanish:
    a drop).  When the receiver comes up, the sender's resend timer
    delivers them in order, exactly once, and the acks drain the pending
    set."""
    sport, rport = free_port(), free_port()
    sender_id = Id.from_addr("127.0.0.1", sport)
    receiver_id = Id.from_addr("127.0.0.1", rport)
    sender = OrderedReliableLink(
        BurstSender(dst=int(receiver_id), msgs=(("hello", 1), ("world", 2))),
        resend_interval=(0.05, 0.1),
    )
    s_handles = spawn([(sender_id, sender)])
    try:
        assert wait_until(
            lambda: s_handles[0].state is not None
            and len(s_handles[0].state.msgs_pending_ack) == 2)
        time.sleep(0.15)  # at least one resend into the void
        receiver = OrderedReliableLink(Recorder(),
                                       resend_interval=(0.05, 0.1))
        r_handles = spawn([(receiver_id, receiver)])
        try:
            assert wait_until(
                lambda: r_handles[0].state is not None
                and len(r_handles[0].state.wrapped_state) >= 2
            ), "the link never redelivered after the drop"
            want = (("hello", 1), ("world", 2))
            assert r_handles[0].state.wrapped_state == want
            assert wait_until(
                lambda: len(s_handles[0].state.msgs_pending_ack) == 0
            ), "the acks never drained the pending set"
            time.sleep(0.3)  # a few more resend timer cycles
            assert r_handles[0].state.wrapped_state == want, (
                "at-most-once delivery violated by a late resend")
        finally:
            stop_all(r_handles)
    finally:
        stop_all(s_handles)


def test_raft_leader_election_over_udp():
    """The raft server that was model checked, on loopback sockets with
    randomized election timeouts: three servers elect a leader through
    real UDP exchange and timer fires, one leader per term."""
    from stateright_tpu_torch.models.raft import LEADER, RaftServer

    ports = [free_port() for _ in range(3)]
    ids = [Id.from_addr("127.0.0.1", p) for p in ports]
    handles = spawn([
        (ids[i], RaftServer(peers=[x for x in ids if x != ids[i]], cluster=3,
                            max_term=50, timer_range=(0.02, 0.12)))
        for i in range(3)
    ])
    try:
        assert wait_until(
            lambda: any(h.state is not None and h.state.role == LEADER
                        for h in handles),
            timeout=15.0,
        ), [h.state for h in handles]
        states = [h.state for h in handles if h.state is not None]
        leaders_by_term = [s.term for s in states if s.role == LEADER]
        assert len(leaders_by_term) == len(set(leaders_by_term)), states
    finally:
        stop_all(handles)


# -- against the JAX package -------------------------------------------------------


@pytest.mark.parametrize("ip,port", [("127.0.0.1", 3000), ("10.1.2.3", 65535),
                                     ("0.0.0.0", 0), ("255.255.255.255", 1)])
def test_ids_pack_socket_addresses_as_jax_does(ip, port):
    i = Id.from_addr(ip, port)
    assert int(i) == int(jactor.Id.from_addr(ip, port))
    assert i.to_addr() == (ip, port) == jactor.Id(int(i)).to_addr()
    with pytest.raises(ValueError):
        Id.from_addr("127.0.0", port)


@pytest.mark.parametrize("msg", [("put", 1, "X"), ("get_ok", 2, "\0"),
                                 ("deliver", 3, ("hello", [1, 2])),
                                 {"k": ["v", 1]}, 7])
def test_wire_serialization_equals_jax(msg):
    a, j = Actor(), jactor.Actor()
    assert a.serialize(msg) == j.serialize(msg)
    data = a.serialize(msg)
    assert a.deserialize(data) == j.deserialize(data)
    wrapped = Choice.new(Recorder()).or_()
    assert wrapped.serialize(msg) == data
    assert wrapped.deserialize(data) == a.deserialize(data)


class Tagged(Actor):
    """An actor with a wire format of its own (a prefix byte)."""

    def on_start(self, id: Id, out: Out):
        return 0

    def serialize(self, msg) -> bytes:
        return b"T" + json.dumps(msg).encode()

    def deserialize(self, data: bytes):
        if not data.startswith(b"T"):
            raise ValueError("untagged")
        return tuple(json.loads(data[1:]))


def test_choice_delegates_serde_over_udp(client_sock):
    """A ``Choice``-wrapped actor speaks the wrapped actor's wire format
    on a real socket: an untagged datagram is dropped, a tagged one is
    delivered."""
    class Echo(Tagged):
        def on_msg(self, id, state, src, msg, out):
            out.send(src, ("echo",) + tuple(msg))
            return state + 1

    port = free_port()
    handles = spawn([(Id.from_addr("127.0.0.1", port),
                      Choice.new(Echo()))])
    try:
        addr = ("127.0.0.1", port)
        client_sock.sendto(json.dumps(["x"]).encode(), addr)  # dropped
        client_sock.sendto(b"T" + json.dumps(["y", 1]).encode(), addr)
        reply, _ = client_sock.recvfrom(65536)
        assert reply == b"T" + json.dumps(["echo", "y", 1]).encode()
        assert wait_until(lambda: handles[0].state.state == 1)
    finally:
        stop_all(handles)


# -- the verbs ----------------------------------------------------------------------


@pytest.mark.parametrize("module,n", [("single_copy_register", 1),
                                      ("linearizable_register", 2),
                                      ("paxos", 3), ("raft", 3),
                                      ("write_once_register", 1)])
def test_spawn_verbs_deploy_the_jax_servers(module, n, monkeypatch, capsys):
    """Each model's ``spawn`` verb deploys the servers JAX's does (ids,
    actor classes, peers), prints a listening line per server and blocks
    in ``spawn(..., background=False)``."""
    import importlib

    import stateright_tpu_torch.actor as port_actor

    calls = []
    monkeypatch.setattr(port_actor, "spawn",
                        lambda actors, background=True: calls.append(
                            (list(actors), background)) or [])
    mod = importlib.import_module(f"stateright_tpu_torch.models.{module}")
    assert mod.main(["spawn"]) == 0
    (actors, background), = calls
    assert background is False and len(actors) == n
    assert [int(i) for i, _ in actors] == [
        int(Id.from_addr("127.0.0.1", 3000 + k)) for k in range(n)]
    out = capsys.readouterr().out
    assert out.count("Server listening on") == n
    for _, a in actors:
        peers = getattr(a, "peers", getattr(a, "peer_ids", None))
        if peers is not None:
            assert len(peers) == n - 1


def test_raft_spawn_verb_takes_a_count_and_a_base_port():
    from stateright_tpu_torch.models import raft

    banner, actors = raft.udp_servers(["5", "4000"])
    assert [int(i) for i, _ in actors] == [
        int(Id.from_addr("127.0.0.1", 4000 + k)) for k in range(5)]
    assert actors[-1][1].timer_range == (0.15, 0.5)
    assert "4000..4004" in banner[0]


def test_register_spawn_verb_serves_over_udp(client_sock):
    """The verb's deployment path end to end, in the background on a free
    port: put then get through the spawned single-copy server."""
    from stateright_tpu_torch.models import _cli

    port = free_port()
    handles = _cli.udp_spawn(
        [], [(Id.from_addr("127.0.0.1", port), SingleCopyServer())],
        background=True)
    try:
        addr = ("127.0.0.1", port)
        client_sock.sendto(json.dumps(["put", 3, "Z"]).encode(), addr)
        assert json.loads(client_sock.recvfrom(65536)[0]) == ["put_ok", 3]
        client_sock.sendto(json.dumps(["get", 4]).encode(), addr)
        assert json.loads(client_sock.recvfrom(65536)[0]) == [
            "get_ok", 4, "Z"]
    finally:
        stop_all(handles)


def test_serve_fizzbuzz_serves_the_explorer():
    from stateright_tpu_torch.models.quickstart import serve_fizzbuzz

    s = serve_fizzbuzz("localhost:0", block=False)
    try:
        s.checker.join()
        with urllib.request.urlopen(f"http://{s.addr}/.status",
                                    timeout=10) as r:
            st = json.loads(r.read())
        assert st["done"] and st["unique_state_count"] == 31
    finally:
        s.shutdown()
