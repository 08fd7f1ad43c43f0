"""The UDP actor runtime (reference ``src/actor/spawn.rs``).

The port's own copy of ``stateright_tpu/actor/spawn.py`` (:1-165).  The
same actor code that was model checked can be deployed: one OS thread per
actor, a blocking UDP socket loop, timers implemented as receive timeouts
(reference ``spawn.rs:63-140``).  Ids encode IPv4 socket addresses
(``spawn.rs:9-33``, :meth:`Id.from_addr`/:meth:`Id.to_addr`).

Serialization is pluggable per actor through ``Actor.serialize`` and
``Actor.deserialize`` (JSON by default, as in the reference's examples;
``Choice`` delegates to the actor it wraps).  Malformed input is logged
and dropped (``spawn.rs:105-133``).  The runtime imports no tensor
library: it is host code, and launches no kernel.
"""

from __future__ import annotations

import logging
import random
import socket
import threading
import time
from typing import Iterable, Optional, Tuple

from . import Actor, CancelTimer, Id, Out, Send, SetTimer

log = logging.getLogger(__name__)

#: the receive timeout when no timer is set (reference
#: ``practically_never``, ``spawn.rs:36-38``)
_PRACTICALLY_NEVER = 60.0 * 60.0 * 24.0 * 365.0
#: the longest single wait, so a stop() is seen within it
_POLL_SECS = 0.2


class SpawnedActor:
    """Handle to a running actor thread; ``state`` is its latest state."""

    def __init__(self, id: Id, actor: Actor):
        self.id = id
        self.actor = actor
        self.thread: Optional[threading.Thread] = None
        self.sock: Optional[socket.socket] = None
        self._stop = threading.Event()
        self.state = None

    def stop(self):
        self._stop.set()

    def join(self, timeout: Optional[float] = None):
        if self.thread:
            self.thread.join(timeout)


def _run(handle: SpawnedActor) -> None:
    actor, id, sock = handle.actor, handle.id, handle.sock
    try:
        out = Out()
        state = actor.on_start(id, out)
        log.info("%r started: %r", id, state)
        timer_deadline = _on_commands(actor, id, sock, out, None)
        while not handle._stop.is_set():
            handle.state = state
            timeout = (
                max(0.0, timer_deadline - time.monotonic())
                if timer_deadline is not None
                else _PRACTICALLY_NEVER
            )
            # a small positive floor: settimeout(0) would make the socket
            # non-blocking, and recvfrom would raise BlockingIOError
            # instead of timing out
            sock.settimeout(min(max(timeout, 0.001), _POLL_SECS))
            out = Out()
            try:
                data, addr = sock.recvfrom(65536)
            except (socket.timeout, BlockingIOError):
                if (timer_deadline is not None
                        and time.monotonic() >= timer_deadline):
                    timer_deadline = None
                    new = actor.on_timeout(id, state, out)
                    if new is not None:
                        state = new
                    timer_deadline = _on_commands(actor, id, sock, out,
                                                  timer_deadline)
                continue
            try:
                msg = actor.deserialize(data)
            except Exception as e:  # malformed input is logged and dropped
                log.warning("%r failed to deserialize %r: %r", id, data[:64],
                            e)
                continue
            src = Id.from_addr(addr[0], addr[1])
            new = actor.on_msg(id, state, src, msg, out)
            if new is not None:
                state = new
            timer_deadline = _on_commands(actor, id, sock, out,
                                          timer_deadline)
    finally:
        sock.close()


def _on_commands(actor: Actor, id: Id, sock: socket.socket, out: Out,
                 timer_deadline: Optional[float]) -> Optional[float]:
    """Apply emitted commands: a send serializes and ``sendto``s; a
    ``SetTimer`` samples its random range (reference
    ``spawn.rs:143-183``)."""
    for c in out.commands:
        if isinstance(c, Send):
            try:
                data = actor.serialize(c.msg)
            except Exception as e:  # noqa: BLE001 - logged, the send dropped
                log.warning("%r failed to serialize %r: %r", id, c.msg, e)
                continue
            ip, port = Id(c.dst).to_addr()
            log.info("%r sending %r to %r", id, c.msg, c.dst)
            sock.sendto(data, (ip, port))
        elif isinstance(c, SetTimer):
            low, high = c.duration
            timer_deadline = time.monotonic() + random.uniform(
                low, max(low, high))
        elif isinstance(c, CancelTimer):
            timer_deadline = None
    return timer_deadline


def spawn(actors: Iterable[Tuple[Id, Actor]],
          background: bool = True) -> list[SpawnedActor]:
    """Run actors on real UDP sockets, one thread each (reference
    ``spawn.rs:63-140``).

    ``actors`` pairs each actor with the :class:`Id` encoding its socket
    address (e.g. ``Id.from_addr("127.0.0.1", 3000)``).  Every socket is
    bound before any thread starts, so a caller may send to an actor the
    moment this returns, and a bind failure raises here after releasing
    the sockets already bound.  Returns the handles; with
    ``background=False`` blocks until every thread exits.
    """
    handles = []
    try:
        for id, actor in actors:
            handle = SpawnedActor(Id(id), actor)
            ip, port = handle.id.to_addr()
            handle.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            # appended before the bind, so a failed bind still closes it
            handles.append(handle)
            handle.sock.bind((ip, port))
            handle.thread = threading.Thread(target=_run, args=(handle,),
                                             daemon=True)
    except BaseException:
        # no thread has started, so no _run will close anything: release
        # every socket bound so far, or its port stays taken until the
        # collector runs (an Id that fails to_addr raises here too)
        for h in handles:
            if h.sock is not None:
                h.sock.close()
        raise
    for h in handles:
        h.thread.start()
    if not background:
        for h in handles:
            h.join()
    return handles
