"""Ordered reliable link: a "perfect link" over a lossy network
(reference ``src/actor/ordered_reliable_link.rs``).

The port's own copy of ``stateright_tpu/actor/ordered_reliable_link.py``.
It wraps any actor with sequence numbers, acks, resend-on-timeout and
at-most-once delivery, so the wrapped actor sees an ordered reliable
channel per source even when the underlying network loses, duplicates or
reorders.  Messages: ``("deliver", seq, msg)`` and ``("ack", seq)``.

Restrictions as in the reference: wrapped actors may not use timers
(``SetTimer``/``CancelTimer`` raise, ``ordered_reliable_link.rs:135-139``),
and actors must not restart (sequencers are not persisted).  A system of
ORL-wrapped actors compiles for the GPU engine through the actor
compiler's general fragment when it is finite; the sequencers of one that
keeps sending grow without bound, and the compiler's cap errors then name
the wrapper's fields (``parallel/actor_compiler.py::_orl_hint``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Tuple

from . import Actor, CancelTimer, Id, Out, Send, SetTimer


@dataclass(frozen=True)
class LinkState:
    """ORL bookkeeping around the wrapped actor's state
    (reference ``ordered_reliable_link.rs:48-57``)."""

    next_send_seq: int
    #: frozenset of (seq, dst, msg): sent but not yet acked
    msgs_pending_ack: frozenset
    #: frozenset of (src, last_seq): at-most-once delivery watermark
    last_delivered_seqs: frozenset
    wrapped_state: Any

    def _delivered(self, src: Id) -> int:
        for s, seq in self.last_delivered_seqs:
            if s == src:
                return seq
        return 0


@dataclass
class OrderedReliableLink(Actor):
    """Actor wrapper (reference ``ActorWrapper``,
    ``ordered_reliable_link.rs:30-33``)."""

    wrapped_actor: Actor
    resend_interval: Tuple[float, float] = (1.0, 2.0)

    def on_start(self, id: Id, out: Out):
        out.set_timer(self.resend_interval)
        wrapped_out = Out()
        wrapped_state = self.wrapped_actor.on_start(id, wrapped_out)
        state = LinkState(
            next_send_seq=1,
            msgs_pending_ack=frozenset(),
            last_delivered_seqs=frozenset(),
            wrapped_state=wrapped_state,
        )
        return self._process_output(state, wrapped_out, out)

    def on_msg(self, id: Id, state: LinkState, src: Id, msg, out: Out):
        kind = msg[0]
        if kind == "deliver":
            _, seq, wrapped_msg = msg
            # always ack to stop resends; drop if already delivered
            out.send(src, ("ack", seq))
            if seq <= state._delivered(src):
                return None
            wrapped_out = Out()
            new_wrapped = self.wrapped_actor.on_msg(
                id, state.wrapped_state, src, wrapped_msg, wrapped_out
            )
            if new_wrapped is None and not wrapped_out.commands:
                return None  # inner no-op: don't advance the watermark
            delivered = frozenset(
                p for p in state.last_delivered_seqs if p[0] != src
            ) | {(Id(src), seq)}
            state = LinkState(
                next_send_seq=state.next_send_seq,
                msgs_pending_ack=state.msgs_pending_ack,
                last_delivered_seqs=delivered,
                wrapped_state=(
                    new_wrapped
                    if new_wrapped is not None
                    else state.wrapped_state
                ),
            )
            return self._process_output(state, wrapped_out, out)
        if kind == "ack":
            _, seq = msg
            pending = frozenset(
                p for p in state.msgs_pending_ack if p[0] != seq
            )
            # the reference always registers a state change here, even for
            # an unknown seq (``state.to_mut()`` unconditionally)
            return LinkState(
                next_send_seq=state.next_send_seq,
                msgs_pending_ack=pending,
                last_delivered_seqs=state.last_delivered_seqs,
                wrapped_state=state.wrapped_state,
            )
        return None

    def on_timeout(self, id: Id, state: LinkState, out: Out):
        out.set_timer(self.resend_interval)
        for seq, dst, msg in sorted(
            state.msgs_pending_ack, key=lambda p: p[0]
        ):
            out.send(dst, ("deliver", seq, msg))
        return None

    def _process_output(
        self, state: LinkState, wrapped_out: Out, out: Out
    ) -> LinkState:
        """Wrap each inner send with a sequencer and track it pending ack
        (reference ``ordered_reliable_link.rs:130-149``)."""
        next_seq = state.next_send_seq
        pending = set(state.msgs_pending_ack)
        for c in wrapped_out.commands:
            if isinstance(c, (SetTimer, CancelTimer)):
                raise NotImplementedError(
                    "timers in ORL-wrapped actors are not supported"
                )
            assert isinstance(c, Send)
            out.send(c.dst, ("deliver", next_seq, c.msg))
            pending.add((next_seq, Id(c.dst), c.msg))
            next_seq += 1
        return LinkState(
            next_send_seq=next_seq,
            msgs_pending_ack=frozenset(pending),
            last_delivered_seqs=state.last_delivered_seqs,
            wrapped_state=state.wrapped_state,
        )
