"""ActorModel: compile actors + network + properties into a checkable Model
(reference ``src/actor/model.rs``, ``src/actor/model_state.rs``).

The port's own copy of ``stateright_tpu/actor/model.py``, with the
symmetry ``ActorModelState.representative`` and the sequence-diagram
``as_svg`` that the Explorer's ``/.states`` views carry.

``cfg`` is an arbitrary config value, ``history`` an auxiliary history kept
TLA-style alongside the system (e.g. a linearizability tester); both are
available to property conditions.  Transition semantics follow the reference
precisely (they determine the pinned state-space counts):

 - ``Deliver``: run ``on_msg``; a no-op handler result prunes the transition
   (``model.rs:253-260``); otherwise consume the envelope per network
   semantics, swap the actor state, update history via ``record_msg_in``,
   then apply emitted commands (sends → network + ``record_msg_out``;
   timer flags).
 - ``Timeout``: run ``on_timeout``; the timer flag clears even on a no-op,
   so a timeout is never pruned (``model.rs:288-306``).
 - ``Drop``: lossy networks only; remove the envelope (``model.rs:243-247``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence

from ..core import Expectation, Model, Property
from ..fingerprint import stable_hash, stable_words
from . import Actor, CancelTimer, Id, Out, Send, SetTimer
from .network import Envelope, Network


# -- actions (reference ``model.rs:42-51``) ----------------------------------


@dataclass(frozen=True)
class Deliver:
    src: Id
    dst: Id
    msg: Any

    def __repr__(self):
        return f"{self.src!r} → {self.msg!r} → {self.dst!r}"


@dataclass(frozen=True)
class Drop:
    envelope: Envelope

    def __repr__(self):
        return f"Drop({self.envelope!r})"


@dataclass(frozen=True)
class Timeout:
    id: Id

    def __repr__(self):
        return f"Timeout({self.id!r})"


# -- system state (reference ``model_state.rs:10-15``) -----------------------


@dataclass(frozen=True)
class ActorModelState:
    """Snapshot of the whole system: per-actor states, in-flight network,
    timer flags, auxiliary history."""

    actor_states: tuple
    network: Network
    is_timer_set: tuple
    history: Any = None

    def __hash__(self):
        return stable_hash(self)

    def stable_words(self, out: list) -> None:
        out.append(0xA5)
        stable_words(tuple(self.actor_states), out)
        self.network.stable_words(out)
        stable_words(tuple(self.is_timer_set), out)
        stable_words(self.history, out)

    def representative(self) -> "ActorModelState":
        """Canonical member of this state's symmetry class: actor states
        sorted by their stable hash, ids rewritten across the states, the
        network and the history (reference ``model_state.rs:103-118``)."""
        from ..symmetry import RewritePlan, rewrite_value

        plan = RewritePlan.from_values_to_sort(
            [stable_hash(s) for s in self.actor_states]
        )
        return ActorModelState(
            actor_states=tuple(
                rewrite_value(s, plan) for s in plan.reindex(self.actor_states)
            ),
            network=rewrite_value(self.network, plan),
            is_timer_set=tuple(plan.reindex(self.is_timer_set)),
            history=rewrite_value(self.history, plan),
        )


class _Draft:
    """Mutable builder for the immutable ActorModelState."""

    __slots__ = ("actor_states", "network", "is_timer_set", "history")

    def __init__(self, base: ActorModelState):
        self.actor_states = list(base.actor_states)
        self.network = base.network
        self.is_timer_set = list(base.is_timer_set)
        self.history = base.history

    def freeze(self) -> ActorModelState:
        return ActorModelState(
            actor_states=tuple(self.actor_states),
            network=self.network,
            is_timer_set=tuple(self.is_timer_set),
            history=self.history,
        )


def _default_boundary(cfg, state) -> bool:
    return True


def _xml_escape(text: str) -> str:
    return (
        text.replace("&", "&amp;")
        .replace("<", "&lt;")
        .replace(">", "&gt;")
        .replace("'", "&apos;")
    )


class ActorModel(Model):
    """Builder + Model implementation (reference ``model.rs:27-155,187-494``)."""

    def __init__(self, cfg: Any = None, init_history: Any = None):
        self.actors: list[Actor] = []
        self.cfg = cfg
        self.init_history = init_history
        self.init_network: Network = Network.new_unordered_duplicating()
        self.lossy: bool = False
        # None = unset (the STATERIGHT_TPU_PER_CHANNEL env knob decides),
        # else the per_channel_() builder's explicit choice
        self.per_channel: Optional[bool] = None
        self._properties: list[Property] = []
        self._record_msg_in: Callable = lambda cfg, h, env: None
        self._record_msg_out: Callable = lambda cfg, h, env: None
        self._within_boundary: Callable = _default_boundary

    # -- builder (reference ``model.rs:80-155``) -----------------------------

    def actor(self, actor: Actor) -> "ActorModel":
        self._config_mutated()
        self.actors.append(actor)
        return self

    def init_network_(self, network: Network) -> "ActorModel":
        self._config_mutated()
        self.init_network = network
        return self

    def lossy_network(self, lossy: bool) -> "ActorModel":
        self._config_mutated()
        self.lossy = lossy
        return self

    def per_channel_(self, enabled: bool = True) -> "ActorModel":
        """Request the per-(src, dst)-channel network packing for the
        compiled device twin (``parallel/actor_compiler.py``): the row
        holds one slot region per directed channel instead of one global
        slot multiset, so a delivery's writes are statically confined.
        It changes row fingerprints (an encoding choice, like the twin
        itself); unique/total counts and property verdicts equal the
        slot-multiset packing's.  An ORDERED flow holding the same
        message at more ranks than its channel's distinct-code count
        poisons loudly: raise the region size with
        ``compile_actor_model(per_channel_depth=...)``.  CLI flag:
        ``--per-channel`` on the ``check-gpu`` verbs; env knob:
        ``STATERIGHT_TPU_PER_CHANNEL=1``."""
        self._config_mutated()
        self.per_channel = bool(enabled)
        return self

    def per_channel_resolved(self) -> bool:
        """The effective per-channel choice: the builder flag when set,
        else the ``STATERIGHT_TPU_PER_CHANNEL=1`` env knob.  The one
        resolution rule, shared by the compiler and by ``tensor_model``
        implementations that route between a hand-written slot-multiset
        twin and the compiled per-channel one (``models/paxos.py``)."""
        if self.per_channel is not None:
            return bool(self.per_channel)
        return os.environ.get("STATERIGHT_TPU_PER_CHANNEL", "") == "1"

    def property(
        self, expectation: Expectation, name: str, condition: Callable
    ) -> "ActorModel":
        self._config_mutated()
        self._properties.append(Property(expectation, name, condition))
        return self

    def record_msg_in(self, fn: Callable) -> "ActorModel":
        """``fn(cfg, history, envelope) -> Optional[new_history]``."""
        self._config_mutated()
        self._record_msg_in = fn
        return self

    def record_msg_out(self, fn: Callable) -> "ActorModel":
        self._config_mutated()
        self._record_msg_out = fn
        return self

    def within_boundary_(self, fn: Callable) -> "ActorModel":
        self._config_mutated()
        self._within_boundary = fn
        return self

    # -- Model implementation ------------------------------------------------

    def properties(self) -> Sequence[Property]:
        return list(self._properties)

    def within_boundary(self, state: ActorModelState) -> bool:
        return self._within_boundary(self.cfg, state)

    def init_states(self) -> list[ActorModelState]:
        draft = _Draft(
            ActorModelState(
                actor_states=(),
                network=self.init_network,
                is_timer_set=(False,) * len(self.actors),
                history=self.init_history,
            )
        )
        for index, actor in enumerate(self.actors):
            out = Out()
            state = actor.on_start(Id(index), out)
            draft.actor_states.append(state)
            self._process_commands(Id(index), out, draft)
        return [draft.freeze()]

    def actions(self, state: ActorModelState) -> list:
        acts: list = []
        for env in state.network.iter_deliverable():
            # option 1: message is lost (reference ``model.rs:218-220``)
            if self.lossy:
                acts.append(Drop(env))
            # option 2: delivered — unless the recipient doesn't exist
            if int(env.dst) < len(self.actors):
                acts.append(Deliver(src=env.src, dst=env.dst, msg=env.msg))
        # option 3: timeouts (reference ``model.rs:234-238``)
        for index, is_set in enumerate(state.is_timer_set):
            if is_set:
                acts.append(Timeout(Id(index)))
        return acts

    def next_state(
        self, sys: ActorModelState, action
    ) -> Optional[ActorModelState]:
        if isinstance(action, Drop):
            draft = _Draft(sys)
            draft.network = draft.network.on_drop(action.envelope)
            return draft.freeze()

        if isinstance(action, Deliver):
            index = int(action.dst)
            if index >= len(sys.actor_states):
                return None  # undeliverable (reference ``model.rs:253``)
            last_actor_state = sys.actor_states[index]
            out = Out()
            new_actor_state = self.actors[index].on_msg(
                Id(index), last_actor_state, action.src, action.msg, out
            )
            if new_actor_state is None and not out.commands:
                return None  # no-op prune (reference ``model.rs:260``)
            env = Envelope(src=action.src, dst=action.dst, msg=action.msg)
            history = self._record_msg_in(self.cfg, sys.history, env)
            draft = _Draft(sys)
            draft.network = draft.network.on_deliver(env)
            if new_actor_state is not None:
                draft.actor_states[index] = new_actor_state
            if history is not None:
                draft.history = history
            self._process_commands(Id(index), out, draft)
            return draft.freeze()

        if isinstance(action, Timeout):
            index = int(action.id)
            out = Out()
            new_actor_state = self.actors[index].on_timeout(
                Id(index), sys.actor_states[index], out
            )
            draft = _Draft(sys)
            draft.is_timer_set[index] = False  # timer no longer valid
            if new_actor_state is not None:
                draft.actor_states[index] = new_actor_state
            self._process_commands(Id(index), out, draft)
            return draft.freeze()

        raise TypeError(f"unknown action {action!r}")

    # -- helpers -------------------------------------------------------------

    def _process_commands(self, id: Id, out: Out, draft: _Draft) -> None:
        """Apply emitted commands to the draft system state
        (reference ``model.rs:158-184``)."""
        index = int(id)
        for c in out.commands:
            if isinstance(c, Send):
                env = Envelope(src=id, dst=c.dst, msg=c.msg)
                history = self._record_msg_out(self.cfg, draft.history, env)
                if history is not None:
                    draft.history = history
                draft.network = draft.network.send(env)
            elif isinstance(c, SetTimer):
                while len(draft.is_timer_set) <= index:
                    draft.is_timer_set.append(False)
                draft.is_timer_set[index] = True
            elif isinstance(c, CancelTimer):
                draft.is_timer_set[index] = False

    def as_svg(self, path) -> Optional[str]:
        """Sequence diagram for an actor-system trace (JAX
        ``stateright_tpu/actor/model.py:343-442``; reference
        ``src/actor/model.rs:384-475``): a vertical timeline per actor,
        an arrow per delivery from its send time to its delivery time, a
        circle per timeout, and message labels drawn last so they sit on
        top.  Send times are recovered by re-running the (pure) handlers
        along the path, exactly as the reference does."""
        entries = path.into_vec()  # [(state, action|None), ...]
        if not entries:
            return None
        actor_count = len(entries[-1][0].actor_states)

        def plot(x: int, y: int) -> tuple[int, int]:
            return x * 100, y * 30

        svg_w, svg_h = plot(actor_count, len(entries))
        svg_w += 300  # extra width for event labels, as in the reference
        out = [
            f"<svg version='1.1' baseProfile='full' "
            f"width='{svg_w}' height='{svg_h}' "
            f"viewBox='-20 -20 {svg_w + 20} {svg_h + 20}' "
            f"xmlns='http://www.w3.org/2000/svg'>",
            "<defs><marker class='svg-event-shape' id='arrow' "
            "markerWidth='12' markerHeight='10' refX='12' refY='5' "
            "orient='auto'><polygon points='0 0, 12 5, 0 10' />"
            "</marker></defs>",
        ]
        for index in range(actor_count):
            x1, y1 = plot(index, 0)
            x2, y2 = plot(index, len(entries))
            out.append(
                f"<line x1='{x1}' y1='{y1}' x2='{x2}' y2='{y2}' "
                "class='svg-actor-timeline' />"
            )
            out.append(
                f"<text x='{x1}' y='{y1}' class='svg-actor-label'>"
                f"{index}</text>"
            )

        def track_sends(handler_id: Id, cmds, time: int) -> None:
            for c in cmds:
                if isinstance(c, Send):
                    send_time[(handler_id, c.dst, c.msg)] = time

        # Arrows for deliveries, circles for timeouts.  ``time`` is the row
        # the action lands on (the action at entry i produces entry i+1).
        send_time: dict = {}
        for i, (state, action) in enumerate(entries):
            time = i + 1
            if isinstance(action, Deliver):
                src_time = send_time.get((action.src, action.dst, action.msg), 0)
                x1, y1 = plot(int(action.src), src_time)
                x2, y2 = plot(int(action.dst), time)
                out.append(
                    f"<line x1='{x1}' x2='{x2}' y1='{y1}' y2='{y2}' "
                    "marker-end='url(#arrow)' class='svg-event-line' />"
                )
                index = int(action.dst)
                if index < len(state.actor_states):
                    cmds = Out()
                    self.actors[index].on_msg(
                        Id(index),
                        state.actor_states[index],
                        action.src,
                        action.msg,
                        cmds,
                    )
                    track_sends(Id(index), cmds.commands, time)
            elif isinstance(action, Timeout):
                index = int(action.id)
                x, y = plot(index, time)
                out.append(
                    f"<circle cx='{x}' cy='{y}' r='10' "
                    "class='svg-event-shape' />"
                )
                if index < len(state.actor_states):
                    cmds = Out()
                    self.actors[index].on_timeout(
                        Id(index), state.actor_states[index], cmds
                    )
                    track_sends(Id(index), cmds.commands, time)

        # Event labels drawn last so they render over the shapes.
        for i, (_state, action) in enumerate(entries):
            time = i + 1
            if isinstance(action, Deliver):
                x, y = plot(int(action.dst), time)
                out.append(
                    f"<text x='{x}' y='{y}' class='svg-event-label'>"
                    f"{_xml_escape(repr(action.msg))}</text>"
                )
            elif isinstance(action, Timeout):
                x, y = plot(int(action.id), time)
                out.append(
                    f"<text x='{x}' y='{y}' class='svg-event-label'>"
                    "Timeout</text>"
                )
        out.append("</svg>")
        return "".join(out)

    def format_action(self, action) -> str:
        return repr(action)

    def format_step(self, last_state, action) -> Optional[str]:
        nxt = self.next_state(last_state, action)
        if nxt is None:
            return None
        lines = []
        for i, (a, b) in enumerate(zip(last_state.actor_states, nxt.actor_states)):
            mark = " *" if a != b else ""
            lines.append(f"actor {i}: {b!r}{mark}")
        lines.append(f"network: {sorted(map(repr, nxt.network.iter_all()))}")
        if nxt.history is not None:
            lines.append(f"history: {nxt.history!r}")
        return "\n".join(lines)
