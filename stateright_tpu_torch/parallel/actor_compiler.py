"""Mechanical actor-system → tensor-form compiler.

The port's counterpart of ``stateright_tpu/parallel/actor_compiler.py``:
the host half (closure and its fail-fast estimate, tables, channel layout,
symmetry tables, host bridge) is the JAX module's, line for line, so both
compilers number local states and envelopes alike and produce the same
rows; the device half is plain PyTorch on int64 bit patterns
(``ops/hashing.py``), its packed words assembled by the coalesced
:class:`FieldWriter` (the JAX compiler's ``step_rows_coalesced``).  Both
network packings are here: the global slot multiset and the per-channel layout
(``per_channel``), and the mechanical symmetry of the general fragment
(``representative_rows``/``representative_key``, built on demand), and
the ``OrderedReliableLink`` hint of the cap errors (:func:`_orl_hint`),
and the declared value bounds the static sanitizer seeds from
(:meth:`CompiledActorTensor.row_domain`).

It compiles Python actor handlers into table-driven ``step_rows`` for two
fragments (reference transition semantics: ``src/actor/model.rs:187-306``):

 - the **register workload** (reference ``src/actor/register.rs`` and
   ``src/actor/write_once_register.rs``): protocol servers +
   ``RegisterClient`` clients with any uniform ``put_count`` (write-once
   clients with ``put_count=1``), a linearizability-tester history, and
   the standard linearizable/value-chosen properties (plus factored
   extras);
 - the **general fragment**: any bounded actor system with
   ``init_history=None`` — including **timeout-driven** actors (timer bits
   in the row, one Timeout action per armed actor, ``SetTimer``/
   ``CancelTimer`` effects tabulated with last-command-wins semantics) —
   whose properties are factored predicates (``actor/device_props.py``),
   tabulated per actor (or actor pair) over the compiled state universes.

Both support all three network semantics (non-duplicating multiset,
duplicating set, per-pair ordered FIFO), optionally lossy.

How: a bounded host-side closure co-enumerates

 - per-actor reachable state universes ``S_i`` (states become small integer
   codes),
 - the envelope universe ``E`` (envelopes become slot codes for the
   sorted-slot multiset network of ``actor_tensor.py``), and
 - the transition relation ``T_i[s, e] -> (s', sends…)`` by *running each
   actor's real ``on_msg`` handler once per (state, envelope) pair* — the
   handlers never run on the device, only their tabulated effects do.

The closure over-approximates reachability (it pairs every known state with
every known envelope), so protocols whose field domains grow with context
(Paxos ballots, ABD sequencers) need a ``state_bound`` predicate to cut the
divergent tail.  Transitions that would leave the bound are marked
*poison*; executing one on the device sets a poison bit in the row, and the
engine fails the run when it pops a poisoned row.

History (the linearizability tester) is factored into per-thread fields
updated arithmetically on the device, with the ``linearizable`` verdict
computed per row (:mod:`.history_tensor`): by the closure verdict for
``put_count=1`` registers, by a sorted-table lookup for write-once and
``put_count >= 2`` workloads.  The two standard
register-workload properties are recognized by name: ``linearizable``
(ALWAYS, history verdict) and ``value chosen`` (SOMETIMES, a non-null
``get_ok`` in flight — reference ``examples/paxos.rs:255-262``).

**Device gathers stay in range.**  JAX clamps an out-of-range gather
index; PyTorch raises on the CPU and asserts on the card.  Every table
gather here indexes with a value put in range first: an envelope code is
clamped to the universe (a free slot reads code 0, or its channel's first
code in the per-channel layout), an actor-state field to its state count.
Those lanes are masked afterwards, exactly where the JAX step masks its
clamped ones, so every valid successor is the same.
"""

from __future__ import annotations

import os
from collections import deque
from typing import Callable, Optional

import numpy as np
import torch

from ..actor import CancelTimer, Id, Out, Send, SetTimer
from ..actor.device_props import FactoredPredicate
from ..actor.model import ActorModel, ActorModelState, _default_boundary
from ..actor.network import (
    Envelope,
    OrderedNetwork,
    UnorderedDuplicatingNetwork,
    UnorderedNonDuplicatingNetwork,
)
from ..actor.register import (
    NULL_VALUE,
    RegisterClient,
    record_invocations,
    record_returns,
)
from ..actor.write_once_register import record_returns as wo_record_returns
from ..fingerprint import MASK64, stable_hash
from ..ops.hashing import SIGN, lshr, row_hash
from ..semantics import LinearizabilityTester
from .actor_tensor import (
    _EMPTY,
    COUNT_BITS,
    COUNT_MASK,
    SLOT_EMPTY,
    SlotCodec,
    region_send_ordered,
    slot_canonicalize,
    slot_send,
    slot_send_ordered,
)
from .history_tensor import (
    PHASE_DONE,
    PHASE_R_INFLIGHT,
    PHASE_W_INFLIGHT,
    LinHistoryCodec,
    MultiOpLinHistoryCodec,
)
from .tensor_model import BitPacker, FieldWriter, TensorModel

#: envelope-kind codes for the history/property tables
_K_OTHER, _K_PUT_OK, _K_GET_OK, _K_PUT_FAIL = 0, 1, 2, 3
#: default closure caps: past these the model needs a tighter
#: state_bound/env_bound (``compile_actor_model``'s arguments)
MAX_STATES_PER_ACTOR = 200_000
MAX_ENVELOPES = 100_000
#: handler calls between two checks of the closure's fail-fast estimate
_CHECK_EVERY = 2048


class CompileError(Exception):
    """The model is outside the compilable fragment."""


def _orl_hint(state) -> str:
    """The cap-error hint for OrderedReliableLink wrapper states: name the
    actually-unbounded fields instead of leaving the user to diff 200k
    closure states (the ORL sequencers grow forever unless capped).
    Shared by the exact-cap error and the pre-closure estimate's fail-fast
    error (JAX ``parallel/actor_compiler.py:91-107``)."""
    from ..actor.ordered_reliable_link import LinkState

    if not isinstance(state, LinkState):
        return ""
    return (
        "; this is an OrderedReliableLink wrapper state — "
        "next_send_seq/msgs_pending_ack/last_delivered_seqs "
        "grow without bound when the wrapped actor keeps "
        "sending; cap them with state_bound (worked recipe: "
        "docs/compiling-actor-systems.md, 'Compiling "
        "ORL-wrapped systems')"
    )


def compile_actor_model(
    model: ActorModel,
    *,
    state_bound: Optional[Callable] = None,
    env_bound: Optional[Callable] = None,
    n_slots: Optional[int] = None,
    max_states_per_actor: int = MAX_STATES_PER_ACTOR,
    max_envelopes: int = MAX_ENVELOPES,
    max_history_states: int = 2_000_000,
    per_channel: Optional[bool] = None,
    per_channel_depth: Optional[int] = None,
) -> "CompiledActorTensor":
    """Compile ``model`` to a :class:`TensorModel`; raises
    :class:`CompileError` when the model is outside the supported fragment.

    ``state_bound(actor_index, state) -> bool`` /
    ``env_bound(envelope) -> bool`` cut the closure's over-approximation for
    protocols with context-dependent domains; transitions crossing the bound
    poison the row on the device rather than silently diverging.
    ``max_states_per_actor``/``max_envelopes`` cap the closure (a closure
    on course to pass the state cap fails fast, with an estimate; escape
    hatch ``STATERIGHT_TPU_CLOSURE_ESTIMATE=off``).  ``max_history_states``
    caps the register history codec's joint tester enumeration (JAX
    ``stateright_tpu/parallel/actor_compiler.py:243``, :255).

    ``n_slots`` sets the slot-multiset width (default ``max(16, 4 *
    actors)``; JAX :292); the per-channel packing refuses it with a
    :class:`CompileError` (JAX :271-277), since it sizes each region from
    its channel's envelope universe.

    ``per_channel`` selects the network packing (None: the model's
    ``per_channel_resolved()``): False = the global sorted-slot multiset;
    True = one slot region per directed ``(src, dst)`` channel, sized to
    that channel's envelope universe.  ``per_channel_depth`` raises each
    ORDERED channel's region capacity to at least this many slots: an
    ordered flow can hold the same message at several ranks, which needs
    more slots than the channel's distinct-code count.  The default poisons
    loudly when exceeded; unordered regions ignore the knob.
    """
    return CompiledActorTensor(
        model,
        state_bound=state_bound,
        env_bound=env_bound,
        n_slots=n_slots,
        max_states_per_actor=max_states_per_actor,
        max_envelopes=max_envelopes,
        max_history_states=max_history_states,
        per_channel=per_channel,
        per_channel_depth=per_channel_depth,
    )


class CompiledActorTensor(TensorModel):
    """Table-driven device twin of a bounded ``ActorModel``."""

    def __init__(self, model: ActorModel, *, state_bound, env_bound,
                 max_states_per_actor: int, max_envelopes: int,
                 per_channel: Optional[bool],
                 per_channel_depth: Optional[int],
                 n_slots: Optional[int] = None,
                 max_history_states: int = 2_000_000):
        self.model = model
        if per_channel is None:
            per_channel = model.per_channel_resolved()
        self.per_channel = bool(per_channel)
        self._per_channel_depth = per_channel_depth
        #: which row layout packs the network
        self.network_encoding = (
            "per-channel" if self.per_channel else "slot-multiset"
        )
        self._check_fragment()
        # multi-op register workload (put_count >= 2): per-thread op-index
        # history fields and the MultiOpLinHistoryCodec table strategy
        self._multi = not self.general and self._put_count > 1
        # whether the caller declared a bound: the preflight audit
        # downgrades a growing-domain finding (AH205) that one already cuts
        self._has_state_bound = state_bound is not None
        self._state_bound = state_bound or (lambda i, s: True)
        self._env_bound = env_bound or (lambda e: True)
        self._caps = (max_states_per_actor, max_envelopes)

        self.n_actors = len(model.actors)
        if self.general:
            self.clients = []
            self.C = 0
            self.hist = None
        else:
            self.clients = [
                i
                for i, a in enumerate(model.actors)
                if isinstance(a, RegisterClient)
            ]
            self.C = len(self.clients)

            def tester_factory():
                return type(model.init_history)(
                    model.init_history.init_ref_obj
                )

            if self._put_count > 1:
                # per-client write scripts, from the value scheme the real
                # workload uses (RegisterClient.put_value)
                scripts = [
                    [
                        RegisterClient.put_value(
                            int(t), model.actors[t].server_count, k
                        )
                        for k in range(self._put_count)
                    ]
                    for t in self.clients
                ]
                self.hist = MultiOpLinHistoryCodec(
                    self.clients,
                    scripts,
                    NULL_VALUE,
                    tester_factory=tester_factory,
                    max_states=max_history_states,
                )
            else:
                values = [
                    RegisterClient.put_value(
                        int(t), model.actors[t].server_count, 0
                    )
                    for t in self.clients
                ]
                self.hist = LinHistoryCodec(
                    self.clients,
                    values,
                    # the write-once spec models the unset register as
                    # None; the wire protocol's null stays NULL_VALUE
                    # (translated at the get_ok boundary, as the
                    # write-once record_returns does)
                    None if self._wo else NULL_VALUE,
                    tester_factory=tester_factory,
                    max_states=max_history_states,
                    write_rets=(("write_ok",), ("write_fail",))
                    if self._wo
                    else (("write_ok",),),
                )

        self._closure()
        self._tabulate_properties()
        self._tabulate_boundary()
        # the symmetry tables are built lazily (see __getattr__): an
        # n!-sized tabulation costs nothing on runs without .symmetry()
        self._sym_tables = None
        self._sym_attempted = False
        self._sym_dev: dict = {}

        if self.per_channel:
            if n_slots is not None:
                raise CompileError(
                    "n_slots is a slot-multiset knob; the per-channel "
                    "layout derives each region's capacity from its "
                    "channel's envelope universe"
                )
            self._build_channel_layout()
            self.n_slots = int(sum(self._ch_cap))
            deliver = sum(
                self._ch_cap[ci]
                for ci, (_s, d) in enumerate(self._channels)
                if d < self.n_actors
            )
            self.max_actions = max(
                deliver
                + (self.n_slots if model.lossy else 0)
                + (self.n_actors if self._has_timers else 0),
                1,  # a message-less, timer-less system still needs a
                #     (never-valid) action column for the engine shapes
            )
        else:
            self.n_slots = n_slots if n_slots is not None else max(
                16, 4 * self.n_actors
            )
            self.max_actions = self.n_slots * (2 if model.lossy else 1) + (
                self.n_actors if self._has_timers else 0
            )
        fields = []
        for i in range(self.n_actors):
            bits = max(1, int(np.ceil(np.log2(max(2, len(self._states[i]))))))
            fields.append((f"a{i}", bits))
        for c in range(self.C):
            if self._multi:
                fields.append((f"h{c}_phase", self.hist.phase_bits))
                for m in range(self.hist.K):
                    fields.append((f"h{c}_snap{m}", self.hist.snap_bits))
                fields.append((f"h{c}_rval", self.hist.rval_bits))
            else:
                fields += [
                    (f"h{c}_phase", 2),
                    (f"h{c}_snap", max(1, 2 * (self.C - 1))),
                    (f"h{c}_rval", 3),
                ]
                if self.hist.wfail_bits:
                    fields.append((f"h{c}_wfail", 1))
        if self._has_timers:
            fields.append(("timers", self.n_actors))
        fields.append(("poison", 1))
        self.pk = BitPacker(fields)
        self.pw = self.pk.width
        self.width = self.pw + self.n_slots
        self.codec = SlotCodec(
            self.n_slots,
            lambda env: self._env_code[env],
            lambda code: self._envs[code],
        )
        self._device_consts: dict = {}

    # -- fragment check ------------------------------------------------------

    def _check_fragment(self) -> None:
        m = self.model
        if not isinstance(
            m.init_network,
            (
                UnorderedNonDuplicatingNetwork,
                UnorderedDuplicatingNetwork,
                OrderedNetwork,
            ),
        ):
            raise CompileError(
                "unsupported network semantics: "
                + type(m.init_network).__name__
            )
        self.dup = isinstance(m.init_network, UnorderedDuplicatingNetwork)
        self.ordered = isinstance(m.init_network, OrderedNetwork)

        self._boundary = None
        if m._within_boundary is not _default_boundary:
            # a FACTORED boundary compiles (tabulated like the properties;
            # successors crossing it are masked invalid, mirroring the host
            # checkers' within_boundary filter); arbitrary closures do not
            if isinstance(m._within_boundary, FactoredPredicate) and (
                m._within_boundary.kind in ("forall", "exists")
            ):
                self._boundary = m._within_boundary
            else:
                raise CompileError(
                    "within_boundary must be a factored per-actor predicate "
                    "(forall_actors/exists_actor) to compile"
                )
        if m.init_history is None:
            # GENERAL fragment: no auxiliary history; every property must be
            # a factored predicate the compiler can tabulate over the
            # per-actor state universes (``actor/device_props.py``)
            self.general = True
            self._wo = False
            self._put_count = 0
            bad = sorted(
                p.name
                for p in m.properties()
                if not isinstance(p.condition, FactoredPredicate)
            )
            if bad:
                raise CompileError(
                    "history-free models need factored properties "
                    "(forall_actors/exists_actor/forall_actor_pairs/"
                    f"exists_actor_pair); non-factored: {bad}"
                )
            return
        self.general = False
        if not isinstance(m.init_history, LinearizabilityTester):
            raise CompileError(
                "history must be a LinearizabilityTester (register "
                "workload), or None for the general fragment"
            )
        std = {"linearizable", "value chosen"}
        extra_bad = sorted(
            p.name
            for p in m.properties()
            if p.name not in std
            and not isinstance(p.condition, FactoredPredicate)
        )
        names = sorted(p.name for p in m.properties() if p.name in std)
        if names != ["linearizable", "value chosen"] or extra_bad:
            raise CompileError(
                "register workloads compile {'linearizable', 'value "
                "chosen'} plus any number of factored predicates "
                "(actor/device_props.py); got standard="
                + repr(names)
                + " non-factored extras="
                + repr(extra_bad)
            )
        if m._record_msg_in is record_returns:
            self._wo = False
        elif m._record_msg_in is wo_record_returns:
            # write-once workload: put_fail completes the write with
            # ("write_fail",) and a null read maps to the spec's None
            self._wo = True
        else:
            # the device history update hard-codes these recorders'
            # semantics (put_ok/put_fail/get_ok -> returns, put/get sends ->
            # invocations)
            raise CompileError(
                "history recorders must be the standard register (or "
                "write-once register) record_returns/record_invocations"
            )
        if m._record_msg_out is not record_invocations:
            raise CompileError(
                "history recorders must be the standard register "
                "record_returns/record_invocations"
            )
        clients = [a for a in m.actors if isinstance(a, RegisterClient)]
        if not clients or any(c.put_count < 1 for c in clients):
            raise CompileError(
                "workload must be RegisterClient actors with put_count >= 1"
            )
        put_counts = {c.put_count for c in clients}
        if len(put_counts) != 1:
            raise CompileError(
                f"per-client put_counts must be uniform (got {sorted(put_counts)})"
            )
        self._put_count = put_counts.pop()
        if self._wo and self._put_count != 1:
            raise CompileError(
                "write-once workloads compile with put_count=1 only (a "
                "failed write changes which op takes effect; the multi-op "
                "codec models write_ok returns)"
            )
        if any(
            isinstance(a, RegisterClient)
            != (i >= len(m.actors) - len(clients))
            for i, a in enumerate(m.actors)
        ):
            raise CompileError("clients must follow servers in the actor list")

    # -- closure -------------------------------------------------------------

    def _closure(self) -> None:
        """Co-enumerate per-actor state universes, the envelope universe, and
        the transition tables by running the real handlers host-side.  The
        order is the JAX compiler's (BFS over one deque, insertion-ordered
        dicts), so state and envelope codes are the same."""
        m = self.model
        n = self.n_actors
        max_s, max_e = self._caps

        self._states: list[list] = [[] for _ in range(n)]  # code -> state
        self._state_code: list[dict] = [{} for _ in range(n)]
        self._envs: list[Envelope] = []  # code -> envelope
        self._env_code: dict[Envelope, int] = {}
        # (i, s_code, e_code) -> (new_s_code | -1, sends, poison, timer_eff)
        # timer_eff: -1 keep, 0 clear, 1 set (last timer command wins,
        # mirroring sequential _process_commands)
        trans: dict[tuple, tuple] = {}
        # (i, s_code) -> (new_s_code, sends, poison, timer_bit) — the
        # Timeout action: the reference clears the flag, then commands may
        # re-set it (``model.rs:288-306``); never pruned
        ttrans: dict[tuple, tuple] = {}
        work: deque = deque()  # ("s", i, s_code) | ("e", e_code)

        def add_state(i: int, s) -> tuple[int, bool]:
            code = self._state_code[i].get(s)
            if code is not None:
                return code, True
            if not self._state_bound(i, s):
                return -1, False
            code = len(self._states[i])
            if code >= max_s:
                raise CompileError(
                    f"actor {i} state universe exceeded {max_s}; "
                    "tighten state_bound" + _orl_hint(s)
                )
            self._states[i].append(s)
            self._state_code[i][s] = code
            work.append(("s", i, code))
            return code, True

        def add_env(env: Envelope) -> tuple[int, bool]:
            code = self._env_code.get(env)
            if code is not None:
                return code, True
            if not self._env_bound(env):
                return -1, False
            code = len(self._envs)
            if code >= max_e:
                raise CompileError(
                    f"envelope universe exceeded {max_e}; tighten env_bound"
                )
            self._envs.append(env)
            self._env_code[env] = code
            work.append(("e", code))
            return code, True

        # -- fail-fast cap estimate ------------------------------------------
        # The eager closure can run minutes of handler calls before an
        # actor's universe hits max_s.  Every _CHECK_EVERY handler calls,
        # once the largest universe holds an eighth of the cap, the recent
        # states-per-call rate is extrapolated over the deliveries already
        # queued; when that estimate passes twice the cap at two
        # consecutive checkpoints with a rate that has not halved, the cap
        # error is raised at once.  A converging closure's rate decays as
        # its universe fills, so it never trips.  Escape hatch:
        # STATERIGHT_TPU_CLOSURE_ESTIMATE=off (``debug`` prints each check).
        est_env = os.environ.get(
            "STATERIGHT_TPU_CLOSURE_ESTIMATE", ""
        ).lower()
        est_on = est_env not in ("off", "0")
        est_debug = est_env == "debug"
        calls = 0
        next_check = _CHECK_EVERY
        # (calls, states) at the previous checkpoint; previous window rate;
        # consecutive over-bar checkpoints
        last_state = [0, 0, 0.0, 0]

        def _estimate_check() -> None:
            sizes = [len(s) for s in self._states]
            big = max(range(n), key=lambda i: sizes[i])
            d_calls = calls - last_state[0]
            d_states = sizes[big] - last_state[1]
            prev_rate = last_state[2]
            rate = d_states / max(d_calls, 1)
            last_state[0], last_state[1] = calls, sizes[big]
            last_state[2] = rate
            if sizes[big] * 8 < max_s:
                last_state[3] = 0
                return
            pending = 0
            env_by_dst = [0] * n
            for env in self._envs:
                d = int(env.dst)
                if d < n:
                    env_by_dst[d] += 1
            for item in work:
                if item[0] == "s":
                    pending += env_by_dst[item[1]]
                else:
                    d = int(self._envs[item[1]].dst)
                    if d < n:
                        pending += sizes[d]
            estimate = sizes[big] + int(rate * pending)
            decaying = prev_rate > 0 and rate < 0.5 * prev_rate
            if est_debug:
                print(
                    f"closure-estimate: states={sizes[big]} calls={calls} "
                    f"rate={rate:.3f} pending={pending} "
                    f"estimate={estimate} decaying={decaying} "
                    f"streak={last_state[3]}"
                )
            if estimate > 2 * max_s and not decaying:
                last_state[3] += 1
            else:
                last_state[3] = 0
            if last_state[3] >= 2:
                raise CompileError(
                    f"actor {big} state universe is on course to exceed "
                    f"the {max_s}-state cap: {sizes[big]} states after "
                    f"{calls} handler calls with {pending} deliveries "
                    f"already queued, production rate undiminished "
                    f"(pre-closure estimate ≥ {estimate}); "
                    "tighten state_bound, or raise max_states_per_actor "
                    "(escape hatch: STATERIGHT_TPU_CLOSURE_ESTIMATE=off)"
                    + _orl_hint(self._states[big][-1])
                )

        # seed from the real initial system state
        (init,) = m.init_states()
        self._init_state = init
        for i, s in enumerate(init.actor_states):
            code, ok = add_state(i, s)
            if not ok:
                raise CompileError(f"init state of actor {i} violates bound")
        for env in init.network.iter_deliverable():
            _, ok = add_env(env)
            if not ok:
                raise CompileError(f"init envelope {env!r} violates bound")

        def process(i: int, s_code: int, e_code: int) -> None:
            if (i, s_code, e_code) in trans:
                # every pair is queued from both sides; run the handler once
                return
            env = self._envs[e_code]
            s = self._states[i][s_code]
            out = Out()
            try:
                ret = m.actors[i].on_msg(Id(i), s, env.src, env.msg, out)
            except CompileError:
                raise
            except Exception:
                # The closure pairs every known state with every known
                # envelope; protocol invariants can make some pairs
                # impossible, and handlers may crash on them.  Poison: a
                # device run that ever takes it fails loudly.
                trans[(i, s_code, e_code)] = (s_code, (), True, -1)
                return
            if ret is None and not out.commands:
                trans[(i, s_code, e_code)] = (-1, (), False, -1)
                return
            new_s = s if ret is None else ret
            poison = False
            new_code, ok = add_state(i, new_s)
            if not ok:
                # bound-crossing successor: a VALID poisoned self-loop, so a
                # too-tight state_bound fails the run instead of silently
                # pruning a reachable transition
                new_code, poison = s_code, True
            sends, teff, poison = self._effects(i, out, add_env, poison)
            trans[(i, s_code, e_code)] = (new_code, sends, poison, teff)

        def process_timeout(i: int, s_code: int) -> None:
            if (i, s_code) in ttrans:
                return
            s = self._states[i][s_code]
            out = Out()
            try:
                ret = m.actors[i].on_timeout(Id(i), s, out)
            except CompileError:
                raise
            except Exception:
                ttrans[(i, s_code)] = (s_code, (), True, 0)
                return
            new_s = s if ret is None else ret
            poison = False
            new_code, ok = add_state(i, new_s)
            if not ok:
                new_code, poison = s_code, True
            sends, teff, poison = self._effects(i, out, add_env, poison)
            # flag cleared first; only an explicit SetTimer re-arms
            ttrans[(i, s_code)] = (new_code, sends, poison, max(teff, 0))

        while work:
            item = work.popleft()
            if item[0] == "s":
                _, i, s_code = item
                process_timeout(i, s_code)
                calls += 1
                for e_code, env in enumerate(self._envs):
                    if int(env.dst) == i:
                        process(i, s_code, e_code)
                        calls += 1
            else:
                _, e_code = item
                i = int(self._envs[e_code].dst)
                if i < n:
                    for s_code in range(len(self._states[i])):
                        process(i, s_code, e_code)
                        calls += 1
            if est_on and calls >= next_check:
                next_check = calls + _CHECK_EVERY
                _estimate_check()

        # timers exist iff a timer can ever be SET: then (and only then)
        # the encoding carries timer bits and step_rows emits Timeout actions
        self._has_timers = any(init.is_timer_set) or any(
            t[3] == 1 for t in trans.values()
        ) or any(t[3] == 1 for t in ttrans.values())

        # -- freeze tables ---------------------------------------------------
        ne = len(self._envs)
        # a system may send no messages at all: a sentinel env column keeps
        # the gathers in range (no slot is ever occupied, so it is masked)
        nep = self._ne_padded = max(ne, 1)
        self.K = max(
            (len(snds) for (_, snds, _, _) in trans.values()), default=0
        )
        self.Kt = max(
            (len(snds) for (_, snds, _, _) in ttrans.values()), default=0
        )
        self._trans_np = []
        self._sends_np = []
        self._poison_np = []
        self._teff_np = []
        for i in range(n):
            ns = len(self._states[i])
            ti = np.full((ns, nep), -1, np.int32)
            pi = np.zeros((ns, nep), bool)
            ki = np.full((ns, nep, max(self.K, 1)), -1, np.int32)
            ei = np.full((ns, nep), -1, np.int32)
            for (ai, sc, ec), (nc, snds, poison, teff) in trans.items():
                if ai != i:
                    continue
                ti[sc, ec] = nc
                pi[sc, ec] = poison
                ei[sc, ec] = teff
                for k, s in enumerate(snds):
                    ki[sc, ec, k] = s
            self._trans_np.append(ti)
            self._sends_np.append(ki)
            self._poison_np.append(pi)
            self._teff_np.append(ei)
        # timeout tables: (i, s) -> successor code / sends / poison / new bit
        self._ttrans_np = []
        self._tsends_np = []
        self._tpoison_np = []
        self._tbit_np = []
        for i in range(n):
            ns = len(self._states[i])
            ti = np.arange(ns, dtype=np.int32)  # default: state unchanged
            pi = np.zeros(ns, bool)
            bi = np.zeros(ns, np.int32)
            ki = np.full((ns, max(self.Kt, 1)), -1, np.int32)
            for (ai, sc), (nc, snds, poison, tbit) in ttrans.items():
                if ai != i:
                    continue
                ti[sc] = nc
                pi[sc] = poison
                bi[sc] = tbit
                for k, s in enumerate(snds):
                    ki[sc, k] = s
            self._ttrans_np.append(ti)
            self._tsends_np.append(ki)
            self._tpoison_np.append(pi)
            self._tbit_np.append(bi)

        # per-envelope metadata (padded to the sentinel width)
        pad = [0] * (nep - ne)
        self._env_dst = np.asarray(
            [int(e.dst) for e in self._envs] + pad, np.int32
        )
        # directed flow id (ordered networks): the envelope code determines
        # (src, dst), so same code implies same flow
        self._env_pair = np.asarray(
            [int(e.src) * self.n_actors + int(e.dst) for e in self._envs]
            + pad,
            np.int32,
        )
        kinds = np.full(nep, _K_OTHER, np.int32)
        vals = np.zeros(nep, np.int32)
        chosen = np.zeros(nep, bool)
        if not self.general:  # register-workload history/property metadata
            for c, e in enumerate(self._envs):
                if e.msg[0] == "put_ok":
                    kinds[c] = _K_PUT_OK
                elif e.msg[0] == "put_fail":
                    kinds[c] = _K_PUT_FAIL
                elif e.msg[0] == "get_ok":
                    kinds[c] = _K_GET_OK
                    v = e.msg[2]
                    if self._wo and v == NULL_VALUE:
                        v = None
                    vals[c] = self.hist._value_code(v)
                    chosen[c] = e.msg[2] != NULL_VALUE
        self._env_kind = kinds
        self._env_val = vals
        self._env_chosen = chosen
        self._client_of = np.asarray(
            [
                self.clients.index(i) if i in self.clients else -1
                for i in range(n)
            ],
            np.int32,
        )

    def _effects(self, i: int, out: Out, add_env, poison: bool):
        """Fold a handler's command list into (send codes, timer effect,
        poison).  Timer commands apply sequentially — the last one wins —
        mirroring ``_process_commands``; ``-1`` means no timer command."""
        sends = []
        teff = -1
        for c in out.commands:
            if isinstance(c, SetTimer):
                teff = 1
            elif isinstance(c, CancelTimer):
                teff = 0
            else:
                assert isinstance(c, Send)
                snd = Envelope(src=Id(i), dst=c.dst, msg=c.msg)
                if (
                    not self.general
                    and snd.msg[0] == "put"
                    and self._put_count == 1
                ):
                    # put_count=1 histories invoke every write at start; a
                    # mid-run put means the workload isn't the declared
                    # script (multi-op workloads send their later puts
                    # mid-run by design: the multi-op codec's phase indices
                    # model exactly that)
                    raise CompileError(
                        "a client declaring put_count=1 sent a put mid-run: "
                        "its sends do not match the declared one-write "
                        "script (custom client? declare the real put_count)"
                    )
                sc, ok = add_env(snd)
                poison |= not ok
                sends.append(sc)
        return tuple(sends), teff, poison

    # -- per-channel layout --------------------------------------------------

    def _build_channel_layout(self) -> None:
        """Freeze the per-(src, dst)-channel row layout: one slot region per
        directed channel of the envelope universe, capacity = that
        channel's distinct-code count (so the unordered semantics can never
        overflow a region), plus the static per-channel metadata the
        channel step keys its Python-level structure on: which channels
        can poison, which carry register-workload return kinds to a client,
        which touch the recipient's timer, and the per-send-slot target
        channel sets."""
        chans: dict = {}
        for c, e in enumerate(self._envs):
            chans.setdefault(e.channel, []).append(c)
        self._channels = sorted(chans)
        self._ch_codes = [
            np.asarray(chans[k], np.int32) for k in self._channels
        ]
        if self.ordered and self._per_channel_depth:
            # ordered flows hold duplicates at distinct ranks, so a flow
            # can outgrow its code universe; the knob buys headroom,
            # bounded by the rank field's width
            self._ch_cap = [
                min(
                    max(len(chans[k]), int(self._per_channel_depth)),
                    COUNT_MASK,
                )
                for k in self._channels
            ]
        else:
            self._ch_cap = [len(chans[k]) for k in self._channels]
        self._ch_base = []
        base = 0
        for cap in self._ch_cap:
            self._ch_base.append(base)
            base += cap
        self._chan_of = np.full(self._ne_padded, -1, np.int32)
        for ci, codes in enumerate(self._ch_codes):
            self._chan_of[codes] = ci
        n = self.n_actors
        self._ch_poison_any = []
        self._ch_ret_kind = []
        self._ch_timer = []
        self._ch_targets = []  # per channel: per send slot k, sorted cis
        for ci, (_s, d) in enumerate(self._channels):
            codes = self._ch_codes[ci]
            if d >= n:  # undeliverable destination: no deliver action
                self._ch_poison_any.append(False)
                self._ch_ret_kind.append(False)
                self._ch_timer.append(False)
                self._ch_targets.append([])
                continue
            self._ch_poison_any.append(
                bool(self._poison_np[d][:, codes].any())
            )
            # history updates apply only when the DESTINATION is a client
            # (the multiset step's `ci >= 0` guard): a ret-kind envelope
            # relayed to a server must not touch the history fields
            self._ch_ret_kind.append(
                bool((self._env_kind[codes] != _K_OTHER).any())
                and int(self._client_of[d]) >= 0
            )
            self._ch_timer.append(
                bool((self._teff_np[d][:, codes] != -1).any())
            )
            ks = self._sends_np[d][:, codes, :]
            self._ch_targets.append([
                sorted({
                    int(self._chan_of[c])
                    for c in np.unique(ks[..., k][ks[..., k] >= 0])
                })
                for k in range(max(self.K, 1))
            ])
        if self._has_timers:
            self._t_targets = [
                [
                    sorted({
                        int(self._chan_of[c])
                        for c in np.unique(
                            self._tsends_np[i][:, k][
                                self._tsends_np[i][:, k] >= 0
                            ]
                        )
                    })
                    for k in range(max(self.Kt, 1))
                ]
                for i in range(n)
            ]
        #: channels whose codes include a chosen-capable (non-null get_ok)
        #: envelope: the only regions the per-channel "value chosen"
        #: property reads
        self._chosen_channels = [
            ci
            for ci, codes in enumerate(self._ch_codes)
            if bool(self._env_chosen[codes].any())
        ]

    def _pack_network(self, pairs) -> tuple:
        """``[(envelope, count_or_rank), ...] -> slot words`` under the
        active layout (the per-channel analogue of ``SlotCodec.pack``:
        sorted per region, EMPTY-padded to each region's capacity)."""
        if not self.per_channel:
            return self.codec.pack(pairs)
        per: list = [[] for _ in self._channels]
        for env, count in pairs:
            if not 1 <= count <= COUNT_MASK:
                raise ValueError(f"count {count} out of range for {env!r}")
            code = self._env_code[env]  # KeyError = outside the universe
            per[int(self._chan_of[code])].append(
                (code << COUNT_BITS) | count
            )
        words: list = []
        for ci, lst in enumerate(per):
            cap = self._ch_cap[ci]
            if len(lst) > cap:
                raise ValueError(
                    f"channel {self._channels[ci]} holds {len(lst)} "
                    f"envelopes, exceeding its region capacity {cap}"
                )
            lst.sort()
            words += lst + [SLOT_EMPTY] * (cap - len(lst))
        return tuple(words)

    def _unpack_network(self, slot_words) -> list:
        """``slot words -> [(envelope, count_or_rank), ...]`` under the
        active layout; words may be int64 bit patterns."""
        if not self.per_channel:
            return self.codec.unpack(slot_words)
        out = []
        for w in slot_words:
            w = int(w) & MASK64
            if w == SLOT_EMPTY:
                continue
            out.append((self._envs[w >> COUNT_BITS], w & COUNT_MASK))
        return out

    def _tabulate_properties(self) -> None:
        """Freeze each factored property's predicate into per-actor (or
        per-pair) boolean tables over the compiled state universes.  The
        host evaluates the same predicate directly, so agreement is by
        construction.  ``None`` marks the two standard history-driven
        properties, which ``property_masks`` computes from the history
        fields."""
        self._prop_tables = []
        n = self.n_actors
        for p in self.model.properties():
            f = p.condition
            if not isinstance(f, FactoredPredicate):
                self._prop_tables.append(None)  # standard register property
                continue
            try:
                if f.kind in ("forall", "exists"):
                    tables = [
                        np.asarray(
                            [bool(f.pred(i, s)) for s in self._states[i]],
                            bool,
                        )
                        for i in range(n)
                    ]
                else:
                    tables = {
                        (i, j): np.asarray(
                            [
                                [
                                    bool(f.pred(i, si, j, sj))
                                    for sj in self._states[j]
                                ]
                                for si in self._states[i]
                            ],
                            bool,
                        )
                        for i in range(n)
                        for j in range(i + 1, n)
                    }
            except Exception as e:
                raise CompileError(
                    f"property {p.name!r}: predicate failed on an enumerated "
                    f"state ({type(e).__name__}: {e}); factored predicates "
                    "must be total over each actor's reachable states"
                ) from e
            self._prop_tables.append((f.kind, tables))

    def _tabulate_boundary(self) -> None:
        """Freeze a factored ``within_boundary`` into per-actor tables; the
        engine's successor mask then mirrors the host checkers' boundary
        filter exactly."""
        if self._boundary is None:
            self._boundary_np = None
            return
        f = self._boundary
        try:
            self._boundary_np = [
                np.asarray(
                    [bool(f.pred(i, s)) for s in self._states[i]], bool
                )
                for i in range(self.n_actors)
            ]
        except Exception as e:
            raise CompileError(
                f"within_boundary predicate failed on an enumerated state "
                f"({type(e).__name__}: {e})"
            ) from e
        if not f(self.model, self._init_state):
            raise CompileError(
                "the initial state is outside within_boundary: the host "
                "checkers would explore nothing; fix the boundary"
            )

    # -- mechanical device symmetry (general fragment) -----------------------

    _SYM_MAX_PERMS = 720  # n! cap: the tables are [n!, |universe|]

    def __getattr__(self, name):
        # ``representative_rows``/``representative_key`` appear on demand:
        # the engine probes them with hasattr only when .symmetry() was
        # asked for, which is when the permutation tables are first built.
        # (``__getattr__`` runs only after normal lookup fails, so once
        # built the instance attributes take over.)
        if name in ("representative_rows", "representative_key"):
            d = self.__dict__
            if (
                not d.get("_sym_attempted", True)
                and d.get("_sym_tables") is None
                and d.get("general")
            ):
                self._sym_attempted = True
                self._try_build_symmetry()
            if name in self.__dict__:
                return self.__dict__[name]
        raise AttributeError(name)

    def _try_build_symmetry(self) -> None:
        """Mechanical symmetry reduction for compiled models whose actors
        share ONE state universe (fully interchangeable actors, e.g. Raft
        servers), as ``_try_build_symmetry`` of the JAX compiler.  It
        mirrors the host ``ActorModelState.representative``: the
        permutation is the stable sort of the actors' state
        ``stable_hash`` keys, and states and envelopes are rewritten
        through the real ``rewrite_value``, tabulated per permutation, so
        the device canonicalizes a whole batch with gathers.  The
        canonical output is a *virtual* row (universe codes, the permuted
        timer word, the remapped slots), only ever hashed; rewritten values
        outside the reachable universe are interned for coding.  On success
        the instance gains ``representative_rows`` (device) and
        ``representative_key`` (host)."""
        import math
        from itertools import permutations

        from ..symmetry import RewritePlan, rewrite_value

        n = self.n_actors
        if n < 2 or math.factorial(n) > self._SYM_MAX_PERMS:
            return
        # the UNION of the per-actor universes: symmetric systems reach
        # per-actor value sets that are permuted images of each other, so
        # canonical codes live in the union (virtual rows are never
        # decoded, only hashed)
        universe: list = []
        ucode: dict = {}

        def intern(v) -> int:
            c = ucode.get(v)
            if c is None:
                c = len(universe)
                universe.append(v)
                ucode[v] = c
            return c

        for i in range(n):
            for s in self._states[i]:
                intern(s)
        real_u = len(universe)

        umaps = [
            np.asarray([ucode[s] for s in self._states[i]], np.int64)
            for i in range(n)
        ]
        perms = list(permutations(range(n)))  # lexicographic mapping order
        rw = np.zeros((len(perms), real_u), np.int64)
        # the transition tables' padded envelope width, so the symmetry
        # gathers cannot desync from them
        ev = np.zeros((len(perms), self._ne_padded), np.int64)
        env_intern: dict = dict(self._env_code)

        def env_code_of(e: Envelope) -> int:
            c = env_intern.get(e)
            if c is None:
                c = len(env_intern)
                env_intern[e] = c
            return c

        try:
            for pi, mapping in enumerate(perms):
                plan = RewritePlan(list(mapping))
                for u in range(real_u):
                    rw[pi, u] = intern(rewrite_value(universe[u], plan))
                for ec, e in enumerate(self._envs):
                    ev[pi, ec] = env_code_of(
                        Envelope(
                            src=plan.rewrite_id(e.src),
                            dst=plan.rewrite_id(e.dst),
                            msg=rewrite_value(e.msg, plan),
                        )
                    )
        except Exception:
            return  # a state or message resists rewriting: no symmetry
        self._sym_tables = {
            "umaps": umaps,
            # uint64 stable hashes as int64 bit patterns
            "keys": np.asarray(
                [stable_hash(v) for v in universe[:real_u]], np.uint64
            ).view(np.int64),
            "rw": rw,
            "ev": ev,
            "fact": [math.factorial(n - 1 - k) for k in range(n)],
        }
        self.representative_rows = self._representative_rows_impl
        self.representative_key = self._representative_key_impl

    def _sym_consts(self, device) -> dict:
        """The symmetry tables as tensors on ``device``, built once per
        device (``rw`` and ``ev`` flattened, gathered at
        ``perm * width + code``)."""
        c = self._sym_dev.get(device)
        if c is None:
            t = self._sym_tables

            def dev(a):
                return torch.from_numpy(np.ascontiguousarray(a)).to(device)

            c = {
                "umaps": [dev(u) for u in t["umaps"]],
                "keys": dev(t["keys"]),
                "rw": dev(t["rw"].reshape(-1)),
                "ev": dev(t["ev"].reshape(-1)),
                "fact": dev(np.asarray(t["fact"], np.int64)),
                # [k, j]: j > k, the pairs of the mapping's inversion count
                "upper": torch.ones(
                    (self.n_actors, self.n_actors), dtype=torch.bool,
                    device=device,
                ).triu_(1),
            }
            self._sym_dev[device] = c
        return c

    def _representative_rows_impl(self, rows: torch.Tensor) -> torch.Tensor:
        """Canonical VIRTUAL rows, for hashing only: ``int64[..., n + 1 +
        NS]``, the universe codes of the plan-rewritten sorted actor
        states, the permuted timer word and the envelope-remapped sorted
        slots (the JAX ``_representative_rows_impl``).  Any leading shape
        (the engine passes ``[B, A, W]``).  Every gather index is put in
        range first (JAX clamps; PyTorch would raise), which changes
        nothing on a valid row; nothing is read on the host."""
        cst = self._sym_consts(rows.device)
        pk, n = self.pk, self.n_actors
        ar = torch.arange(n, dtype=torch.int64, device=rows.device)

        ucodes = torch.stack(
            [
                cst["umaps"][i][
                    pk.get(rows, f"a{i}").clamp(max=len(self._states[i]) - 1)
                ]
                for i in range(n)
            ],
            dim=-1,
        )  # [..., n]
        keys = cst["keys"][ucodes]
        # unsigned key order is the signed order of key ^ SIGN
        order = torch.argsort(keys ^ SIGN, dim=-1, stable=True)  # new -> old
        mapping = torch.argsort(order, dim=-1)  # old -> new (plan.mapping)
        # lexicographic rank of the mapping tuple = the table's permutation:
        # sum over k of fact[k] * #{j > k : mapping[j] < mapping[k]}
        inv = (mapping[..., None, :] < mapping[..., :, None]) & cst["upper"]
        perm_id = (inv.sum(-1) * cst["fact"]).sum(-1)  # [...]

        usorted = torch.gather(ucodes, -1, order)
        real_u = self._sym_tables["rw"].shape[1]
        codes2 = cst["rw"][perm_id[..., None] * real_u + usorted]  # [..., n]

        if self._has_timers:
            bits = (pk.get(rows, "timers")[..., None] >> ar) & 1
            tword = (torch.gather(bits, -1, order) << ar).sum(-1)
        else:
            tword = torch.zeros_like(perm_id)

        slots = rows[..., self.pw:]
        occ = slots != _EMPTY
        e = torch.where(occ, lshr(slots, COUNT_BITS), 0).clamp_(
            max=self._ne_padded - 1)
        cnt = slots & COUNT_MASK
        e2 = cst["ev"][perm_id[..., None] * self._ne_padded + e]
        slot2 = torch.where(occ, (e2 << COUNT_BITS) | cnt, _EMPTY)
        return torch.cat(
            [codes2, tword[..., None], slot_canonicalize(slot2)], dim=-1
        )

    def _representative_key_impl(self, state: ActorModelState) -> int:
        """Host-side symmetry key: the (unsigned) fingerprint the device
        stores for ``state``'s class, which trace reconstruction matches
        steps by."""
        row = np.asarray([self.encode_state(state)], np.uint64).view(np.int64)
        virt = self._representative_rows_impl(torch.from_numpy(row))
        return int(row_hash(virt)[0]) & MASK64

    # -- host bridge ---------------------------------------------------------

    def encode_state(self, st: ActorModelState) -> tuple:
        vals: dict[str, int] = {}
        for i, s in enumerate(st.actor_states):
            code = self._state_code[i].get(s)
            if code is None:
                raise RuntimeError(
                    f"actor {i} state {s!r} is outside the compiled universe "
                    "(state_bound too tight, or a closure gap)"
                )
            vals[f"a{i}"] = code
        if self._multi:
            for c, (phase, snaps, rval) in enumerate(
                self.hist.fields_of_tester(st.history)
            ):
                vals[f"h{c}_phase"] = phase
                for m in range(self.hist.K):
                    vals[f"h{c}_snap{m}"] = snaps[m]
                vals[f"h{c}_rval"] = rval
        elif not self.general:
            for c, (phase, snap, rval, wfail) in enumerate(
                self.hist.fields_of_tester(st.history)
            ):
                vals[f"h{c}_phase"] = phase
                vals[f"h{c}_snap"] = snap
                vals[f"h{c}_rval"] = rval
                if self.hist.wfail_bits:
                    vals[f"h{c}_wfail"] = wfail
        if self._has_timers:
            vals["timers"] = sum(
                1 << i for i, t in enumerate(st.is_timer_set) if t
            )
        vals["poison"] = 0
        if self.ordered:
            # slot "count" = 1-based rank within the directed flow (1 = head)
            pairs = (
                (Envelope(k[0], k[1], msg), pos + 1)
                for k, flow in st.network._flows.items()
                for pos, msg in enumerate(flow)
            )
        elif self.dup:
            pairs = ((env, 1) for env in st.network.iter_all())
        else:
            pairs = st.network._counts.items()
        return self.pk.pack(**vals) + self._pack_network(pairs)

    def decode_state(self, row) -> ActorModelState:
        d = self.pk.unpack(row[: self.pw])
        if d["poison"]:
            raise RuntimeError(
                "poisoned row: a transition crossed the compile-time bound "
                "(state_bound/env_bound too tight for this configuration)"
            )
        actors = tuple(
            self._states[i][d[f"a{i}"]] for i in range(self.n_actors)
        )
        if self.general:
            tester = None
        elif self._multi:
            tester = self.hist.tester_of_fields(
                [
                    (
                        d[f"h{c}_phase"],
                        tuple(d[f"h{c}_snap{m}"] for m in range(self.hist.K)),
                        d[f"h{c}_rval"],
                    )
                    for c in range(self.C)
                ]
            )
        else:
            tester = self.hist.tester_of_fields(
                [
                    (d[f"h{c}_phase"], d[f"h{c}_snap"], d[f"h{c}_rval"],
                     d.get(f"h{c}_wfail", 0))
                    for c in range(self.C)
                ]
            )
        timers = (
            tuple(
                bool((d["timers"] >> i) & 1) for i in range(self.n_actors)
            )
            if self._has_timers
            else (False,) * self.n_actors
        )
        pairs = self._unpack_network(row[self.pw :])
        if self.ordered:
            flows: dict = {}
            for env, rank1 in pairs:
                flows.setdefault((env.src, env.dst), []).append(
                    (rank1, env.msg)
                )
            network = OrderedNetwork(
                {
                    k: tuple(
                        msg for _, msg in sorted(v, key=lambda t: t[0])
                    )
                    for k, v in flows.items()
                }
            )
        elif self.dup:
            network = UnorderedDuplicatingNetwork(
                {env: None for env, _ in pairs}
            )
        else:
            network = UnorderedNonDuplicatingNetwork(dict(pairs))
        return ActorModelState(
            actor_states=actors,
            network=network,
            is_timer_set=timers,
            history=tester,
        )

    def init_rows(self) -> np.ndarray:
        return np.asarray([self.encode_state(self._init_state)], np.uint64)

    # -- device --------------------------------------------------------------

    def _consts(self, device) -> dict:
        """The tables as tensors on ``device``, built once per device (the
        transition tables flattened to ``[states * envelopes]``)."""
        c = self._device_consts.get(device)
        if c is not None:
            return c

        def t(a, dtype=torch.int64):
            return torch.from_numpy(np.ascontiguousarray(a)).to(
                device=device, dtype=dtype)

        kp = max(self.K, 1)
        c = {
            "trans": [t(x.reshape(-1)) for x in self._trans_np],
            "sends": [t(x.reshape(-1, kp)) for x in self._sends_np],
            "poison": [t(x.reshape(-1), torch.bool) for x in self._poison_np],
            "env_dst": t(self._env_dst),
            "env_pair": t(self._env_pair),
            "env_kind": t(self._env_kind),
            "env_val": t(self._env_val),
            "env_chosen": t(self._env_chosen, torch.bool),
            "client_of": t(self._client_of),
            "eye": torch.eye(self.n_slots, dtype=torch.bool, device=device),
        }
        if self._has_timers:
            c.update(
                teff=[t(x.reshape(-1)) for x in self._teff_np],
                ttrans=[t(x) for x in self._ttrans_np],
                tsends=[t(x) for x in self._tsends_np],
                tpoison=[t(x, torch.bool) for x in self._tpoison_np],
                tbit=[t(x) for x in self._tbit_np],
            )
        if self._boundary_np is not None:
            c["boundary"] = [t(x, torch.bool) for x in self._boundary_np]
        if self.per_channel:
            c["chan_of"] = t(self._chan_of)
        c["props"] = [
            None
            if entry is None
            else (
                entry[0],
                [t(x, torch.bool) for x in entry[1]]
                if isinstance(entry[1], list)
                else {k: t(v, torch.bool) for k, v in entry[1].items()},
            )
            for entry in self._prop_tables
        ]
        self._device_consts[device] = c
        return c

    def _codes(self, rows):
        """Each actor's state field ``[...]``, raw (written back unchanged)
        and clamped into its universe (a gather index)."""
        raw = [self.pk.get(rows, f"a{i}") for i in range(self.n_actors)]
        safe = [
            r.clamp(max=len(self._states[i]) - 1) for i, r in enumerate(raw)
        ]
        return raw, safe

    def _slot_codes(self, slots):
        """Occupied mask and envelope codes of slot words; a free slot (or a
        code outside the universe) reads code 0 / the last code."""
        occupied = slots != _EMPTY
        ecode = torch.where(occupied, lshr(slots, COUNT_BITS), 0)
        return occupied, ecode.clamp_(max=self._ne_padded - 1)

    def _send(self, slots, code, enable, cst):
        if self.ordered:
            return slot_send_ordered(slots, code, cst["env_pair"], enable)
        return slot_send(slots, code, enable, set_semantics=self.dup)

    def row_domain(self):
        """Declared value bounds for the static sanitizer
        (``analysis/sanitizer.py``; JAX ``actor_compiler.py:1421``).

        The compiled row's fields are bound by their UNIVERSES, not their
        bit widths: ``a{i}`` holds a state code ``< len(states[i])``, and
        each network slot word is either ``EMPTY`` or ``code << COUNT_BITS
        | count`` with ``code`` below the envelope count (per channel: the
        channel's own largest code).  That is what lets the interval pass
        prove every ``trans[sc * ne + ecode]`` table gather in range."""
        from .tensor_model import RowDomain

        bounds = {
            f"a{i}": max(0, len(self._states[i]) - 1)
            for i in range(self.n_actors)
        }
        dom = RowDomain.from_packer(self.pk, field_bounds=bounds,
                                    width=self.width)
        if self.per_channel:
            for ci, codes in enumerate(self._ch_codes):
                hi = (int(codes.max()) << COUNT_BITS) | COUNT_MASK
                base = self.pw + self._ch_base[ci]
                for w in range(base, base + self._ch_cap[ci]):
                    dom.declare_word(w, hi, may_empty=True)
            return dom
        max_code = max(0, len(self._envs) - 1)
        slot_hi = (max_code << COUNT_BITS) | COUNT_MASK
        for w in range(self.pw, self.width):
            dom.declare_word(w, slot_hi, may_empty=True)
        return dom

    def step_rows(self, rows: torch.Tensor):
        """``int64[B, W] -> (int64[B, A, W], bool[B, A])`` under the active
        network packing."""
        if self.per_channel:
            return self._step_rows_per_channel(rows)
        return self._step_rows_multiset(rows)

    def _step_rows_multiset(self, rows: torch.Tensor):
        """One deliver action per slot, then (lossy) one drop action per
        slot, then (with timers) one Timeout action per actor — the JAX
        compiler's ``_step_rows_multiset`` and ``_append_timeouts``."""
        cst = self._consts(rows.device)
        B = rows.shape[0]
        NS, pw = self.n_slots, self.pw
        ne = self._ne_padded
        pk = self.pk
        dev = rows.device
        raw, safe = self._codes(rows)

        slots = rows[:, pw:]  # [B, NS]
        occupied, ecode = self._slot_codes(slots)
        dst = cst["env_dst"][ecode]  # [B, NS]
        if self.ordered:
            # count bits hold the 1-based rank within the directed flow;
            # only the head (rank 1) of each flow is deliverable
            # (reference ``model.rs:224-227``)
            pair = torch.where(occupied, cst["env_pair"][ecode], -1)
            at_head = occupied & ((slots & COUNT_MASK) == 1)

        # -- deliver actions (slot a delivers the envelope in slot a) -------
        new_scode = torch.zeros((B, NS), dtype=torch.int64, device=dev)
        valid = torch.zeros((B, NS), dtype=torch.bool, device=dev)
        poison = torch.zeros((B, NS), dtype=torch.bool, device=dev)
        send_codes = torch.full((B, NS, max(self.K, 1)), -1,
                                dtype=torch.int64, device=dev)
        to_actor = []
        for i in range(self.n_actors):
            mask = occupied & (dst == i)
            to_actor.append(mask)
            flat = safe[i][:, None] * ne + ecode  # [B, NS], in range
            nc = cst["trans"][i][flat]
            new_scode = torch.where(mask, nc, new_scode)
            valid = valid | (mask & (nc >= 0))
            poison = poison | (mask & cst["poison"][i][flat])
            send_codes = torch.where(mask[..., None], cst["sends"][i][flat],
                                     send_codes)
        if self.ordered:
            valid = valid & at_head

        # -- successor slot arrays ------------------------------------------
        slots_b = slots[:, None, :].expand(B, NS, NS)
        diag = cst["eye"][None]
        if self.ordered:
            # delivering the head removes it and advances the rest of its
            # flow by one rank (empty flows vanish with their last slot)
            same_flow = (pair[:, :, None] >= 0) & (
                pair[:, :, None] == pair[:, None, :]
            )
            advanced = torch.where(same_flow, slots_b - 1, slots_b)
            slots_d = torch.where(diag, _EMPTY, advanced)
        else:
            if self.dup:
                # a duplicating network leaves the envelope in flight
                # (reference ``network.rs:203-205``); only drops remove it
                delivered = slots
            else:
                delivered = torch.where(
                    (slots & COUNT_MASK) <= 1, _EMPTY, slots - 1
                )
            slots_d = torch.where(diag, delivered[:, :, None], slots_b)
        for k in range(self.K):
            sk = send_codes[..., k]
            slots_d, of = self._send(slots_d, sk, valid & (sk >= 0), cst)
            poison = poison | of
        slots_d = slot_canonicalize(slots_d)

        # -- successor packed words -----------------------------------------
        # every value below reads from `rows`; the writes start from the
        # parent's packed words only (the slot words were built above)
        fw = FieldWriter(pk, rows[:, None, :pw].expand(B, NS, pw))
        taken = [valid & m for m in to_actor]
        for i in range(self.n_actors):
            fw.set(f"a{i}", torch.where(taken[i], new_scode, raw[i][:, None]))
        if self._has_timers:
            # a deliver's handler may set/cancel the recipient's timer
            tnew = pk.get(rows, "timers")[:, None].expand(B, NS)
            for i in range(self.n_actors):
                eff = cst["teff"][i][safe[i][:, None] * ne + ecode]
                tnew = torch.where(
                    taken[i] & (eff == 1),
                    tnew | (1 << i),
                    torch.where(taken[i] & (eff == 0), tnew & ~(1 << i), tnew),
                )
            fw.set("timers", tnew)

        # -- history updates -------------------------------------------------
        if self.C:
            kind = cst["env_kind"][ecode]  # [B, NS]
            ci = cst["client_of"][dst.clamp(0, self.n_actors - 1)]
            if self._multi:
                is_ret_w = valid & (kind == _K_PUT_OK) & (ci >= 0)
            else:
                is_ret_w = valid & ((kind == _K_PUT_OK)
                                    | (kind == _K_PUT_FAIL)) & (ci >= 0)
            is_ret_r = valid & (kind == _K_GET_OK) & (ci >= 0)
            rv = cst["env_val"][ecode]
            parents = self._history_parents(rows)
            for c in range(self.C):
                self._client_history(
                    fw, rows, parents, is_ret_w & (ci == c),
                    is_ret_r & (ci == c), kind, rv, c, (B, NS),
                )

        cur_poison = pk.get(rows, "poison")[:, None]
        fw.set("poison", torch.maximum(poison.to(torch.int64), cur_poison))
        succ = torch.cat([fw.done(), slots_d], dim=-1)

        if self.model.lossy:
            # -- drop actions: consume without delivering -------------------
            if self.ordered:
                # the object model enumerates Drop over the deliverable
                # envelopes only — flow heads — so an ordered drop's
                # network effect is the deliver effect
                slots_drop = torch.where(diag, _EMPTY, advanced)
            else:
                # a duplicating network's drop removes the envelope forever
                # (reference ``network.rs:242-244``); non-duplicating drops
                # one copy
                dropped = torch.full_like(slots, _EMPTY) if self.dup \
                    else delivered
                slots_drop = torch.where(diag, dropped[:, :, None], slots_b)
            drop_rows = torch.cat(
                [rows[:, None, :pw].expand(B, NS, pw),
                 slot_canonicalize(slots_drop)],
                dim=-1,
            )
            succ = torch.cat([succ, drop_rows], dim=1)
            droppable = at_head if self.ordered else occupied
            valid = torch.cat([valid, droppable], dim=1)
        if self._has_timers:
            succ_t, valid_t = self._timeouts(rows, slots, raw, safe, cst)
            succ = torch.cat([succ, succ_t], dim=1)
            valid = torch.cat([valid, valid_t], dim=1)
        return succ, valid

    def _history_parents(self, rows):
        """The parent rows' phase fields ``[B, C]`` and each thread's
        completed-op count derived from them (what a newly invoked op's
        snapshot records), computed once per step."""
        phases = torch.stack(
            [self.pk.get(rows, f"h{c}_phase") for c in range(self.C)], -1
        )
        if self._multi:
            comp = phases >> 1
        elif self.C > 1:
            comp = torch.where(
                phases == PHASE_W_INFLIGHT,
                0,
                torch.where(phases == PHASE_DONE, 2, 1),
            )
        else:
            comp = None
        return phases, comp

    def _client_history(self, fw, rows, parents, m_w, m_r, kind, rv, c,
                        shape):
        """Client ``c``'s history update where ``m_w`` (a write returned)
        or ``m_r`` (the read returned) holds, over one action block of
        ``shape``: the JAX compiler's history loops, shared by both
        packings.  ``parents`` is :meth:`_history_parents` of ``rows``;
        every current field value is the parent row's (the block's rows are
        copies of its parent's)."""
        pk = self.pk
        phases, comp = parents
        cur_ph = phases[:, c:c + 1]

        def cur(name):
            return pk.get(rows, f"h{c}_{name}")[:, None]

        def peer_snap(entry_bits):
            snap = torch.zeros(shape, dtype=torch.int64, device=rows.device)
            for j in range(self.C):
                if j != c:
                    slot = self.hist._snap_slot(c, j)
                    snap = snap | (comp[:, j:j + 1] << (entry_bits * slot))
            return snap

        if self._multi:
            # phase = 2*completed + in_flight: a put_ok return invokes the
            # next op in the same transition (+2); the read's return just
            # completes (+1).  The newly invoked op's snapshot (the peers'
            # completed counts) goes to the snap field of the op it
            # belongs to.
            fw.set(f"h{c}_phase", torch.where(
                m_w, cur_ph + 2, torch.where(m_r, cur_ph + 1, cur_ph)))
            snap = peer_snap(self.hist.snap_entry_bits)
            cur_comp = comp[:, c:c + 1]
            for m in range(self.hist.K):
                fw.set(f"h{c}_snap{m}", torch.where(
                    m_w & (cur_comp == m), snap, cur(f"snap{m}")))
            fw.set(f"h{c}_rval", torch.where(m_r, rv, cur("rval")))
            return
        fw.set(f"h{c}_phase", torch.where(
            m_w, PHASE_R_INFLIGHT, torch.where(m_r, PHASE_DONE, cur_ph)))
        if self.C > 1:
            # read-invocation snapshot: other threads' completed counts
            fw.set(f"h{c}_snap", torch.where(m_w, peer_snap(2), cur("snap")))
        fw.set(f"h{c}_rval", torch.where(m_r, rv, cur("rval")))
        if self.hist.wfail_bits:
            fw.set(f"h{c}_wfail", torch.where(
                m_w & (kind == _K_PUT_FAIL), 1, cur("wfail")))

    def _timeouts(self, rows, slots, raw, safe, cst):
        """One Timeout action column per actor (reference
        ``model.rs:234-238,288-306``): valid iff the actor's timer bit is
        set; the tabulated ``on_timeout`` effect updates the actor state,
        appends its sends, and rewrites the timer bit (cleared unless the
        handler re-armed it)."""
        pk = self.pk
        B = rows.shape[0]
        n, pw = self.n_actors, self.pw
        dev = rows.device
        timers_cur = pk.get(rows, "timers")  # [B]
        col = torch.arange(n, device=dev)[None, :]  # [1, n]
        fw_t = FieldWriter(pk, rows[:, None, :pw].expand(B, n, pw))
        valid_t = ((timers_cur[:, None] >> col) & 1) == 1  # [B, n]
        poison_t = torch.zeros((B, n), dtype=torch.bool, device=dev)
        tvals = []
        send_cols = []
        for i in range(n):
            nc = cst["ttrans"][i][safe[i]]
            nb = cst["tbit"][i][safe[i]]
            send_cols.append(cst["tsends"][i][safe[i]])  # [B, Kt]
            fw_t.set(f"a{i}",
                     torch.where(col == i, nc[:, None], raw[i][:, None]))
            tvals.append((timers_cur & ~(1 << i)) | (nb << i))
            poison_t = poison_t | ((col == i) & cst["tpoison"][i][safe[i]][:, None])
        fw_t.set("timers", torch.stack(tvals, 1))
        slots_t = slots[:, None, :].expand(B, n, self.n_slots)
        sk_all = torch.stack(send_cols, dim=1)  # [B, n, Kt]
        for k in range(self.Kt):
            sk = sk_all[..., k]
            slots_t, of = self._send(slots_t, sk, valid_t & (sk >= 0), cst)
            poison_t = poison_t | of
        cur_poison = pk.get(rows, "poison")[:, None]
        fw_t.set("poison", torch.maximum(poison_t.to(torch.int64), cur_poison))
        succ_t = torch.cat([fw_t.done(), slot_canonicalize(slots_t)], dim=-1)
        return succ_t, valid_t

    # -- per-channel step ----------------------------------------------------

    def _region(self, rows, ci: int):
        """Channel ``ci``'s slot region: a static last-axis slice."""
        base = self.pw + self._ch_base[ci]
        return rows[..., base: base + self._ch_cap[ci]]

    def _region_codes(self, reg, ci: int):
        """Occupied mask and envelope codes of a region's words; a free
        slot reads the channel's first code, a code past the universe the
        last code."""
        occ = reg != _EMPTY
        ecode = torch.where(occ, lshr(reg, COUNT_BITS),
                            int(self._ch_codes[ci][0]))
        return occ, ecode.clamp_(max=self._ne_padded - 1)

    def _broadcast_region(self, rows, t: int, lead: int):
        B = rows.shape[0]
        return self._region(rows, t)[:, None, :].expand(
            B, lead, self._ch_cap[t])

    def _assemble_piece(self, outp, rows, lead, work):
        """One action family's row piece ``[B, lead, W]``: the updated
        packed words plus every slot region — touched regions (members of
        ``work``, re-canonicalized) in place, untouched regions as
        broadcast copies of the input slice."""
        parts = [outp]
        for t in range(len(self._channels)):
            if t in work:
                parts.append(slot_canonicalize(work[t]))
            else:
                parts.append(self._broadcast_region(rows, t, lead))
        return torch.cat(parts, dim=-1)

    def _apply_sends(self, work, rows, valid, send_codes, targets, cst,
                     lead):
        """Apply one action family's sends, confined per static target
        channel: ``send_codes`` ``[B, lead, K]``; ``targets[k]`` lists the
        channels send slot ``k`` can reach (from the frozen tables).
        Returns the overflow mask ``[B, lead]``, or None where overflow is
        statically impossible (duplicating regions sized to their code
        universe)."""
        overflow = None
        for k in range(min(send_codes.shape[-1], len(targets))):
            sk = send_codes[..., k]  # [B, lead]
            for t in targets[k]:
                cur = work.get(t)
                if cur is None:
                    cur = self._broadcast_region(rows, t, lead)
                en = valid & (sk >= 0) & (cst["chan_of"][sk.clamp(min=0)] == t)
                if self.ordered:
                    cur, of = region_send_ordered(cur, sk, en)
                else:
                    cur, of = slot_send(cur, sk, en, set_semantics=self.dup)
                work[t] = cur
                if not self.dup:  # set-semantics regions cannot overflow
                    overflow = of if overflow is None else (overflow | of)
        return overflow

    def _consumed(self, reg, occ):
        """``[B, cap(action), cap(word)]``: the region after consuming slot
        ``a`` (one copy, or the flow head and the rest of the flow
        advanced by one rank): the non-duplicating deliver and drop
        effect."""
        B, cap = reg.shape
        reg_b = reg[:, None, :].expand(B, cap, cap)
        diag = torch.eye(cap, dtype=torch.bool, device=reg.device)[None]
        if self.ordered:
            occ_b = occ[:, None, :].expand(B, cap, cap)
            return torch.where(diag, _EMPTY,
                               torch.where(occ_b, reg_b - 1, reg_b))
        gone = torch.where((reg & COUNT_MASK) <= 1, _EMPTY, reg - 1)
        return torch.where(diag, gone[:, :, None], reg_b)

    def _step_rows_per_channel(self, rows: torch.Tensor):
        """The per-channel twin's step (the JAX compiler's
        ``_step_rows_per_channel``): the successor stack is one action-axis
        concatenation of per-channel pieces — the deliveries of each
        channel, then (lossy) the drops of each channel, then (with timers)
        one Timeout action per actor — whose writes are confined to the
        channel's own region, the recipient's packed fields and the send
        target regions."""
        cst = self._consts(rows.device)
        B = rows.shape[0]
        ne = self._ne_padded
        pk = self.pk
        n = self.n_actors
        raw, safe = self._codes(rows)
        packed = rows[:, : self.pw]

        def packed_broadcast(lead):
            return packed[:, None, :].expand(B, lead, self.pw)

        pieces, valids = [], []
        parents = self._history_parents(rows) if self.C else None

        # -- deliver actions: one per (channel, slot) -----------------------
        for ci, (_s, d) in enumerate(self._channels):
            if d >= n:
                continue
            cap = self._ch_cap[ci]
            reg = self._region(rows, ci)  # [B, cap]
            occ, ecode = self._region_codes(reg, ci)
            flat = safe[d][:, None] * ne + ecode  # [B, cap], in range
            nc = cst["trans"][d][flat]
            valid = occ & (nc >= 0)
            if self.ordered:
                valid = valid & ((reg & COUNT_MASK) == 1)
            poison = None
            if self._ch_poison_any[ci]:
                poison = occ & cst["poison"][d][flat]

            work = {} if self.dup else {ci: self._consumed(reg, occ)}
            of = self._apply_sends(work, rows, valid, cst["sends"][d][flat],
                                   self._ch_targets[ci], cst, cap)
            if of is not None:
                poison = of if poison is None else (poison | of)

            fw = FieldWriter(pk, packed_broadcast(cap))
            fw.set(f"a{d}", torch.where(valid, nc, raw[d][:, None]))
            if self._ch_ret_kind[ci] and self.C:
                kind = cst["env_kind"][ecode]
                if self._multi:
                    m_w = valid & (kind == _K_PUT_OK)
                else:
                    m_w = valid & ((kind == _K_PUT_OK) | (kind == _K_PUT_FAIL))
                self._client_history(
                    fw, rows, parents, m_w, valid & (kind == _K_GET_OK), kind,
                    cst["env_val"][ecode], int(self._client_of[d]), (B, cap),
                )
            if self._has_timers and self._ch_timer[ci]:
                eff = cst["teff"][d][flat]  # [B, cap]
                tcur = pk.get(rows, "timers")[:, None]
                bit = (tcur >> d) & 1
                nb = torch.where(valid & (eff == 1), 1,
                                 torch.where(valid & (eff == 0), 0, bit))
                fw.set("timers", (tcur & ~(1 << d)) | (nb << d))
            if poison is not None:
                fw.or_field("poison", poison)
            pieces.append(self._assemble_piece(fw.done(), rows, cap, work))
            valids.append(valid)

        # -- drop actions (lossy): every channel, network-only effect -------
        if self.model.lossy:
            for ci in range(len(self._channels)):
                cap = self._ch_cap[ci]
                reg = self._region(rows, ci)
                occ = reg != _EMPTY
                if self.dup:
                    # only drops remove from a duplicating network
                    diag = torch.eye(cap, dtype=torch.bool,
                                     device=rows.device)[None]
                    dropped = torch.where(
                        diag, _EMPTY, reg[:, None, :].expand(B, cap, cap))
                    droppable = occ
                else:
                    # a drop's network effect IS the deliver consume
                    dropped = self._consumed(reg, occ)
                    droppable = (occ & ((reg & COUNT_MASK) == 1)
                                 if self.ordered else occ)
                pieces.append(self._assemble_piece(
                    packed_broadcast(cap), rows, cap, {ci: dropped}))
                valids.append(droppable)

        # -- timeout actions: one per actor ---------------------------------
        if self._has_timers:
            tcur_all = pk.get(rows, "timers")  # [B]
            for i in range(n):
                nc = cst["ttrans"][i][safe[i]]
                nb = cst["tbit"][i][safe[i]]
                valid_i = (((tcur_all >> i) & 1) == 1)[:, None]  # [B, 1]
                fw = FieldWriter(pk, packed_broadcast(1))
                fw.set(f"a{i}",
                       torch.where(valid_i, nc[:, None], raw[i][:, None]))
                fw.set("timers",
                       (tcur_all[:, None] & ~(1 << i)) | (nb[:, None] << i))
                work: dict = {}
                ks = cst["tsends"][i][safe[i]][:, None, :]  # [B, 1, Kt]
                of = self._apply_sends(work, rows, valid_i, ks,
                                       self._t_targets[i], cst, 1)
                poison = None
                if bool(self._tpoison_np[i].any()):
                    poison = valid_i & cst["tpoison"][i][safe[i]][:, None]
                if of is not None:
                    poison = of if poison is None else (poison | of)
                if poison is not None:
                    fw.or_field("poison", poison)
                pieces.append(self._assemble_piece(fw.done(), rows, 1, work))
                valids.append(valid_i)

        if not pieces:  # message-less, timer-less: one never-valid column
            return (rows[:, None, :],
                    torch.zeros((B, 1), dtype=torch.bool, device=rows.device))
        return torch.cat(pieces, dim=1), torch.cat(valids, dim=-1)

    @property
    def has_boundary(self) -> bool:
        return self._boundary_np is not None

    def poison_rows(self, rows: torch.Tensor) -> torch.Tensor:
        """True per row iff a compile-time bound was crossed reaching it;
        the engine turns a poisoned POPPED row into a run failure (poisoned
        rows would otherwise dedup onto their self-loop and quietly
        truncate the space)."""
        return self.pk.get(rows, "poison") == 1

    def boundary_rows(self, rows: torch.Tensor) -> torch.Tensor:
        """``within_boundary`` over encoded rows of any leading shape (the
        device analogue of the host checkers' boundary filter; ``step_rows``
        itself mirrors the unfiltered ``next_states``)."""
        cst = self._consts(rows.device)
        _, safe = self._codes(rows)
        b = cst["boundary"][0][safe[0]]
        for i in range(1, self.n_actors):
            x = cst["boundary"][i][safe[i]]
            b = (b & x) if self._boundary.kind == "forall" else (b | x)
        return b

    def _eval_factored(self, entry, safe, batch, device):
        kind, tables = entry
        n = self.n_actors
        if kind in ("forall", "exists"):
            v = tables[0][safe[0]]
            for i in range(1, n):
                x = tables[i][safe[i]]
                v = (v & x) if kind == "forall" else (v | x)
            return v
        conj = kind == "forall_pairs"
        v = torch.full((batch,), conj, dtype=torch.bool, device=device)
        for i in range(n):
            for j in range(i + 1, n):
                x = tables[(i, j)][safe[i], safe[j]]
                v = (v & x) if conj else (v | x)
        return v

    def property_masks(self, rows: torch.Tensor) -> torch.Tensor:
        cst = self._consts(rows.device)
        pk = self.pk
        B = rows.shape[0]
        _, safe = self._codes(rows)
        if self.general:
            if not cst["props"]:
                return torch.zeros((B, 0), dtype=torch.bool,
                                   device=rows.device)
            return torch.stack(
                [self._eval_factored(e, safe, B, rows.device)
                 for e in cst["props"]],
                dim=-1,
            )

        def fields(name):  # [B, C]
            return torch.stack(
                [pk.get(rows, f"h{c}_{name}") for c in range(self.C)], -1
            )

        phases, rvals = fields("phase"), fields("rval")
        if self._multi:
            snaps = torch.stack(
                [
                    torch.stack(
                        [pk.get(rows, f"h{c}_snap{m}")
                         for m in range(self.hist.K)],
                        -1,
                    )
                    for c in range(self.C)
                ],
                -2,
            )  # [B, C, K]
            linearizable = self.hist.device_lookup(
                self.hist.device_key(phases, snaps, rvals))
        elif self.hist.strategy == "closure":
            linearizable = self.hist.device_verdict(
                phases, fields("snap"), rvals)
        else:
            wfails = fields("wfail") if self.hist.wfail_bits else None
            linearizable = self.hist.device_lookup(
                self.hist.device_key(phases, fields("snap"), rvals, wfails))

        if self.per_channel:
            # only the chosen-capable channels' regions: get_ok envelopes
            # live on statically known server→client channels
            chosen = torch.zeros((B,), dtype=torch.bool, device=rows.device)
            for ci in self._chosen_channels:
                occ, ecode = self._region_codes(self._region(rows, ci), ci)
                chosen = chosen | (occ & cst["env_chosen"][ecode]).any(dim=-1)
        else:
            occ, ecode = self._slot_codes(rows[:, self.pw :])
            chosen = (occ & cst["env_chosen"][ecode]).any(dim=-1)
        masks = {"linearizable": linearizable, "value chosen": chosen}
        return torch.stack(
            [
                masks[p.name]
                if cst["props"][k] is None
                else self._eval_factored(cst["props"][k], safe, B, rows.device)
                for k, p in enumerate(self.model.properties())
            ],
            dim=-1,
        )
