"""The port's ordered reliable link, ``Choice``, ``ScriptedActor``, vector
spec and sequential-consistency tester against the JAX package's
(``tests/test_orl_compile.py``, ``tests/test_choice.py`` and the ORL,
vector and sequential-consistency cases of ``tests/test_semantics.py``),
tolerance 0.  The ORL sender/receiver compiles for the GPU engine: 148
unique on the host BFS and on ``spawn_gpu(device="cpu")``, with the JAX
engine's table bytes at the same capacities; an ORL system that never
stops sending fails to compile with an error that names the wrapper's
unbounded fields."""

import numpy as np
import pytest

import jax  # noqa: F401  (both frameworks in one process, JAX on the CPU)

from stateright_tpu.semantics import SequentialConsistencyTester as JaxSC
from stateright_tpu.semantics import VecSpec as JaxVecSpec
from stateright_tpu.semantics import Register as JaxRegister
from stateright_tpu_torch.actor import (
    Actor,
    ActorModel,
    Deliver,
    Id,
    Network,
    Out,
    ScriptedActor,
)
from stateright_tpu_torch.actor.choice import Choice, ChoiceState
from stateright_tpu_torch.actor.device_props import exists_actor, forall_actors
from stateright_tpu_torch.actor.ordered_reliable_link import (
    LinkState,
    OrderedReliableLink,
)
from stateright_tpu_torch.checker.visitor import StateRecorder
from stateright_tpu_torch.core import Expectation
from stateright_tpu_torch.fingerprint import fingerprint
from stateright_tpu_torch.models import orl
from stateright_tpu_torch.models.orl import OrlModel, orl_model
from stateright_tpu_torch.parallel.actor_compiler import (
    CompileError,
    compile_actor_model,
)
from stateright_tpu_torch.semantics import (
    LinearizabilityTester,
    Register,
    SequentialConsistencyTester,
    VecSpec,
)
from stateright_tpu_torch.semantics.register import READ, write

# -- the vector spec and sequential consistency --------------------------------


def test_vec_spec():
    v, jv = VecSpec(("A",)), JaxVecSpec(("A",))
    for op, want in ((("len",), ("len_ok", 1)), (("push", "B"), ("push_ok",)),
                     (("pop",), ("pop_ok", "B")), (("pop",), ("pop_ok", "A")),
                     (("pop",), ("pop_ok", None))):
        v, ret = v.invoke(op)
        jv, jret = jv.invoke(op)
        assert ret == jret == want
    with pytest.raises(ValueError, match="unknown vec op"):
        v.invoke(("peek",))


def test_stale_read_is_sequentially_consistent_but_not_linearizable():
    def history(cls, reg):
        return (cls(reg("A")).on_invret(0, write("B"), ("write_ok",))
                .on_invret(1, READ, ("read_ok", "A")))

    assert not history(LinearizabilityTester, Register).is_consistent()
    h = history(SequentialConsistencyTester, Register)
    assert h.is_consistent()
    assert h.serialized_history() == [
        (READ, ("read_ok", "A")),
        (write("B"), ("write_ok",)),
    ]
    assert h.serialized_history() == history(
        JaxSC, JaxRegister).serialized_history()
    # the verdict cache folds in the tester type: the two never mix
    assert h != history(LinearizabilityTester, Register)


def test_sequential_consistency_keeps_program_order():
    # one thread writes B then reads A: no serialization explains it
    h = (SequentialConsistencyTester(Register("A"))
         .on_invret(0, write("B"), ("write_ok",))
         .on_invret(0, READ, ("read_ok", "A")))
    assert not h.is_consistent()
    assert h.serialized_history() is None
    invalid = SequentialConsistencyTester(Register("A")).on_invoke(
        0, READ).on_invoke(0, READ)
    assert not invalid.valid and not invalid.is_consistent()


def test_vec_histories():
    h = (LinearizabilityTester(VecSpec())
         .on_invret(0, ("pop",), ("pop_ok", "X"))
         .on_invret(1, ("push", "X"), ("push_ok",)))
    assert not h.is_consistent()
    h2 = (LinearizabilityTester(VecSpec())
          .on_invoke(1, ("push", "X"))
          .on_invret(0, ("pop",), ("pop_ok", "X")))
    assert h2.is_consistent()
    sc = (SequentialConsistencyTester(VecSpec())
          .on_invret(0, ("pop",), ("pop_ok", "X"))
          .on_invret(1, ("push", "X"), ("push_ok",)))
    # only program order binds: the push serializes before the pop
    assert sc.is_consistent()
    assert sc.serialized_history()[0] == (("push", "X"), ("push_ok",))
    assert (SequentialConsistencyTester(VecSpec())
            .on_invret(0, ("push", "X"), ("push_ok",))
            .on_invret(1, ("len",), ("len_ok", 0))).is_consistent()


# -- Choice (reference model.rs:862-977) ---------------------------------------


class A(Actor):  # a wrapping byte counter
    def __init__(self, b: Id):
        self.b = b

    def on_start(self, id, out):
        return 1

    def on_msg(self, id, state, src, msg, out):
        out.send(self.b, msg)
        return (state + 1) % 256


class B(Actor):  # a character
    def __init__(self, c: Id):
        self.c = c

    def on_start(self, id, out):
        return "a"

    def on_msg(self, id, state, src, msg, out):
        out.send(self.c, msg)
        return chr((ord(state) + 1) % 256)


class C(Actor):  # a string; kicks off the ring
    def __init__(self, a: Id):
        self.a = a

    def on_start(self, id, out):
        out.send(self.a, ())
        return "I"

    def on_msg(self, id, state, src, msg, out):
        out.send(self.a, msg)
        return state + "I"


def test_choice_correctly_implements_actor():
    """The exact DFS visit sequence of the reference (``model.rs:914-977``)."""
    recorder = StateRecorder()
    (
        ActorModel(cfg=None, init_history=0)
        .actor(Choice.new(A(Id(1))))
        .actor(Choice.new(B(Id(2))).or_())
        .actor(Choice.new(C(Id(0))).or_().or_())
        .init_network_(Network.new_unordered_nonduplicating())
        .record_msg_out(lambda cfg, out_count, env: out_count + 1)
        .property(Expectation.ALWAYS, "true", lambda m, s: True)
        .within_boundary_(lambda cfg, state: state.history < 8)
    ).checker().visitor(recorder).spawn_dfs().join()
    states = [tuple(s.actor_states) for s in recorder.states]
    cs = ChoiceState
    assert states == [
        (cs(0, 1), cs(1, "a"), cs(2, "I")),
        (cs(0, 2), cs(1, "a"), cs(2, "I")),
        (cs(0, 2), cs(1, "b"), cs(2, "I")),
        (cs(0, 2), cs(1, "b"), cs(2, "II")),
        (cs(0, 3), cs(1, "b"), cs(2, "II")),
        (cs(0, 3), cs(1, "c"), cs(2, "II")),
        (cs(0, 3), cs(1, "c"), cs(2, "III")),
    ]


def test_choice_tags_disambiguate_equal_inner_states():
    from stateright_tpu.actor.choice import ChoiceState as JaxChoiceState
    from stateright_tpu.fingerprint import fingerprint as jax_fingerprint

    s0, s1 = ChoiceState(0, 1), ChoiceState(1, 1)
    assert s0 != s1 and hash(s0) != hash(s1)
    assert fingerprint(s0) != fingerprint(s1)
    assert fingerprint(s1) == jax_fingerprint(JaxChoiceState(1, 1))


def test_choice_noop_is_preserved_and_variants_are_checked():
    class Quiet(Actor):
        def on_start(self, id, out):
            return 0

    c = Choice.new(Quiet()).or_()
    out = Out()
    assert c.on_msg(Id(0), ChoiceState(1, 0), Id(1), (), out) is None
    assert c.on_timeout(Id(0), ChoiceState(1, 0), out) is None
    assert len(out) == 0
    with pytest.raises(AssertionError, match="variant mismatch"):
        c.on_msg(Id(0), ChoiceState(0, 0), Id(1), (), out)


def test_scripted_actor_sends_one_message_per_delivery():
    script = [(Id(1), "a"), (Id(1), "b")]
    m = (ActorModel(None, None)
         .actor(ScriptedActor(script))
         .actor(ScriptedActor([(Id(0), "ack")] * 2))
         .init_network_(Network.new_unordered_nonduplicating())
         .property(Expectation.SOMETIMES, "done",
                   lambda m, s: s.actor_states[0] == 2))
    c = m.checker().spawn_bfs().join()
    assert "done" in c.discoveries()
    out = Out()
    assert ScriptedActor(script).on_start(Id(0), out) == 1
    assert [(c.dst, c.msg) for c in out.commands] == [(Id(1), "a")]
    assert ScriptedActor([]).on_start(Id(0), Out()) == 0


# -- the ORL on the host (reference ordered_reliable_link.rs:150-244) ----------


def bounded_orl_model():
    """The semantics tests' ORL system: whole-state properties, bounded by
    the network's size."""
    def received(state):
        return [m for _, m in state.actor_states[1].wrapped_state]

    return (
        ActorModel(None, None)
        .actor(OrderedReliableLink(orl.OrlSender(Id(1))))
        .actor(OrderedReliableLink(orl.OrlReceiver()))
        .init_network_(Network.new_unordered_duplicating())
        .lossy_network(True)
        .property(Expectation.ALWAYS, "no redelivery",
                  lambda m, s: received(s).count(42) < 2
                  and received(s).count(43) < 2)
        .property(Expectation.ALWAYS, "ordered",
                  lambda m, s: received(s) == sorted(received(s)))
        .property(Expectation.SOMETIMES, "delivered",
                  lambda m, s: s.actor_states[1].wrapped_state
                  == ((Id(0), 42), (Id(0), 43)))
        .within_boundary_(lambda c, s: len(s.network) < 4)
    )


def test_orl_messages_not_redelivered_ordered_and_delivered():
    checker = bounded_orl_model().checker().spawn_bfs().join()
    checker.assert_no_discovery("no redelivery")
    checker.assert_no_discovery("ordered")
    checker.assert_discovery("delivered", [
        Deliver(src=Id(0), dst=Id(1), msg=("deliver", 1, 42)),
        Deliver(src=Id(0), dst=Id(1), msg=("deliver", 2, 43)),
    ])


def test_orl_wrapped_actor_timers_are_refused():
    class Timed(Actor):
        def on_start(self, id, out):
            out.set_timer()
            return 0

    with pytest.raises(NotImplementedError, match="timers"):
        OrderedReliableLink(Timed()).on_start(Id(0), Out())


# -- the ORL compiled for the GPU engine (tests/test_orl_compile.py) ----------

# both engines at the same capacities; a small batch keeps the CPU steps
# cheap
ORL_KW = dict(capacity=1 << 12, batch=64)


@pytest.fixture(scope="module")
def jax_orl():
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).parent))
    from test_orl_compile import _orl_model

    j = _orl_model().checker().spawn_tpu(sync=True, **ORL_KW)
    assert j.unique_state_count() == orl.ORL_UNIQUE
    return j


def test_orl_compiles_and_pins_host_device(jax_orl):
    m = orl_model()
    h = m.checker().spawn_bfs().join()
    assert h.unique_state_count() == orl.ORL_UNIQUE
    assert sorted(h.discoveries()) == ["delivered"]
    c = orl_model().checker().spawn_gpu(device="cpu", **ORL_KW).join()
    assert (c.unique_state_count(), c.state_count()) == (
        jax_orl.unique_state_count(), jax_orl.state_count())
    assert sorted(c.discoveries()) == ["delivered"]
    c.assert_properties()  # neither always property is violated
    for a, b in zip(c._table_np(), jax_orl._table_np()):
        np.testing.assert_array_equal(a, np.asarray(b))
    # the device witness re-executes on the host model
    actions = list(c.discoveries()["delivered"].actions())
    h.assert_discovery("delivered", actions)
    assert [repr(a) for a in actions] == [
        repr(a) for a in jax_orl.discoveries()["delivered"].actions()]


def test_orl_verbs(capsys):
    assert orl.main(["check"]) == 0
    out = capsys.readouterr().out
    assert "unique=148" in out and 'Discovered "delivered"' in out


class _Echo(Actor):
    """Replies to every delivery with a fresh send: the ORL sequencer grows
    without bound and the closure can never finish."""

    def __init__(self, peer):
        self.peer = peer

    def on_start(self, id, out):
        out.send(self.peer, 0)
        return ()

    def on_msg(self, id, state, src, msg, out):
        out.send(src, msg + 1)
        return state


def test_unbounded_orl_raises_targeted_compile_error():
    m = (
        OrlModel()
        .actor(OrderedReliableLink(_Echo(Id(1))))
        .actor(OrderedReliableLink(_Echo(Id(0))))
        .init_network_(Network.new_unordered_nonduplicating())
        .property(Expectation.ALWAYS, "ok", forall_actors(lambda i, s: True))
    )
    with pytest.raises(CompileError) as e:
        compile_actor_model(m, max_states_per_actor=500)
    msg = str(e.value)
    for word in ("OrderedReliableLink", "next_send_seq", "state_bound",
                 "compiling-actor-systems.md"):
        assert word in msg
    assert m.tensor_model() is None  # the model falls back to the host


@pytest.mark.slow
def test_unbounded_orl_compiles_with_state_bound_recipe():
    """The recipe of docs/compiling-actor-systems.md: cap the ORL sequencer
    and the wrapped payloads; the device equals a host run bounded the same
    way (the JAX test of the same name)."""
    cap = 3

    def bound(i, s):
        return not isinstance(s, LinkState) or (
            s.next_send_seq <= cap + 2
            and all(m <= 2 * cap for _, _, m in s.msgs_pending_ack))

    def env_bound(env):
        return env.msg[0] != "deliver" or env.msg[2] <= 2 * cap

    def make():
        return (
            OrlModel()
            .actor(OrderedReliableLink(_Echo(Id(1))))
            .actor(OrderedReliableLink(_Echo(Id(0))))
            .init_network_(Network.new_unordered_duplicating())
            .property(Expectation.SOMETIMES, "echoed thrice", exists_actor(
                lambda i, s: isinstance(s, LinkState)
                and s.next_send_seq > cap))
            .property(Expectation.ALWAYS, "seq in bound", forall_actors(
                lambda i, s: not isinstance(s, LinkState)
                or s.next_send_seq <= cap + 1))
            .within_boundary_(forall_actors(
                lambda i, s: not isinstance(s, LinkState)
                or s.next_send_seq <= cap + 1))
        )

    m = make()
    tm = compile_actor_model(m, state_bound=bound, env_bound=env_bound)
    m._tensor_cached = lambda: tm
    h = make().checker().spawn_bfs().join()
    c = m.checker().spawn_gpu(device="cpu", capacity=1 << 13,
                              batch=64).join()
    assert h.unique_state_count() == c.unique_state_count() > 0
    assert sorted(h.discoveries()) == sorted(c.discoveries())
