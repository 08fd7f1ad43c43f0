"""The per-channel network encoding in the port (``per_channel_()``,
``compile_actor_model(per_channel=...)``) against the JAX package,
tolerance 0:

 - ``Envelope.channel`` and ``Network.channels()``;
 - ``region_send_ordered`` on free, full and too-deep regions;
 - the compiled layout: every table, the channel layout and the init rows
   of per-channel paxos-1 and paxos-2, single-copy, ABD, ordered ABD and
   raft-3;
 - ``step_rows``/``property_masks`` against the JAX twin on crawled rows
   (per-channel paxos-1 every state, with the object model), and on rows
   with free, full and out-of-universe regions;
 - the engine (``spawn_gpu(device="cpu")``) against
   ``spawn_tpu(sync=True)``: counts, discoveries and traces, table bytes
   and queue rows, at per-channel paxos-1 (482 / 265), ordered paxos-1
   (178 / 99), a duplicating network and raft-3's timers;
 - the ordered depth knob, the relayed ret-kind envelope, the closure
   estimate's fail-fast error on per-channel paxos-3 and its escape hatch.

Per-channel paxos-2, the benchmark leg (32,971 / 16,668 at W = 83), is
held against the JAX test's pins in ``test_torch_per_channel_paxos2.py``.
"""

import time
from dataclasses import dataclass

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stateright_tpu.models.raft import raft_model as jax_raft
from stateright_tpu.parallel.actor_tensor import (
    region_send_ordered as jax_region_send_ordered,
)
from stateright_tpu_torch.actor import Actor, ActorModel, Id, Network
from stateright_tpu_torch.actor.device_props import exists_actor
from stateright_tpu_torch.actor.network import Envelope
from stateright_tpu_torch.actor.register import (
    NULL_VALUE,
    GetOk,
    PutOk,
    RegisterClient,
    record_invocations,
    record_returns,
    value_chosen,
)
from stateright_tpu_torch.core import Expectation
from stateright_tpu_torch.models.paxos import PaxosState, paxos_model
from stateright_tpu_torch.models.paxos_tensor import PaxosTensor
from stateright_tpu_torch.models.raft import raft_model
from stateright_tpu_torch.parallel.actor_compiler import (
    CompiledActorTensor,
    CompileError,
    compile_actor_model,
)
from stateright_tpu_torch.parallel.actor_tensor import region_send_ordered
from stateright_tpu_torch.parallel.tensor_model import TensorBackedModel
from stateright_tpu_torch.semantics import LinearizabilityTester, Register
from test_torch_actor_compiler import assert_same_compile, engine_pair, pair
from test_torch_paxos import as_rows, bfs_levels, check_twin_against_jax

P1_FULL = (482, 265)
P1_ORDERED = (178, 99)
# the JAX compiler's error on per-channel paxos-3 at ballot bound 3
# (``tests/test_sweep.py::test_closure_estimator_trips_fast_on_paxos3_per_channel``)
P3_ESTIMATE_MESSAGE = (
    "actor 2 state universe is on course to exceed the 200000-state cap: "
    "28754 states after 1792323 handler calls with 9572452 deliveries "
    "already queued, production rate undiminished (pre-closure estimate "
    "≥ 751902); tighten state_bound, or raise max_states_per_actor "
    "(escape hatch: STATERIGHT_TPU_CLOSURE_ESTIMATE=off)"
)


def per_channel(m):
    m.per_channel_()
    return m


def pc_pair(name):
    """(port, JAX) models of ``name`` with the per-channel packing."""
    if name == "raft-3":
        m, jm = raft_model(3), jax_raft(3)
    else:
        m, jm = pair(name)
    return per_channel(m), per_channel(jm)


def assert_same_layout(tm, jtm):
    assert tm.network_encoding == jtm.network_encoding == "per-channel"
    assert_same_compile(tm, jtm)
    for name in ("_channels", "_ch_cap", "_ch_base", "_ch_poison_any",
                 "_ch_ret_kind", "_ch_timer", "_ch_targets",
                 "_chosen_channels"):
        assert getattr(tm, name) == getattr(jtm, name), name
    for a, b in zip(tm._ch_codes, jtm._ch_codes, strict=True):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tm._chan_of, jtm._chan_of)
    if tm._has_timers:
        assert tm._t_targets == jtm._t_targets


# ---------------------------------------------------------------------------
# the host layer
# ---------------------------------------------------------------------------


def test_network_channel_helpers():
    e = Envelope(src=1, dst=2, msg=("x",))
    assert e.channel == (1, 2)
    n = Network.new_unordered_nonduplicating()
    n = n.send(Envelope(0, 1, ("a",))).send(Envelope(1, 0, ("b",)))
    n = n.send(Envelope(0, 1, ("c",)))
    assert n.channels() == [(0, 1), (1, 0)]
    assert Network.new_ordered().channels() == []


def test_per_channel_resolution_rule(monkeypatch):
    monkeypatch.delenv("STATERIGHT_TPU_PER_CHANNEL", raising=False)
    m = paxos_model(1)
    assert not m.per_channel_resolved()
    monkeypatch.setenv("STATERIGHT_TPU_PER_CHANNEL", "1")
    assert m.per_channel_resolved()
    m.per_channel_(False)  # the builder's choice wins over the knob
    assert not m.per_channel_resolved()
    # the hand-written twin stays the default; per-channel routes to the
    # compiler
    monkeypatch.delenv("STATERIGHT_TPU_PER_CHANNEL")
    assert isinstance(paxos_model(2).tensor_model(), PaxosTensor)
    tm = per_channel(paxos_model(2)).tensor_model()
    assert isinstance(tm, CompiledActorTensor)
    assert tm.network_encoding == "per-channel"


# ---------------------------------------------------------------------------
# region_send_ordered
# ---------------------------------------------------------------------------


def send_both(regs, codes, enable):
    got, gof = region_send_ordered(
        torch.from_numpy(regs.view(np.int64)),
        torch.from_numpy(codes.view(np.int64)), torch.from_numpy(enable))
    want, wof = jax_region_send_ordered(
        jnp.asarray(regs), jnp.asarray(codes), jnp.asarray(enable))
    np.testing.assert_array_equal(got.numpy().view(np.uint64),
                                  np.asarray(want))
    np.testing.assert_array_equal(gof.numpy(), np.asarray(wof))
    return gof.numpy()


def test_region_send_ordered_matches_jax_on_free_full_and_deep_regions():
    """Regions of 4 slots (empty, partly filled, full), and a 64-slot
    region whose flow is already ``COUNT_MASK`` deep; sends enabled and
    disabled, codes up to 2^40."""
    E = np.uint64(0xFFFFFFFFFFFFFFFF)
    w = [np.uint64((c << 6) | r) for c, r in ((7, 1), (9, 2), (3, 3), (5, 4))]
    regs = np.repeat(np.asarray([
        [E, E, E, E],
        [w[0], w[1], E, E],
        [w[0], w[1], w[2], E],
        w,
    ], np.uint64), 4, axis=0)
    rng = np.random.default_rng(7)
    codes = rng.integers(0, 1 << 40, size=len(regs)).astype(np.uint64)
    enable = np.tile([True, False, True, True], len(regs) // 4)
    of = send_both(regs, codes, enable)
    # only the full region overflows, where the send is enabled
    assert of.tolist() == [False] * 12 + [True, False, True, True]
    deep = np.full((2, 64), E, np.uint64)
    deep[:, :63] = (np.arange(63, dtype=np.uint64) << np.uint64(6)) | (
        np.arange(1, 64, dtype=np.uint64))
    deep[1, 62] = E  # 62 deep: one more still fits
    of = send_both(deep, np.asarray([99, 99], np.uint64),
                   np.asarray([True, True]))
    assert of.tolist() == [True, False]


# ---------------------------------------------------------------------------
# the compiled layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", [
    "paxos-1-3", "paxos-2-3", "sc-2-1", "abd-2-2", "abd-2-2-ordered",
    "raft-3",
])
def test_layout_tables_and_init_rows_equal_jax(name):
    m, jm = pc_pair(name)
    tm, jtm = m.tensor_model(), jm.tensor_model()
    assert isinstance(tm, CompiledActorTensor)
    assert_same_layout(tm, jtm)
    if name == "paxos-2-3":
        assert (tm.width, tm.max_actions, tm.n_slots) == (83, 82, 82)
    # the init rows decode back to the init state
    (row,) = tm.init_rows()
    assert tm.decode_state(row) == tm._init_state


# ---------------------------------------------------------------------------
# step_rows / property_masks
# ---------------------------------------------------------------------------


def test_step_rows_and_masks_match_jax_on_every_paxos1_state():
    """Every per-channel paxos-1 state: successors, validity and masks
    equal the JAX twin's, and the valid successors are the encodings of the
    object model's ``next_states``."""
    m, jm = pc_pair("paxos-1-3")
    states = [s for lvl in bfs_levels(m) for s in lvl]
    assert len(states) == P1_FULL[1]
    tm = m._tensor_cached()
    for s, row in zip(states, as_rows(tm, states)):
        assert tm.decode_state(row) == s
    valid, masks = check_twin_against_jax(m, jm, states, as_rows(tm, states),
                                          True)
    assert masks[:, 1].any() and masks[:, 0].all()


@pytest.mark.parametrize("name,levels", [
    ("abd-2-2-ordered", 6),
    ("raft-3", 3),
    ("sc-1-1-dup", None),
])
def test_step_rows_and_masks_match_jax_on_crawled_levels(name, levels):
    m, jm = pc_pair(name)
    states = [s for lvl in bfs_levels(m, levels) for s in lvl]
    valid, _ = check_twin_against_jax(
        m, jm, states, as_rows(m._tensor_cached(), states), True)
    assert valid.any()


def odd_region_rows(tm, rows):
    """Rows whose regions are all free, all full of in-universe codes, or
    hold codes past the universe and all-ones actor fields."""
    empty = rows.copy()
    empty[:, tm.pw:] = np.uint64(0xFFFFFFFFFFFFFFFF)
    full = rows.copy()
    for ci, codes in enumerate(tm._ch_codes):
        base, cap = tm.pw + tm._ch_base[ci], tm._ch_cap[ci]
        for r in range(len(full)):
            picked = np.resize(np.roll(codes, r), cap).astype(np.uint64)
            full[r, base:base + cap] = np.sort(
                (picked << np.uint64(6)) | np.uint64(1))
    wild = rows.copy()
    ne = len(tm._envs)
    wild[:, -1] = np.uint64(((ne + 5) << 6) | 1)
    wild[:, tm.pw] = np.uint64((((1 << 57) | 3) << 6) | 2)  # top bit set
    for i in range(tm.n_actors):
        w, o, b = tm.pk.layout[f"a{i}"]
        wild[:, w] |= np.uint64(((1 << b) - 1) << o)
    return dict(empty=empty, full=full, wild=wild)


@pytest.mark.parametrize("name", ["paxos-1-3", "abd-2-2-ordered"])
def test_step_rows_stay_in_range_on_free_full_and_foreign_regions(name):
    m, jm = pc_pair(name)
    tm, jtm = m.tensor_model(), jm.tensor_model()
    jtm.init_rows()
    states = [s for lvl in bfs_levels(m, 3) for s in lvl]
    cases = odd_region_rows(tm, as_rows(tm, states))
    jstep, jmasks = jax.jit(jtm.step_rows), jax.jit(jtm.property_masks)
    for case in ("empty", "full"):
        r = cases[case]
        succ, valid = tm.step_rows(torch.from_numpy(r.view(np.int64)))
        jsucc, jvalid = jstep(jnp.asarray(r))
        valid, jvalid = valid.numpy(), np.asarray(jvalid)
        np.testing.assert_array_equal(valid, jvalid, err_msg=case)
        np.testing.assert_array_equal(succ.numpy().view(np.uint64)[valid],
                                      np.asarray(jsucc)[jvalid], err_msg=case)
        np.testing.assert_array_equal(
            tm.property_masks(torch.from_numpy(r.view(np.int64))).numpy(),
            np.asarray(jmasks(jnp.asarray(r))), err_msg=case)
        if case == "full":
            assert valid.any()
    wild = torch.from_numpy(cases["wild"].view(np.int64))
    succ, valid = tm.step_rows(wild)
    assert succ.shape == (len(states), tm.max_actions, tm.width)
    assert tm.property_masks(wild).shape == (len(states), 2)


# ---------------------------------------------------------------------------
# engine parity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,capacity,batch,counts", [
    ("paxos-1-3", 1 << 10, 1 << 5, P1_FULL),
    ("paxos-1-3-ordered", 1 << 10, 1 << 5, P1_ORDERED),
    ("sc-2-1-dup", 1 << 10, 1 << 5, None),
])
def test_engine_matches_jax_engine(name, capacity, batch, counts):
    m, jm = pc_pair(name)
    t = engine_pair(m, jm, capacity, batch)
    if counts is None:
        # both properties are discovered, so the run stops early, at a
        # point that depends on the packing's row order
        assert sorted(t.discoveries()) == ["linearizable", "value chosen"]
        return
    assert (t.state_count(), t.unique_state_count()) == counts
    assert sorted(t.discoveries()) == ["value chosen"]
    # complete runs: the slot-multiset packing explores the same space
    s = pair(name)[0].checker().spawn_gpu(device="cpu", capacity=capacity,
                                          batch=batch).join()
    assert (s.state_count(), s.unique_state_count()) == counts


def test_engine_matches_jax_engine_on_raft3_timers():
    m, jm = pc_pair("raft-3")
    t = engine_pair(m, jm, 1 << 14, 1 << 9)
    assert (t.state_count(), t.unique_state_count()) == (15_607, 5_725)
    assert sorted(t.discoveries()) == ["a leader is elected"]


# ---------------------------------------------------------------------------
# region capacity, relayed returns, the closure guard
# ---------------------------------------------------------------------------


@dataclass
class Resender(Actor):
    def on_start(self, id, out):
        if int(id) == 0:
            out.send(Id(1), ("ping",))  # the same message twice: ranks 1, 2
            out.send(Id(1), ("ping",))
        return 0

    def on_msg(self, id, state, src, msg, out):
        if msg[0] == "ping" and state < 2:
            return state + 1
        return None


def resender_model(pc, depth=None):
    class M(TensorBackedModel, ActorModel):
        def tensor_model(self):
            return compile_actor_model(self, per_channel=pc,
                                       per_channel_depth=depth)

    m = M(cfg=None, init_history=None)
    m.actor(Resender())
    m.actor(Resender())
    m.init_network_(Network.new_ordered())
    m.property(Expectation.SOMETIMES, "both delivered",
               exists_actor(lambda i, s: s == 2))
    return m


def test_ordered_duplicate_ranks_need_the_depth_knob():
    """An ordered flow holding the same message at two ranks outgrows a
    default region (capacity = distinct codes): the init state refuses to
    encode, loudly; ``per_channel_depth`` restores the slot-multiset
    counts (``tests/test_per_channel.py:410``)."""
    kw = dict(device="cpu", capacity=1 << 8, batch=8)
    ms = resender_model(False).checker().spawn_gpu(**kw).join()
    with pytest.raises(ValueError, match="exceeding its region capacity"):
        resender_model(True).checker().spawn_gpu(**kw)
    pc = resender_model(True, depth=2).checker().spawn_gpu(**kw).join()
    assert (pc.state_count(), pc.unique_state_count()) == (
        ms.state_count(), ms.unique_state_count())
    assert sorted(pc.discoveries()) == sorted(ms.discoveries()) == [
        "both delivered"]


@dataclass
class GossipingServer(Actor):
    def on_start(self, id, out):
        return NULL_VALUE

    def on_msg(self, id, state, src, msg, out):
        if msg[0] == "put" and state == NULL_VALUE:
            out.send(src, PutOk(msg[1]))
            out.send(Id(1), PutOk(msg[1]))  # relayed to a server
            return msg[2]
        if msg[0] == "get" and state != NULL_VALUE:
            out.send(src, GetOk(msg[1], state))
            return state
        return None


def test_ret_kind_envelope_to_a_server_skips_history():
    """A put_ok relayed to another server must not touch the history
    fields (``tests/test_per_channel.py:536``): both packings give the same
    run."""
    def build(pc):
        class M(TensorBackedModel, ActorModel):
            def tensor_model(self):
                return compile_actor_model(self, per_channel=pc)

        m = M(cfg=None,
              init_history=LinearizabilityTester(Register(NULL_VALUE)))
        m.actor(GossipingServer())
        m.actor(GossipingServer())
        m.actor(RegisterClient(put_count=1, server_count=2))
        m.init_network_(Network.new_unordered_nonduplicating())
        m.property(Expectation.ALWAYS, "linearizable",
                   lambda model, s: s.history.is_consistent())
        m.property(Expectation.SOMETIMES, "value chosen", value_chosen)
        m.record_msg_in(record_returns)
        m.record_msg_out(record_invocations)
        return m

    tm = build(True).tensor_model()
    relayed = [ci for ci, (_s, d) in enumerate(tm._channels)
               if d == 1 and (tm._env_kind[tm._ch_codes[ci]] != 0).any()]
    assert relayed and not any(tm._ch_ret_kind[ci] for ci in relayed)
    kw = dict(device="cpu", capacity=1 << 10, batch=16)
    a = build(False).checker().spawn_gpu(**kw).join()
    b = build(True).checker().spawn_gpu(**kw).join()
    assert (a.state_count(), a.unique_state_count()) == (
        b.state_count(), b.unique_state_count())
    assert sorted(a.discoveries()) == sorted(b.discoveries())


def paxos3_bounds():
    return dict(
        state_bound=lambda i, s: not isinstance(s, PaxosState)
        or s.ballot[0] <= 3,
        env_bound=lambda e: e.msg[0] != "internal" or e.msg[1][1][0] <= 3,
    )


def test_closure_estimate_trips_fast_on_per_channel_paxos3(monkeypatch):
    """The JAX compiler's fail-fast error, word for word, in under 20 s
    (``tests/test_sweep.py:551``)."""
    monkeypatch.delenv("STATERIGHT_TPU_CLOSURE_ESTIMATE", raising=False)
    m = per_channel(paxos_model(3, 3))
    t0 = time.monotonic()
    with pytest.raises(CompileError, match="pre-closure estimate") as err:
        compile_actor_model(m, **paxos3_bounds())
    assert time.monotonic() - t0 < 20
    assert str(err.value) == P3_ESTIMATE_MESSAGE


def test_closure_estimate_escape_hatch(monkeypatch):
    """With the estimate off a legitimate closure compiles as before
    (per-channel paxos-2, the benchmark leg), and the fixed cap still
    stops a runaway one with its own message."""
    monkeypatch.setenv("STATERIGHT_TPU_CLOSURE_ESTIMATE", "off")
    tm = per_channel(paxos_model(2, 3)).tensor_model()
    assert isinstance(tm, CompiledActorTensor)
    assert tm.width == 83
    with pytest.raises(CompileError, match="exceeded 500; tighten"):
        compile_actor_model(per_channel(paxos_model(3, 3)),
                            max_states_per_actor=500, **paxos3_bounds())
