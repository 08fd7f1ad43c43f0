"""The port's actor compiler (``stateright_tpu_torch.parallel.actor_compiler``)
and its register workloads against the JAX package, tolerance 0:

 - the history codec: round trips and verdicts, both strategies;
 - the two compilers' ``init_rows()``, state and envelope universes and
   code tables, equal for every compiled configuration here;
 - ``step_rows``/``property_masks`` against the JAX compiled twin on the
   rows of crawled levels (single-copy(2,1) all 93 states, ABD(2,2) 5
   levels, ordered ABD(2,2) 6 levels), and on rows with free, full and
   out-of-universe slots;
 - the engine (``spawn_gpu(device="cpu")``) against
   ``spawn_tpu(sync=True)`` at the same capacities: counts, discoveries and
   traces, table bytes and queue rows;
 - the models outside the compilable fragment raise ``CompileError``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stateright_tpu.actor import Network as JaxNetwork
from stateright_tpu.models.linearizable_register import abd_model as jax_abd
from stateright_tpu.models.paxos import paxos_model as jax_paxos
from stateright_tpu.models.single_copy_register import (
    single_copy_model as jax_single_copy,
)
from stateright_tpu.parallel.history_tensor import (
    LinHistoryCodec as JaxLinHistoryCodec,
)
from stateright_tpu_torch.actor import Network
from stateright_tpu_torch.actor.device_props import exists_actor, forall_actors
from stateright_tpu_torch.actor.register import NULL_VALUE
from stateright_tpu_torch.core import Expectation
from stateright_tpu_torch.models import linearizable_register as port_abd
from stateright_tpu_torch.models import single_copy_register as port_sc
from stateright_tpu_torch.models.linearizable_register import abd_model
from stateright_tpu_torch.models.paxos import paxos_model
from stateright_tpu_torch.models.paxos_tensor import PaxosTensor
from stateright_tpu_torch.models.single_copy_register import single_copy_model
from stateright_tpu_torch.parallel.actor_compiler import (
    CompileError,
    CompiledActorTensor,
    compile_actor_model,
)
from stateright_tpu_torch.parallel.history_tensor import (
    PHASE_W_DONE,
    LinHistoryCodec,
)
from stateright_tpu_torch.semantics import LinearizabilityTester
from stateright_tpu_torch.semantics.register import READ, Register, write
from test_torch_engine import assert_same_run
from test_torch_paxos import (
    as_rows,
    assert_same_queue,
    bfs_levels,
    check_twin_against_jax,
)

WRITE_FAIL = (("write_ok",), ("write_fail",))


# ---------------------------------------------------------------------------
# history codec
# ---------------------------------------------------------------------------


def joint_testers(tester_cls, register_cls, write_rets):
    """Every joint tester state of two threads (3 and 4) writing A and B,
    under every interleaving of invoke/return events."""
    t = tester_cls(register_cls("\0"))
    t = t.on_invoke(3, write("A")).on_invoke(4, write("B"))
    out, frontier, seen = [], [t], {t}
    while frontier:
        cur = frontier.pop()
        out.append(cur)
        for thread in (3, 4):
            infl = cur.in_flight_by_thread.get(thread)
            comp = cur.history_by_thread.get(thread, ())
            if infl is not None and infl[1] == READ:
                nxts = [cur.on_return(thread, ("read_ok", v))
                        for v in ("\0", "A", "B")]
            elif infl is not None:
                nxts = [cur.on_return(thread, r) for r in write_rets]
            elif len(comp) == 1:
                nxts = [cur.on_invoke(thread, READ)]
            else:
                nxts = []
            for n in nxts:
                if n not in seen:
                    seen.add(n)
                    frontier.append(n)
    return out


@pytest.mark.parametrize("write_rets,strategy,states", [
    ((("write_ok",),), "closure", 124),
    (WRITE_FAIL, "table", 473),
])
def test_history_codec_roundtrip_and_verdicts(write_rets, strategy, states):
    """Both strategies (the port of ``tests/test_actor_compiler.py:29``):
    every joint tester state round-trips through its fields, its key is in
    the table with the live tester's verdict, the table equals the JAX
    codec's, and the device lookup reads it back."""
    hc = LinHistoryCodec([3, 4], ["A", "B"], "\0", write_rets=write_rets)
    jc = JaxLinHistoryCodec([3, 4], ["A", "B"], "\0", write_rets=write_rets)
    assert hc.strategy == jc.strategy == strategy
    hc.ensure_table()
    jc.ensure_table()
    np.testing.assert_array_equal(hc.table_keys, jc.table_keys)
    np.testing.assert_array_equal(hc.table_ok, jc.table_ok)
    testers = joint_testers(LinearizabilityTester, Register, write_rets)
    assert len(testers) == len(hc.table_keys) == states
    keys = []
    for cur in testers:
        fields = hc.fields_of_tester(cur)
        assert hc.tester_of_fields(fields) == cur
        key = hc.key_of_fields(fields)
        i = int(np.searchsorted(hc.table_keys, key))
        assert hc.table_keys[i] == key
        assert bool(hc.table_ok[i]) == cur.is_consistent()
        keys.append(key)
    keys = np.asarray(keys, np.int64)
    absent = keys + (1 << 40)  # no joint state has these keys
    got = hc.device_lookup(torch.from_numpy(np.concatenate([keys, absent])))
    want = np.asarray(jc.device_lookup(jnp.asarray(
        np.concatenate([keys, absent]))))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got[len(keys):].any()
    assert 0 < int(got.sum()) < len(keys)  # both verdicts occur


@pytest.mark.parametrize("C", [1, 2, 3])
def test_closure_verdict_agrees_with_jax_and_the_table(C):
    """The closure strategy on every enumerated joint state a stored row
    can hold (phase 3 is only an intermediate of the enumeration): the
    port's ``device_verdict`` equals the JAX codec's and the exact verdict
    of the enumerated table."""
    threads = list(range(10, 10 + C))
    values = [chr(65 + i) for i in range(C)]
    hc = LinHistoryCodec(threads, values, "\0")
    jc = JaxLinHistoryCodec(threads, values, "\0")
    hc.ensure_table()
    jc.ensure_table()
    np.testing.assert_array_equal(hc.table_keys, jc.table_keys)
    np.testing.assert_array_equal(hc.table_ok, jc.table_ok)
    tb = hc.thread_bits
    words = (hc.table_keys[:, None] >> (np.arange(C) * tb)) & ((1 << tb) - 1)
    phase = words & 3
    snap = (words >> 2) & ((1 << hc.snap_bits) - 1)
    rval = (words >> (2 + hc.snap_bits)) & 7
    stored = (phase != PHASE_W_DONE).all(axis=1)
    got = hc.device_verdict(*(torch.from_numpy(x[stored])
                              for x in (phase, snap, rval))).numpy()
    want = np.asarray(jc.device_verdict(*(jnp.asarray(x[stored].astype(np.int32))
                                          for x in (phase, snap, rval))))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, hc.table_ok[stored])


def test_history_codec_rejects_too_many_threads():
    with pytest.raises(ValueError, match="at most 4"):
        LinHistoryCodec(list(range(5)), list("ABCDE"), "\0",
                        write_rets=WRITE_FAIL)
    with pytest.raises(ValueError, match="at most 7"):
        LinHistoryCodec(list(range(8)), list("ABCDEFGH"), "\0")


# ---------------------------------------------------------------------------
# the compilers' tables
# ---------------------------------------------------------------------------


def pair(name):
    """(port model, JAX model) of one configuration."""
    nets = {"ordered": (Network.new_ordered, JaxNetwork.new_ordered),
            "dup": (Network.new_unordered_duplicating,
                    JaxNetwork.new_unordered_duplicating)}
    kind, *args = name.split("-")
    net = args.pop() if args and args[-1] in nets else None
    args = [int(a) for a in args]
    pn, jn = (None, None) if net is None else (nets[net][0](), nets[net][1]())
    if kind == "sc":
        return single_copy_model(*args, pn), jax_single_copy(*args, jn)
    if kind == "abd":
        return abd_model(*args, pn), jax_abd(*args, jn)
    if kind == "paxos":
        return paxos_model(*args, pn), jax_paxos(*args, jn)
    raise ValueError(name)


def assert_same_compile(tm, jtm):
    assert (tm.pk.layout, tm.width, tm.max_actions, tm.K, tm.Kt,
            tm._has_timers, tm.n_slots) == (
        jtm.pk.layout, jtm.width, jtm.max_actions, jtm.K, jtm.Kt,
        jtm._has_timers, jtm.n_slots)
    assert [[repr(s) for s in u] for u in tm._states] == [
        [repr(s) for s in u] for u in jtm._states]
    assert [repr(e) for e in tm._envs] == [repr(e) for e in jtm._envs]
    for name in ("_trans_np", "_sends_np", "_poison_np", "_teff_np",
                 "_ttrans_np", "_tsends_np", "_tpoison_np", "_tbit_np"):
        for a, b in zip(getattr(tm, name), getattr(jtm, name), strict=True):
            np.testing.assert_array_equal(a, b, err_msg=name)
    for name in ("_env_dst", "_env_pair", "_env_kind", "_env_val",
                 "_env_chosen", "_client_of"):
        np.testing.assert_array_equal(getattr(tm, name), getattr(jtm, name),
                                      err_msg=name)
    assert len(tm._prop_tables) == len(jtm._prop_tables)
    for a, b in zip(tm._prop_tables, jtm._prop_tables):
        assert (a is None) == (b is None)
        if a is not None:
            assert a[0] == b[0]
            ta, tb = a[1], b[1]
            keys = range(len(ta)) if isinstance(ta, list) else ta.keys()
            for k in keys:
                np.testing.assert_array_equal(ta[k], tb[k])
    np.testing.assert_array_equal(tm.init_rows(), jtm.init_rows())


@pytest.mark.parametrize("name", [
    "sc-2-1", "sc-4-1", "sc-2-1-dup", "sc-2-2-ordered", "abd-2-2",
    "abd-3-2-ordered", "paxos-1-3-ordered", "paxos-1-4",
])
def test_init_rows_and_code_tables_equal_jax(name):
    """Both compilers number local states and envelopes in the same order,
    so every table, layout and init row is equal, bit for bit.  ``sc-4-1``
    and ``abd-3-2-ordered`` are the reference bench's single-copy-4 and
    lin-reg-3-ordered."""
    m, jm = pair(name)
    tm, jtm = m.tensor_model(), jm.tensor_model()
    assert isinstance(tm, CompiledActorTensor)
    assert_same_compile(tm, jtm)
    if name == "sc-4-1":
        assert (tm.width, tm.max_actions) == (21, 20)
    if name == "abd-3-2-ordered":
        assert (tm.width, tm.max_actions) == (21, 20)
        assert [len(u) for u in tm._states[:2]] == [253, 243]
        assert len(tm._envs) == 135


# ---------------------------------------------------------------------------
# step_rows / property_masks on crawled levels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,levels,count", [
    ("sc-2-1", None, 93),
    ("abd-2-2", 5, None),
    ("abd-2-2-ordered", 6, None),
    ("sc-2-2", None, None),
    ("sc-1-1-dup", None, None),
])
def test_step_rows_and_masks_match_jax_on_crawled_levels(name, levels, count):
    """Every row of the crawled levels: successors, validity and property
    masks equal the JAX twin's, and the valid successors equal the
    encodings of the object model's ``next_states`` (with the property
    conditions)."""
    m, jm = pair(name)
    states = [s for lvl in bfs_levels(m, levels) for s in lvl]
    if count is not None:
        assert len(states) == count
    valid, masks = check_twin_against_jax(
        m, jm, states, as_rows(m._tensor_cached(), states), True)
    assert valid.any()


def odd_rows(tm, rows: np.ndarray) -> dict:
    """Rows built to reach every masked lane: all slots free, every slot
    full of in-universe codes, and (below) codes and actor states past
    the universes."""
    rows = rows.copy()
    empty = rows.copy()
    empty[:, tm.pw:] = np.uint64(0xFFFFFFFFFFFFFFFF)
    full = rows.copy()
    ne = len(tm._envs)
    for r in range(len(full)):
        codes = (np.arange(tm.n_slots) + r) % ne
        words = (codes.astype(np.uint64) << np.uint64(6)) | np.uint64(1)
        full[r, tm.pw:] = np.sort(words)
    wild = rows.copy()
    wild[:, -1] = np.uint64(((ne + 5) << 6) | 1)
    wild[:, -2] = np.uint64((((1 << 57) | 3) << 6) | 2)  # top bit set
    for i in range(tm.n_actors):  # every actor field at its all-ones code
        w, o, b = tm.pk.layout[f"a{i}"]
        wild[:, w] |= np.uint64(((1 << b) - 1) << o)
    return dict(empty=empty, full=full, wild=wild)


@pytest.mark.parametrize("name", ["sc-2-1", "abd-2-2-ordered", "sc-1-1-dup"])
def test_step_rows_stay_in_range_on_free_full_and_foreign_slots(name):
    """Free and full slot rows give the JAX twin's successors, validity and
    masks; rows with envelope codes and actor states past their universes
    (which no run reaches) still run: every gather is in range."""
    m, jm = pair(name)
    tm, jtm = m.tensor_model(), jm.tensor_model()
    jtm.init_rows()  # the JAX twin builds its device tables here
    states = [s for lvl in bfs_levels(m, 3) for s in lvl]
    rows = as_rows(tm, states)
    cases = odd_rows(tm, rows)
    for case in ("empty", "full"):
        r = cases[case]
        succ, valid = tm.step_rows(torch.from_numpy(r.view(np.int64)))
        jsucc, jvalid = jtm.step_rows(jnp.asarray(r))
        valid, jvalid = valid.numpy(), np.asarray(jvalid)
        np.testing.assert_array_equal(valid, jvalid, err_msg=case)
        np.testing.assert_array_equal(succ.numpy().view(np.uint64)[valid],
                                      np.asarray(jsucc)[jvalid], err_msg=case)
        np.testing.assert_array_equal(
            tm.property_masks(torch.from_numpy(r.view(np.int64))).numpy(),
            np.asarray(jtm.property_masks(jnp.asarray(r))), err_msg=case)
    wild = torch.from_numpy(cases["wild"].view(np.int64))
    succ, valid = tm.step_rows(wild)
    assert succ.shape == (len(rows), tm.max_actions, tm.width)
    assert tm.property_masks(wild).shape == (len(rows), len(m.properties()))


# ---------------------------------------------------------------------------
# engine parity
# ---------------------------------------------------------------------------


def engine_pair(m, jm, capacity, batch):
    j = jm.checker().spawn_tpu(sync=True, capacity=capacity,
                               frontier_capacity=batch)
    t = m.checker().spawn_gpu(device="cpu", capacity=capacity,
                              batch=batch).join()
    assert_same_run(j, t)
    assert t.growth_events == j.growth_events
    assert_same_queue(j, t)
    assert sorted(t.discoveries()) == sorted(j.discoveries())
    for name, path in t.discoveries().items():
        assert ([repr(a) for a in path.actions()]
                == [repr(a) for a in j.discovery(name).actions()])
    return t


@pytest.mark.parametrize("name,capacity,batch,unique,disc", [
    ("sc-2-1", 1 << 10, 1 << 7, 93, ["value chosen"]),
    ("sc-2-2", 1 << 10, 1 << 7, None, ["linearizable", "value chosen"]),
    ("abd-2-2", 1 << 12, 1 << 9, 544, ["value chosen"]),
    ("abd-2-2-ordered", 1 << 12, 1 << 9, None, ["value chosen"]),
    ("sc-2-1-dup", 1 << 10, 1 << 5, None, ["linearizable", "value chosen"]),
    ("paxos-1-3-ordered", 1 << 10, 1 << 5, 99, ["value chosen"]),
    # small enough to grow the table and the queue mid-run
    ("abd-2-2", 1 << 6, 1 << 3, 544, ["value chosen"]),
])
def test_engine_matches_jax_engine(name, capacity, batch, unique, disc):
    m, jm = pair(name)
    t = engine_pair(m, jm, capacity, batch)
    if unique is not None:
        assert t.unique_state_count() == unique
    assert sorted(t.discoveries()) == disc
    for d, path in t.discoveries().items():
        cond = m.property_by_name(d).condition(m, path.final_state())
        assert cond == (d == "value chosen")
    if "linearizable" in disc:
        # a real counterexample: the replayed history is not linearizable
        final = t.discovery("linearizable").final_state()
        assert not final.history.is_consistent()
    if capacity < 1 << 7:
        assert t.growth_events


def test_lossy_ordered_single_copy_matches_jax_engine():
    """Drops remove flow heads only (the object model enumerates Drop
    over the deliverable envelopes)."""
    m, jm = pair("sc-1-1-ordered")
    m.lossy_network(True)
    jm.lossy_network(True)
    t = engine_pair(m, jm, 1 << 10, 1 << 5)
    assert m.tensor_model().max_actions == 2 * 16
    assert t.unique_state_count() == jm.checker().spawn_bfs().join(
    ).unique_state_count()


def test_compiled_paxos1_equals_hand_twin_and_jax():
    """paxos-1 through the compiler: 265 unique / 482 states, the
    hand-written ``PaxosTensor``'s counts and discoveries, and the JAX
    compiled twin's run bit for bit."""
    hand = paxos_model(1)
    assert isinstance(hand.tensor_model(), PaxosTensor)
    h = hand.checker().spawn_gpu(device="cpu", capacity=1 << 12,
                                 batch=1 << 9).join()
    m, jm = paxos_model(1), jax_paxos(1, 3)
    for model in (m, jm):
        object.__setattr__(model, "_tensor_model_cache",
                           model._compiled_tensor(1))
    assert isinstance(m._tensor_cached(), CompiledActorTensor)
    t = engine_pair(m, jm, 1 << 12, 1 << 9)
    assert h.unique_state_count() == t.unique_state_count() == 265
    assert h.state_count() == t.state_count() == 482
    assert set(h.discoveries()) == set(t.discoveries()) == {"value chosen"}


def test_register_workload_accepts_extra_factored_properties():
    """The two standard properties plus factored extras, tabulated on the
    device and evaluated directly on the host."""
    from stateright_tpu.actor.device_props import (
        exists_actor as jax_exists,
        forall_actors as jax_forall,
    )
    from stateright_tpu.core import Expectation as JaxExpectation

    def build(model, expectation, fa, ea):
        m = model(2, 1)
        m.property(expectation.ALWAYS, "server value known",
                   fa(lambda i, s: i != 0 or s in (NULL_VALUE, "A", "B")))
        m.property(expectation.SOMETIMES, "server took a write",
                   ea(lambda i, s: i == 0 and s in ("A", "B")))
        return m

    m = build(single_copy_model, Expectation, forall_actors, exists_actor)
    jm = build(jax_single_copy, JaxExpectation, jax_forall, jax_exists)
    t = engine_pair(m, jm, 1 << 13, 1 << 7)
    assert t.unique_state_count() == 93
    assert sorted(t.discoveries()) == ["server took a write", "value chosen"]


# ---------------------------------------------------------------------------
# what waits
# ---------------------------------------------------------------------------


def test_what_waits_raises_compile_error():
    """put_count >= 2 and the write-once recorders compile now
    (``test_torch_multi_op.py``, ``test_torch_write_once.py``); any other
    recorder, an opaque property and an opaque boundary still raise."""
    assert isinstance(compile_actor_model(single_copy_model(2, 1,
                                                            put_count=2)),
                      CompiledActorTensor)
    m = single_copy_model(2, 1)
    m.record_msg_in(lambda cfg, h, env: None)
    with pytest.raises(CompileError, match="write-once"):
        compile_actor_model(m)
    m = single_copy_model(2, 1)
    m.record_msg_out(lambda cfg, h, env: None)
    with pytest.raises(CompileError, match="record_invocations"):
        compile_actor_model(m)
    m = single_copy_model(2, 1)
    m.property(Expectation.ALWAYS, "opaque", lambda mm, s: True)
    with pytest.raises(CompileError, match="factored"):
        compile_actor_model(m)
    m = single_copy_model(2, 1)
    m.within_boundary_(lambda cfg, s: True)
    with pytest.raises(CompileError, match="within_boundary"):
        compile_actor_model(m)


def test_models_without_a_twin_raise():
    mixed = single_copy_model(2, 1)
    mixed.actors[-1].put_count = 2  # put counts must be uniform
    for m in (mixed,
              abd_model(1, 2, Network.new_unordered_duplicating()),
              paxos_model(1, 3, Network.new_unordered_duplicating())):
        assert m.tensor_model() is None
        with pytest.raises(TypeError, match="no tensor form"):
            m.checker().spawn_gpu(device="cpu")
    # the ordered and lossy paxos configurations compile
    assert isinstance(paxos_model(1).lossy_network(True).tensor_model(),
                      CompiledActorTensor)


def test_check_gpu_verbs_raise_without_a_card(capsys, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the verbs would run")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        single_copy_model(2).checker().spawn_gpu()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_sc.main(["check-gpu", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_abd.main(["check-gpu", "2", "ordered"])
    assert port_abd.main(["check-gpu", "1", "unordered_duplicating"]) == 1
    # the spawn verb deploys its server (the UDP runtime, stubbed here so
    # the verb does not block); an unknown verb prints the usage
    deployed = []
    monkeypatch.setattr("stateright_tpu_torch.actor.spawn",
                        lambda actors, background=True: deployed.append(
                            (list(actors), background)) or [])
    assert port_sc.main(["spawn"]) == 0
    assert len(deployed) == 1 and deployed[0][1] is False
    assert port_sc.main(["no-such-verb"]) == 2
    assert "usage" in capsys.readouterr().err
