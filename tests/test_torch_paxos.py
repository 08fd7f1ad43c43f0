"""The port's paxos slice (``stateright_tpu_torch.models.paxos`` and its
twin ``PaxosTensor``) against the JAX package, tolerance 0:

 - the host bridge and the object model on every reachable paxos-1 state
   (the port of ``tests/test_paxos_tensor.py::crawl_and_check``): row
   encodings, round trips, fingerprints, successor sets, action lists and
   property verdicts;
 - ``step_rows``/``property_masks`` against the JAX twin on the rows of
   every paxos-1 state and of the first 6 BFS levels of paxos-2;
 - the engine (``spawn_gpu(device="cpu")``) against ``spawn_tpu(sync=True)``
   at the same capacities: counts, discoveries and traces, table bytes and
   queue rows, at paxos-1 (with growth) and paxos-2 (16,668 unique);
 - snapshots carried across the two engines both ways;
 - the object model off the hand-written twin (the duplicating network,
   a lossy network, four servers), in lockstep with the JAX object model.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from stateright_tpu.fingerprint import hash_words as jax_hash_words
from stateright_tpu.models.paxos import paxos_model as jax_paxos_model
from stateright_tpu_torch.actor import Network
from stateright_tpu_torch.fingerprint import hash_words
from stateright_tpu_torch.models import paxos as port_paxos
from stateright_tpu_torch.models.paxos import paxos_model
from stateright_tpu_torch.models.paxos_tensor import PaxosTensor
from stateright_tpu_torch.ops.hashing import row_hash
from test_torch_engine import assert_same_run

# paxos-1 at these capacities grows the table once and the queue's batch
# is small enough for several blocks
P1 = dict(capacity=1 << 10, batch=1 << 4)


def bfs_levels(model, max_levels=None):
    """BFS of the object form: a list of levels of (fingerprint, state)."""
    seen = set()
    level = []
    for s in model.init_states():
        fp = model.fingerprint_state(s)
        if fp not in seen:
            seen.add(fp)
            level.append(s)
    levels = []
    while level and (max_levels is None or len(levels) < max_levels):
        levels.append(level)
        nxt = []
        for s in level:
            for t in model.next_states(s):
                fp = model.fingerprint_state(t)
                if fp not in seen:
                    seen.add(fp)
                    nxt.append(t)
        level = nxt
    return levels


def as_rows(tm, states) -> np.ndarray:
    return np.asarray([tm.encode_state(s) for s in states], np.uint64)


@pytest.fixture(scope="module")
def jax_models():
    """One JAX model per client count for the whole file: the JAX engine
    compiles its step once per model object, and that compile is most of a
    small run's time on the CPU."""
    return {n: jax_paxos_model(n, 3) for n in (1, 2)}


@pytest.fixture(scope="module")
def p1(jax_models):
    m, jm = paxos_model(1), jax_models[1]
    states = [s for lvl in bfs_levels(m) for s in lvl]
    return m, jm, states, as_rows(m.tensor_model(), states)


@pytest.fixture(scope="module")
def p2_prefix(jax_models):
    m, jm = paxos_model(2), jax_models[2]
    states = [s for lvl in bfs_levels(m, 6) for s in lvl]
    return m, jm, states, as_rows(m.tensor_model(), states)


def test_host_bridge_and_object_model_match_jax_on_paxos1(p1):
    """Per reachable state: the row equals the JAX twin's, decodes back to
    the state on both sides, and the host fingerprint equals the device
    row hash; the port's object model enables the same actions (by repr)
    and reaches the same successor rows as the JAX object model, and every
    property condition agrees."""
    m, jm, states, rows = p1
    assert len(states) == 265
    tm, jtm = m.tensor_model(), jm.tensor_model()
    assert (tm.pk.layout, tm.width, tm.max_actions) == (
        jtm.pk.layout, jtm.width, jtm.max_actions)
    fps = row_hash(torch.from_numpy(rows.view(np.int64))).numpy()
    for s, row, fp in zip(states, rows, fps.view(np.uint64)):
        words = tuple(int(w) for w in row)
        js = jtm.decode_state(row)
        assert jtm.encode_state(js) == words
        assert tm.decode_state(row) == s
        assert tm.decode_state(row.view(np.int64)) == s  # device read-back
        assert m.fingerprint_state(s) == hash_words(words) == int(fp)
        assert jm.fingerprint_state(js) == jax_hash_words(words) == int(fp)
        # the same actions (their order follows the network's dict order,
        # which a decoded state does not share with a reached one)
        assert (sorted(repr(a) for a in m.actions(s))
                == sorted(repr(a) for a in jm.actions(js)))
        assert (sorted(tm.encode_state(t) for t in m.next_states(s))
                == sorted(jtm.encode_state(t) for t in jm.next_states(js)))
        for p, jp in zip(m.properties(), jm.properties()):
            assert p.name == jp.name
            assert bool(p.condition(m, s)) == bool(jp.condition(jm, js))


def check_twin_against_jax(m, jm, states, rows, object_model: bool):
    tm, jtm = m._tensor_cached(), jm._tensor_cached()
    jtm.init_rows()  # a compiled JAX twin builds its device tables here
    trows = torch.from_numpy(rows.view(np.int64))
    succ, valid = tm.step_rows(trows)
    # jitted as the JAX engine runs it: one compile instead of one per op
    jsucc, jvalid = jax.jit(jtm.step_rows)(jnp.asarray(rows))
    succ, valid = succ.numpy().view(np.uint64), valid.numpy()
    jsucc, jvalid = np.asarray(jsucc), np.asarray(jvalid)
    assert succ.shape == jsucc.shape == (len(rows), tm.max_actions, tm.width)
    np.testing.assert_array_equal(valid, jvalid)
    np.testing.assert_array_equal(succ[valid], jsucc[jvalid])
    masks = tm.property_masks(trows).numpy()
    np.testing.assert_array_equal(
        masks, np.asarray(jax.jit(jtm.property_masks)(jnp.asarray(rows))))
    if object_model:
        for i, s in enumerate(states):
            dev = sorted(tuple(int(w) for w in succ[i, a])
                         for a in range(tm.max_actions) if valid[i, a])
            assert dev == sorted(tm.encode_state(t) for t in m.next_states(s))
            for p, prop in enumerate(m.properties()):
                assert bool(masks[i, p]) == bool(prop.condition(m, s))
    return valid, masks


def test_step_rows_and_masks_match_jax_twin_on_paxos1(p1):
    m, jm, states, rows = p1
    valid, masks = check_twin_against_jax(m, jm, states, rows, True)
    assert masks[:, 1].any() and masks[:, 0].all()  # chosen; linearizable


def test_step_rows_and_masks_match_jax_twin_on_paxos2_prefix(p2_prefix):
    """The first 6 BFS levels of paxos-2 (puts, prepare/prepared quorums,
    accepts and the first decisions)."""
    m, jm, states, rows = p2_prefix
    assert len(states) == 103
    valid, _ = check_twin_against_jax(m, jm, states, rows, False)
    assert valid.sum() > len(states)


def test_step_rows_and_masks_match_jax_twin_on_paxos3_prefix():
    """Paxos-3 rows (W = 33, A = 30).  Every row also runs the lanes no
    branch takes: ``(la - 1) % C`` with la = 0 (floor mod in both
    libraries) and the server and client gathers at a clamped dst."""
    m, jm = paxos_model(3), jax_paxos_model(3, 3)
    tm = m.tensor_model()
    assert (tm.width, tm.max_actions) == (33, 30)
    states = [s for lvl in bfs_levels(m, 4) for s in lvl]
    check_twin_against_jax(m, jm, states, as_rows(tm, states), False)


def run_pair(jm, n, bound=None, **kw):
    jb = jm.checker()
    pb = paxos_model(n).checker()
    if bound is not None:
        jb, pb = jb.target_states(bound), pb.target_states(bound)
    j = jb.spawn_tpu(sync=True, capacity=kw["capacity"],
                     frontier_capacity=kw["batch"])
    t = pb.spawn_gpu(device="cpu", **kw).join()
    return j, t


def assert_same_queue(j, t):
    js, ts = j.checkpoint(), t.final_snapshot()
    tail = int(ts["tail"])
    assert int(js["tail"]) == tail and int(js["head"]) == int(ts["head"])
    for k in ("q_rows", "q_fp", "q_ebits", "q_depth"):
        np.testing.assert_array_equal(np.asarray(ts[k])[:tail],
                                      np.asarray(js[k])[:tail], err_msg=k)


@pytest.fixture(scope="module")
def p1_runs(jax_models):
    """(JAX, port) runs of paxos-1: complete, and bounded at 120 unique."""
    jm = jax_models[1]
    return run_pair(jm, 1, **P1), run_pair(jm, 1, 120, **P1)


@pytest.mark.parametrize(
    "n,unique,states", [(1, 265, 482), (2, 16668, 32971)],
)
def test_engine_matches_jax_engine(jax_models, p1_runs, n, unique, states):
    if n == 1:
        j, t = p1_runs[0]
    else:
        j, t = run_pair(jax_models[2], 2, capacity=1 << 16, batch=1 << 8)
    assert t.unique_state_count() == unique and t.state_count() == states
    assert_same_run(j, t)
    assert t.growth_events == j.growth_events and t.growth_events
    assert_same_queue(j, t)
    assert set(t.discoveries()) == {"value chosen"}
    t.assert_properties()
    path = t.discovery("value chosen")
    assert t.model.property_by_name("value chosen").condition(
        t.model, path.final_state())
    assert ([repr(a) for a in path.actions()]
            == [repr(a) for a in j.discovery("value chosen").actions()])


def test_bounded_run_queue_matches_jax_engine(p1_runs):
    """Stopped by ``target_states`` with rows still queued."""
    j, t = p1_runs[1]
    assert 120 <= t.unique_state_count() < 265
    assert int(t.final_snapshot()["tail"]) > int(t.final_snapshot()["head"])
    assert_same_run(j, t)
    assert_same_queue(j, t)


def test_port_resumes_jax_snapshot_and_jax_resumes_port_snapshot(
        jax_models, p1_runs):
    (full_j, full_t), (jb, tb) = p1_runs
    # the port finishes the JAX engine's space ...
    t = paxos_model(1).checker().spawn_gpu(
        device="cpu", resume=jb.checkpoint()).join()
    assert t.unique_state_count() == 265
    assert_same_run(full_j, t)
    # ... and the JAX engine the port's
    j = jax_models[1].checker().spawn_tpu(
        sync=True, resume=tb.final_snapshot())
    assert j.unique_state_count() == 265
    assert_same_run(j, full_t)


@pytest.mark.parametrize("network,lossy,servers", [
    ("unordered_duplicating", False, 3),
    ("unordered_nonduplicating", True, 3),
    ("unordered_nonduplicating", False, 4),
])
def test_object_model_matches_jax_in_lockstep(network, lossy, servers):
    """Configurations off the hand-written twin: the port's and the JAX
    object model walked in lockstep for 7 BFS levels give the same actions
    in the same order and the same fingerprints — structural ones on the
    duplicating network, which has no twin in either package (the
    networks, the tester and the actor states hash alike), and the
    compiled twins' row hashes on the others."""
    from stateright_tpu.actor import Network as JaxNetwork
    from stateright_tpu.fingerprint import fingerprint as jax_fingerprint

    m = paxos_model(1, servers, Network.from_name(network))
    jm = jax_paxos_model(1, servers, JaxNetwork.from_name(network))
    if lossy:
        m.lossy_network(True)
        jm.lossy_network(True)
    assert (m.tensor_model() is None) == (network == "unordered_duplicating")
    assert (jm.tensor_model() is None) == (m.tensor_model() is None)
    level = list(zip(m.init_states(), jm.init_states()))
    seen = set()
    for _ in range(7):
        nxt = []
        for s, js in level:
            steps, jsteps = m.next_steps(s), jm.next_steps(js)
            assert [repr(a) for a, _ in steps] == [repr(a) for a, _ in jsteps]
            for (_, t), (_, jt) in zip(steps, jsteps):
                fp = m.fingerprint_state(t)
                assert fp == jm.fingerprint_state(jt)
                if m.tensor_model() is None:
                    assert fp == jax_fingerprint(jt)
                for p, jp in zip(m.properties(), jm.properties()):
                    assert p.condition(m, t) == jp.condition(jm, jt)
                if fp not in seen:
                    seen.add(fp)
                    nxt.append((t, jt))
        level = nxt
    assert len(seen) > 30


def test_configurations_without_a_twin_raise():
    """The benchmark configuration has the hand-written twin; four
    servers and a lossy network compile (``_compiled_tensor``); the
    duplicating network has no twin, and ``spawn_gpu`` raises."""
    from stateright_tpu_torch.parallel.actor_compiler import (
        CompiledActorTensor,
    )

    assert isinstance(paxos_model(2).tensor_model(), PaxosTensor)
    for m in (paxos_model(1, 4), paxos_model(1).lossy_network(True)):
        assert isinstance(m.tensor_model(), CompiledActorTensor)
    m = paxos_model(1, 3, Network.new_unordered_duplicating())
    assert m.tensor_model() is None
    with pytest.raises(TypeError, match="no tensor form"):
        m.checker().spawn_gpu(device="cpu")
    m = paxos_model(1)
    m.fingerprint_state(m.init_states()[0])
    with pytest.raises(RuntimeError, match="configuration changed"):
        m.lossy_network(True)


def test_check_gpu_verb_raises_without_a_card(capsys, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the verb would run")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_paxos.main(["check-gpu", "1"])
    # the spawn verb deploys three servers (the UDP runtime, stubbed here
    # so the verb does not block); an unknown verb prints the usage
    deployed = []
    monkeypatch.setattr("stateright_tpu_torch.actor.spawn",
                        lambda actors, background=True: deployed.append(
                            (list(actors), background)) or [])
    assert port_paxos.main(["spawn"]) == 0
    assert len(deployed[0][0]) == 3 and deployed[0][1] is False
    assert port_paxos.main(["no-such-verb"]) == 2
    assert "usage" in capsys.readouterr().err
