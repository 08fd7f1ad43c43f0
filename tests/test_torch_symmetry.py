"""Symmetry reduction in the port against the JAX package, tolerance 0
everywhere (every compared value is an integer or an object):

 - ``RewritePlan``/``rewrite_value`` and ``TwoPhaseState.representative``
   on every reachable 2pc-4 state, and ``ActorModelState.representative``
   (the networks' ``rewrite``) on reachable raft-3 states, compared by
   their structural hash;
 - ``TwoPhaseTensor.representative_rows`` on seeded random valid rows;
 - the compiled twin's ``representative_rows`` and ``representative_key``
   on raft-3 rows;
 - ``bucket_plan_plain`` and ``bucket_insert`` with
   ``generation_order=True`` against the JAX ``bucket_insert`` on seeded
   candidates (duplicates, present fingerprints, a full bucket line,
   ``cand_overflow``);
 - the engine (``.symmetry().spawn_gpu(device="cpu")``) against the JAX
   engine (``spawn_tpu(sync=True)``) at the same capacities: unique and
   state counts, discoveries and their traces, the table bytes and queue
   rows ``[0, tail)``, for 2pc-5 (508), 2pc-7 (2,326 / 19,758), raft-3
   (2,926) in both network packings, and a run that grows mid-run; every
   discovery path replays and satisfies its property;
 - the device entry point's guards (no canonicalizer, ``symmetry_with``,
   visitors) and the ``check-sym`` verbs.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from stateright_tpu.fingerprint import stable_hash as jax_stable_hash
from stateright_tpu.models.raft import raft_model as jax_raft
from stateright_tpu.models.two_phase_commit import TwoPhaseSys as JaxSys
from stateright_tpu.ops import buckets as jb
from stateright_tpu.symmetry import RewritePlan as JaxPlan
from stateright_tpu_torch.fingerprint import stable_hash
from stateright_tpu_torch.models import raft as port_raft
from stateright_tpu_torch.models import two_phase_commit as port_2pc
from stateright_tpu_torch.models.paxos import paxos_model
from stateright_tpu_torch.models.raft import raft_model
from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
from stateright_tpu_torch.ops import buckets as tb
from stateright_tpu_torch.symmetry import RewritePlan, rewrite_value
from test_torch_plan_cases import GEN_CASES, gen_case


def reachable(model, limit=None):
    """Host BFS of the object form, up to ``limit`` states."""
    seen, order, i = set(), [], 0
    for s in model.init_states():
        fp = model.fingerprint_state(s)
        if fp not in seen:
            seen.add(fp)
            order.append(s)
    while i < len(order) and (limit is None or len(order) < limit):
        for t in model.next_states(order[i]):
            fp = model.fingerprint_state(t)
            if fp not in seen:
                seen.add(fp)
                order.append(t)
        i += 1
    return order[:limit]


def fields_2pc(s):
    return (s.rm_state, s.tm_state, s.tm_prepared, s.msgs)


# -- host symmetry ------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rewrite_plan_matches_jax(seed):
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 4, size=7).tolist()
    p, jp = RewritePlan.from_values_to_sort(vals), JaxPlan.from_values_to_sort(vals)
    assert p.mapping == jp.mapping
    assert p.reindex(list("abcdefg")) == jp.reindex(list("abcdefg"))
    keyed = RewritePlan.from_values_to_sort(vals, key=lambda v: -v)
    assert keyed.mapping == JaxPlan.from_values_to_sort(vals, key=lambda v: -v).mapping
    nested = ({1: (2, frozenset({3}))}, [0, {4}])
    assert rewrite_value(nested, p) == nested  # plain ints are not ids
    assert [int(p.rewrite_id(i)) for i in range(7)] == [
        int(jp.rewrite_id(i)) for i in range(7)]


def test_2pc_representative_matches_jax_on_every_reachable_state():
    m, jm = TwoPhaseSys(4), JaxSys(4)
    states = reachable(m)
    assert len(states) == 1568
    tm, jtm = m.tensor_model(), jm.tensor_model()
    for s in states:
        js = jtm.decode_state(tm.encode_state(s))  # the JAX form of s
        assert fields_2pc(s.representative()) == fields_2pc(js.representative())


def test_actor_representative_matches_jax_on_raft3_states():
    """``ActorModelState.representative`` through every rewrite hook (ids
    in actor states and envelopes, the network's ``rewrite``), compared by
    the two packages' structural hash of the results."""
    m, jm = raft_model(3), jax_raft(3)
    tm, jtm = m.tensor_model(), jm.tensor_model()
    states = reachable(m, 400)
    assert len(states) == 400
    for s in states:
        js = jtm.decode_state(tm.encode_state(s))
        assert stable_hash(s) == jax_stable_hash(js)
        assert stable_hash(s.representative()) == jax_stable_hash(
            js.representative())


# -- representative_rows -------------------------------------------------------


@pytest.mark.parametrize("n", [3, 5, 7])
def test_2pc_representative_rows_match_jax_on_random_rows(n):
    rng = np.random.default_rng(n)
    tm, jtm = TwoPhaseSys(n).tensor_model(), JaxSys(n).tensor_model()
    b = 500
    rows = [
        tm.packer.pack(
            rm=int((rng.integers(0, 4, n) << (2 * np.arange(n))).sum()),
            tm=int(rng.integers(0, 3)),
            tm_prepared=int(rng.integers(0, 1 << n)),
            msg_prepared=int(rng.integers(0, 1 << n)),
            msg_commit=int(rng.integers(0, 2)),
            msg_abort=int(rng.integers(0, 2)),
        )
        for _ in range(b)
    ]
    rows = np.asarray(rows, np.uint64)
    got = tm.representative_rows(torch.from_numpy(rows.view(np.int64).copy()))
    want = np.asarray(jtm.representative_rows(jnp.asarray(rows)))
    np.testing.assert_array_equal(got.numpy().view(np.uint64), want)
    # leading shape [B, A, W], as the engine passes it
    got3 = tm.representative_rows(
        torch.from_numpy(rows.view(np.int64).reshape(50, 10, -1).copy()))
    np.testing.assert_array_equal(got3.reshape(b, -1), got)
    # and the object form: encode(representative(decode(row)))
    for r, g in zip(rows[:100], got.numpy().view(np.uint64)[:100]):
        s = tm.decode_state(tuple(int(x) for x in r))
        assert tuple(int(x) for x in g) == tm.encode_state(s.representative())


def test_compiled_representative_rows_and_key_match_jax_on_raft3():
    """The compiler's mechanical symmetry on raft-3: the virtual rows of
    every queued row and of a successor block (invalid lanes included)
    equal the JAX ones, and so does the host key."""
    m, jm = raft_model(3), jax_raft(3)
    tm, jtm = m.tensor_model(), jm.tensor_model()
    jtm.init_rows()  # builds the JAX twin's device tables
    assert hasattr(tm, "representative_rows") and hasattr(jtm, "representative_rows")
    states = reachable(m, 600)
    rows = np.asarray([tm.encode_state(s) for s in states], np.uint64)
    trows = torch.from_numpy(rows.view(np.int64).copy())
    got = tm.representative_rows(trows)
    assert got.shape[-1] == tm.n_actors + 1 + tm.n_slots
    want = np.asarray(jtm.representative_rows(jnp.asarray(rows)))
    np.testing.assert_array_equal(got.numpy().view(np.uint64), want)
    succ, _valid = tm.step_rows(trows[:64])
    jsucc = np.asarray(succ).view(np.uint64)
    np.testing.assert_array_equal(
        tm.representative_rows(succ).numpy().view(np.uint64),
        np.asarray(jtm.representative_rows(jnp.asarray(jsucc))))
    for s in states[:150]:
        js = jtm.decode_state(tm.encode_state(s))
        assert tm.representative_key(s) == jtm.representative_key(js)


def test_compiled_symmetry_only_for_the_general_fragment():
    # the register workload has a history: no mechanical symmetry
    tm = paxos_model(1).tensor_model()
    assert not hasattr(tm, "representative_rows")
    with pytest.raises(NotImplementedError, match="representative_rows"):
        paxos_model(1).checker().symmetry().spawn_gpu(device="cpu")


# -- generation order in the insert ---------------------------------------------


def as_torch(a):
    return torch.from_numpy(np.array(a, np.uint64).view(np.int64))


@pytest.mark.parametrize("case", GEN_CASES)
def test_generation_order_insert_matches_jax(case):
    rng = np.random.default_rng(GEN_CASES.index(case))
    nb, pre, fps, compact = gen_case(case, rng)
    payloads = rng.integers(0, 1 << 64, size=fps.size, dtype=np.uint64)
    n = nb * jb.SLOTS
    jt = (jnp.full((n,), jb.EMPTY, jnp.uint64), jnp.zeros((n,), jnp.uint64))
    tt = (torch.full((n,), -1, dtype=torch.int64),
          torch.zeros(n, dtype=torch.int64))
    jt = jb.bucket_insert(*jt, jnp.asarray(pre), jnp.asarray(pre), window=64,
                          generation_order=True)[:2]
    tb.bucket_insert(*tt, as_torch(pre), as_torch(pre), generation_order=True)
    # the plain plan alone, before the insert, in both orders
    inputs = tb.sort_candidates(as_torch(fps), as_torch(payloads), nb, compact)
    gen = tb.bucket_plan_plain(tt[0], *inputs, generation_order=True)
    tab = tb.bucket_plan_plain(tt[0], *inputs)
    rj = jb.bucket_insert(*jt, jnp.asarray(fps), jnp.asarray(payloads),
                          window=64, compact=compact, generation_order=True)
    rt = tb.bucket_insert(*tt, as_torch(fps), as_torch(payloads),
                          compact=compact, generation_order=True)
    n_new = int(rj[3])
    assert int(rt[3]) == n_new == int(gen[4])
    assert bool(rt[4]) == bool(rj[4]) == bool(gen[5])
    assert bool(rt[5]) == bool(rj[5])
    np.testing.assert_array_equal(rt[2].numpy()[:n_new], np.asarray(rj[2])[:n_new])
    np.testing.assert_array_equal(rt[0].numpy().view(np.uint64), np.asarray(rj[0]))
    np.testing.assert_array_equal(rt[1].numpy().view(np.uint64), np.asarray(rj[1]))
    # the planned lanes (blocked or not): the same slots in both orders,
    # listed by ascending candidate index in generation order
    planned = int((gen[0] != n).sum())
    assert planned == int((tab[0] != n).sum())
    assert torch.equal(torch.sort(gen[0]).values, torch.sort(tab[0]).values)
    assert torch.equal(torch.sort(gen[3][:planned]).values, gen[3][:planned])
    expect = {"full_bucket_line": (True, False), "cand_overflow": (False, True)}
    assert (bool(rj[4]), bool(rj[5])) == expect.get(case, (False, False))
    if case in expect:
        assert n_new == 0
    else:
        assert n_new > 0


# -- the engine ------------------------------------------------------------------


def same_sym_run(t, j):
    """Counts, discoveries, traces, table bytes and queue rows [0, tail)."""
    assert (t.unique_state_count(), t.state_count(), t.max_depth()) == (
        j.unique_state_count(), j.state_count(), j.max_depth())
    assert t.growth_events == j.growth_events
    jt, tt = j._table_np(), t._table_np()
    np.testing.assert_array_equal(tt[0], np.asarray(jt[0]))
    np.testing.assert_array_equal(tt[1], np.asarray(jt[1]))
    jd = [int(x) for x in np.asarray(j._results["disc"])]
    assert [int(x) for x in t._results["disc"]] == jd
    for fp in jd:
        if fp:
            assert t._trace(fp) == j._trace(fp)
    js, ts = j.checkpoint(), t.final_snapshot()
    tail = int(ts["tail"])
    assert (int(ts["head"]), tail) == (int(js["head"]), int(js["tail"]))
    for k in ("q_rows", "q_fp", "q_ebits", "q_depth"):
        np.testing.assert_array_equal(np.asarray(ts[k])[:tail],
                                      np.asarray(js[k])[:tail], err_msg=k)
    # every discovery replays (class-matching walk) and satisfies its
    # property; the paths are the JAX engine's, action for action
    tp, jp = t.discoveries(), j.discoveries()
    assert sorted(tp) == sorted(jp)
    for name, path in tp.items():
        assert [repr(a) for a in path.actions()] == [
            repr(a) for a in jp[name].actions()]
        m = t.model
        assert m.property_by_name(name).condition(m, path.final_state())


@pytest.mark.parametrize("n,kw,counts", [
    (5, dict(capacity=1 << 14, batch=1 << 9), (508, 3_174)),
    (7, {}, (2_326, 19_758)),
    # small enough to grow the table and the queue mid-run
    (5, dict(capacity=1 << 6, batch=1 << 3), (508, 3_174)),
])
def test_2pc_symmetry_engine_matches_jax_engine(n, kw, counts):
    jkw = dict(kw)
    if "batch" in jkw:
        jkw["frontier_capacity"] = jkw.pop("batch")
    j = JaxSys(n).checker().symmetry().spawn_tpu(sync=True, **jkw)
    t = TwoPhaseSys(n).checker().symmetry().spawn_gpu(device="cpu", **kw).join()
    assert (t.unique_state_count(), t.state_count()) == counts
    same_sym_run(t, j)
    assert set(t.discoveries()) == {"abort agreement", "commit agreement"}
    if kw.get("capacity", 1 << 17) < 1 << 7:
        assert t.growth_events


def per_channel(m):
    m.per_channel_()
    return m


@pytest.mark.parametrize("packing", ["slot-multiset", "per-channel"])
def test_raft3_symmetry_engine_matches_jax_engine(packing):
    m, jm = raft_model(3), jax_raft(3)
    if packing == "per-channel":
        m, jm = per_channel(m), per_channel(jm)
    j = jm.checker().symmetry().spawn_tpu(sync=True, capacity=1 << 14,
                                          frontier_capacity=1 << 8)
    t = m.checker().symmetry().spawn_gpu(device="cpu", capacity=1 << 14,
                                         batch=1 << 8).join()
    assert t.tensor.network_encoding == packing
    assert (t.unique_state_count(), t.state_count()) == (2_926, 7_917)
    same_sym_run(t, j)


def test_device_symmetry_guards():
    from stateright_tpu_torch.checker.visitor import PathRecorder

    with pytest.raises(NotImplementedError, match="symmetry_with"):
        TwoPhaseSys(3).checker().symmetry_with(
            lambda s: s.representative()).spawn_gpu(device="cpu")
    with pytest.raises(NotImplementedError, match="visitors"):
        TwoPhaseSys(3).checker().visitor(PathRecorder()).spawn_gpu(device="cpu")
    # the host DFS honours a custom symmetry function
    d = TwoPhaseSys(5).checker().symmetry_with(
        lambda s: s.representative()).spawn_dfs().join()
    assert d.unique_state_count() == 665


@pytest.mark.parametrize("module,argv,expect", [
    (port_2pc, ["check-sym", "4"], "unique="),
    (port_raft, ["check-sym", "2"], "unique="),
    (port_raft, ["check-sym", "2", "--per-channel"], "unique="),
])
def test_check_sym_verbs_run_the_host_dfs(module, argv, expect, capsys):
    assert module.main(argv) == 0
    out = capsys.readouterr().out
    assert "symmetry" in out and expect in out


@pytest.mark.parametrize("module", [port_2pc, port_raft])
def test_check_sym_gpu_verbs_raise_without_a_card(module):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(["check-sym-gpu", "3"])
    assert module.main(["check-sym-gpu", "3", "4", "5"]) == 2


@pytest.mark.slow
def test_2pc9_symmetry_engine_matches_jax_engine():
    j = JaxSys(9).checker().symmetry().spawn_tpu(sync=True)
    t = TwoPhaseSys(9).checker().symmetry().spawn_gpu(device="cpu").join()
    assert (t.unique_state_count(), t.state_count()) == (9_860, 104_976)
    same_sym_run(t, j)
