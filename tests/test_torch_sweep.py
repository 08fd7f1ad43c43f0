"""The port's hyper-batched instance sweeps against the JAX package
(``tests/test_sweep.py``), tolerance 0 throughout.

 - namespacing: ``unmix64``, ``ns_fingerprint``, ``ns_hash_plain`` and
   ``cand_prep_plain``'s namespace mode equal the JAX ``ns_fingerprint``
   and ``ns_hash`` bit for bit, the 0/EMPTY remap included; order kept
   within an instance, disjoint across instances;
 - ``insert_commit_plain``'s tag column against a numpy oracle;
 - the 2pc seed-only sweep against the JAX ``SweepChecker`` at the same
   capacities and batch: final tables, queue rows and tags, per-instance
   counts, discoveries and the seed-0 traces (paxos's two cohorts and the
   lifted cohort are in ``test_torch_sweep_cohort.py``);
 - early termination, growth, kill and resume, refused resumes, refused
   modes, the env knob, the verb, the off contract, snapshots across the
   two packages both ways, the registry and the diff.
"""

import importlib
import io
import json
import os

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (both frameworks in one process, JAX on the CPU)
import jax.numpy as jnp

from stateright_tpu.models.two_phase_commit import TwoPhaseSys as JaxSys
from stateright_tpu.models.two_phase_commit import (
    sweep_family as jax_2pc_family,
)
from stateright_tpu_torch.models.two_phase_commit import (
    TwoPhaseSys, sweep_family,
)
from stateright_tpu_torch.ops.hashing import (
    EMPTY, GAMMA, mix64, ns_hash_plain, to_i64, unmix64,
)
from stateright_tpu_torch.sweep import SweepInstance, SweepSpec
from stateright_tpu_torch.sweep.cohort import build_cohorts
from stateright_tpu_torch.sweep.engine import SweepChecker
from stateright_tpu_torch.testing.sweep_fixtures import bounded_counter_spec

# the modules, not the packages' ``fingerprint`` functions
jfp = importlib.import_module("stateright_tpu.fingerprint")
tfp = importlib.import_module("stateright_tpu_torch.fingerprint")

TPC3 = (288, 1146, 10)  # unique, states, depth
KW = dict(capacity=1 << 12, batch=64)


def port_sweep(spec, *, cartography=False, telemetry=False, runs=None,
               **kw):
    b = spec.instances[0].model.checker()
    if cartography or telemetry:
        b = b.telemetry(cartography=cartography)
    if runs:
        b = b.runs(runs)
    for k, v in KW.items():
        kw.setdefault(k, v)
    return b.sweep(spec).spawn_gpu(device="cpu", **kw).join()


def jax_sweep(spec, **kw):
    for k, v in KW.items():
        kw.setdefault(k, v)
    return spec.instances[0].model.checker().sweep(spec).spawn_tpu(
        sync=True, **kw)


def u64(x) -> np.ndarray:
    return np.asarray(x).view(np.uint64) if np.asarray(x).dtype == np.int64 \
        else np.asarray(x, np.uint64)


def assert_same_sweep_state(port_snap: dict, jax_snap: dict) -> None:
    """Final tables, cursors, per-instance counters, discoveries and the
    queue rows ``[0, tail)`` with their tags (past ``tail`` is scratch)."""
    for k in ("table_fp", "table_parent", "head", "tail", "unique_k",
              "scount_k", "disc", "maxdepth_k", "status"):
        np.testing.assert_array_equal(np.asarray(port_snap[k]),
                                      np.asarray(jax_snap[k]), err_msg=k)
    tail = int(jax_snap["tail"])
    for k in ("q_rows", "q_fp", "q_tag", "q_ebits", "q_depth"):
        np.testing.assert_array_equal(np.asarray(port_snap[k])[:tail],
                                      np.asarray(jax_snap[k])[:tail],
                                      err_msg=k)
    np.testing.assert_array_equal(port_snap["model_sig"],
                                  jax_snap["model_sig"])


def npz_round_trip(snap: dict) -> dict:
    buf = io.BytesIO()
    np.savez(buf, **{k: np.asarray(v) for k, v in snap.items()})
    buf.seek(0)
    with np.load(buf, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


# -- fingerprint namespacing --------------------------------------------------


def test_unmix64_inverts_mix64_as_jax():
    rng = np.random.default_rng(7)
    xs = [0, 1, (1 << 64) - 1] + [
        int(v) for v in rng.integers(0, 1 << 63, 32, dtype=np.uint64)]
    for x in xs:
        assert tfp.unmix64(x) == jfp.unmix64(x)
        assert tfp.unmix64(tfp.mix64(x)) == x
    t = torch.tensor([to_i64(x) for x in xs], dtype=torch.int64)
    assert torch.equal(unmix64(mix64(t)), t)
    assert [v & ((1 << 64) - 1) for v in unmix64(t).tolist()] == [
        jfp.unmix64(x) for x in xs]


def _remap_fps(bits: int, seed: int):
    """Two inputs that namespace onto the reserved words under tag 0 and
    the tag of EMPTY's key: ``unmix64`` gives 0, and EMPTY."""
    low = (1 << bits) - 1
    xor = tfp.sweep_ns_xor(seed) & ~low
    zero_in = tfp.unmix64(xor ^ 1)  # key 0 after the xor and tag 0
    k_empty = tfp.mix64((1 << 64) - 1)
    empty_in = tfp.unmix64((k_empty ^ xor) ^ (1 if low & 1 else 0))
    return [(zero_in, 0), (empty_in, k_empty & low)]


@pytest.mark.parametrize("bits,tag,seed", [(1, 0, 0), (3, 5, 0),
                                           (4, 9, 12345), (10, 700, 7)])
def test_ns_fingerprint_and_ns_hash_plain_equal_jax(bits, tag, seed):
    """The host mirror and the plain device function against the JAX
    ``ns_fingerprint`` and ``ns_hash`` on seeded words, and on two words
    that hit the 0 / EMPTY remap."""
    from stateright_tpu.ops.hashing import ns_hash

    rng = np.random.default_rng(3 + bits)
    pairs = [(int(f), tag) for f in rng.integers(1, 1 << 63, 64,
                                                 dtype=np.uint64)]
    pairs += _remap_fps(bits, seed)
    host = [tfp.ns_fingerprint(f, t, seed, bits) for f, t in pairs]
    assert host == [jfp.ns_fingerprint(f, t, seed, bits) for f, t in pairs]
    assert host[-2] == host[-1] == jfp._SM_GAMMA  # both remapped
    xor = tfp.sweep_ns_xor(seed)
    fps = np.asarray([f for f, _ in pairs], np.uint64)
    tags = np.asarray([t for _, t in pairs], np.uint64)
    dev = np.asarray(ns_hash(jnp.asarray(fps), jnp.asarray(tags),
                             jnp.full((len(pairs),), np.uint64(xor)), bits))
    port = ns_hash_plain(torch.from_numpy(fps.view(np.int64).copy()),
                         torch.from_numpy(tags.view(np.int64).copy()),
                         torch.tensor(to_i64(xor)), bits)
    np.testing.assert_array_equal(u64(port.numpy()), dev)
    np.testing.assert_array_equal(dev, np.asarray(host, np.uint64))


def test_ns_is_order_preserving_and_disjoint():
    """Within an instance the sort key keeps the raw order; across
    instances the namespaced fingerprints are disjoint, even for the same
    raw fingerprints (JAX test_sweep.py:131)."""
    rng = np.random.default_rng(11)
    fps = sorted(int(v) for v in rng.integers(1, 1 << 62, 128,
                                              dtype=np.uint64))
    bits = 3
    keyed = [tfp.mix64(tfp.ns_fingerprint(f, 2, 0, bits)) for f in fps]
    raw_order = sorted(range(128), key=lambda i: tfp.mix64(fps[i]))
    assert raw_order == sorted(range(128), key=lambda i: keyed[i])
    a = {tfp.ns_fingerprint(f, 0, 0, bits) for f in fps}
    b = {tfp.ns_fingerprint(f, 1, 0, bits) for f in fps}
    assert not (a & b)


@pytest.mark.parametrize("n,bits", [(1, 1), (2, 1), (3, 2), (8, 3), (9, 4),
                                    (1000, 10)])
def test_sweep_ns_bits(n, bits):
    assert tfp.sweep_ns_bits(n) == jfp.sweep_ns_bits(n) == bits


@pytest.mark.parametrize("seed", [0, 1])
def test_cand_prep_plain_namespace_mode_equals_jax(seed):
    """``cand_prep_plain(..., ns)`` against the JAX composition
    ``where(valid, ns_hash(row_hash(rows), low[t], xor[t], bits), EMPTY)``,
    compacted in lane order, keyed by ``bucket_key`` of the namespaced
    fingerprint; one lane is made to namespace onto 0, so its key is
    ``bucket_key(GAMMA)``, not the pre-remap key."""
    from stateright_tpu.ops.buckets import bucket_key as jax_bucket_key
    from stateright_tpu.ops.hashing import ns_hash, row_hash
    from stateright_tpu_torch.ops.cand_prep import Namespace, cand_prep_plain

    rng = np.random.default_rng(20 + seed)
    b, arity, width, k, bits = 16, 3, 2, 5, 3
    m = b * arity
    rows = rng.integers(0, 1 << 63, (m, width), dtype=np.uint64)
    valid = rng.random(m) < 0.7
    valid[0] = True
    ptags = rng.integers(0, k, b).astype(np.int32)
    ptags[0] = 0
    low = np.arange(k, dtype=np.uint64) + np.uint64(seed)
    xor = np.asarray([tfp.sweep_ns_xor(s) for s in rng.integers(0, 99, k)],
                     np.uint64)
    # lane 0's fingerprint, under tag 0's tables, namespaces onto 0
    h0 = int(np.asarray(row_hash(jnp.asarray(rows[:1])))[0])
    xor[0] = np.uint64(tfp.mix64(h0) & ~((1 << bits) - 1))
    low[0] = np.uint64(0)
    lane_t = np.repeat(ptags, arity)
    jfps = np.asarray(jnp.where(
        jnp.asarray(valid),
        ns_hash(row_hash(jnp.asarray(rows)), jnp.asarray(low[lane_t]),
                jnp.asarray(xor[lane_t]), bits),
        jnp.uint64((1 << 64) - 1)))
    assert jfps[0] == jfp._SM_GAMMA
    pfps = rng.integers(1, 1 << 62, b).astype(np.int64)
    cb = m
    out = cand_prep_plain(
        torch.from_numpy(rows.view(np.int64).copy()),
        torch.from_numpy(valid), torch.from_numpy(pfps), arity, cb,
        Namespace(torch.from_numpy(ptags),
                  torch.from_numpy(low.view(np.int64).copy()),
                  torch.from_numpy(xor.view(np.int64).copy()), bits))
    cfp, cpl, cidx, key, n_valid, cov = out
    n = int(valid.sum())
    assert int(n_valid) == n and not bool(cov)
    np.testing.assert_array_equal(u64(cfp.numpy())[:n], jfps[valid])
    want_key = np.asarray(jax_bucket_key(jnp.asarray(jfps[valid])))
    np.testing.assert_array_equal(
        (u64(key.numpy())[:n] ^ np.uint64(1 << 63)), want_key)
    np.testing.assert_array_equal(cidx.numpy()[:n], np.flatnonzero(valid))
    np.testing.assert_array_equal(cpl.numpy()[:n],
                                  pfps[np.flatnonzero(valid) // arity])
    assert (cfp.numpy()[n:] == EMPTY).all()
    assert int(cfp[0]) == GAMMA


def test_insert_commit_plain_tag_column_against_numpy():
    """The tag column: queue row ``tail + j`` gets its parent's tag
    ``parent_tags[sel[j] // arity]`` beside the other lanes; without the
    column the tags are left alone."""
    from stateright_tpu_torch.ops.insert_commit import (
        QueueAppend, insert_commit_plain,
    )

    rng = np.random.default_rng(5)
    b, arity, width, q, n_new, tail = 8, 3, 2, 64, 9, 5
    m = b * arity
    sel = rng.permutation(m)[:m].astype(np.int64)
    tgt = rng.permutation(256)[:m].astype(np.int64)
    cfp = rng.integers(1, 1 << 62, m).astype(np.int64)
    cpl = rng.integers(1, 1 << 62, m).astype(np.int64)
    src = rng.integers(0, 1 << 62, (m, width)).astype(np.int64)
    pe = rng.integers(0, 7, b).astype(np.int32)
    pd = rng.integers(0, 9, b).astype(np.int32)
    pt = rng.integers(0, 4, b).astype(np.int32)
    for tagged in (True, False):
        T = {k: torch.from_numpy(v.copy()) for k, v in dict(
            sel=sel, tgt=tgt, cfp=cfp, cpl=cpl, src=src, pe=pe, pd=pd,
            pt=pt).items()}
        tf = torch.full((256,), EMPTY, dtype=torch.int64)
        tp = torch.zeros(256, dtype=torch.int64)
        qr = torch.zeros((q, width), dtype=torch.int64)
        qf = torch.full((q,), EMPTY, dtype=torch.int64)
        qe = torch.zeros(q, dtype=torch.int32)
        qd = torch.zeros(q, dtype=torch.int32)
        qt = torch.full((q,), -7, dtype=torch.int32)
        insert_commit_plain(
            tf, tp, T["tgt"], T["cfp"], T["cpl"], torch.tensor(n_new),
            QueueAppend(qr, qf, qe, qd, torch.tensor(tail), T["sel"],
                        T["src"], T["pe"], T["pd"], arity,
                        tags=qt if tagged else None,
                        parent_tags=T["pt"] if tagged else None))
        want_t = np.full(q, -7, np.int32)
        if tagged:
            want_t[tail:tail + n_new] = pt[sel[:n_new] // arity]
        np.testing.assert_array_equal(qt.numpy(), want_t)
        np.testing.assert_array_equal(qr.numpy()[tail:tail + n_new],
                                      src[sel[:n_new]])
        np.testing.assert_array_equal(qd.numpy()[tail:tail + n_new],
                                      pd[sel[:n_new] // arity] + 1)
        np.testing.assert_array_equal(tf.numpy()[tgt[:n_new]], cfp[:n_new])


# -- spec and cohorts ---------------------------------------------------------


def test_spec_rejects_duplicates_and_empty():
    with pytest.raises(ValueError):
        SweepSpec([])
    with pytest.raises(ValueError):
        SweepSpec([SweepInstance("a", TwoPhaseSys(3)),
                   SweepInstance("a", TwoPhaseSys(3))])


def test_cohort_grouping_and_const_lifting():
    """Bounds [2, 3, 5] unify into one cohort (the bound is a lifted
    scalar), and a 2pc member lands in its own; the namespace tags are
    global spec positions (JAX test_sweep.py:170)."""
    spec = SweepSpec(list(bounded_counter_spec([2, 3, 5]).instances)
                     + [SweepInstance("2pc", TwoPhaseSys(3))])
    cohorts = build_cohorts(spec)
    assert [c.K for c in cohorts] == [3, 1]
    assert cohorts[0].unified and cohorts[0].lifted > 0
    assert cohorts[0].global_index == [0, 1, 2]
    assert cohorts[1].global_index == [3]


def test_seed_only_family_runs_member_zero_kernels():
    """Nothing to lift in a seed-only family: the cohort runs member 0's
    own kernels, as JAX does (cohort.py:336-345)."""
    (c,) = build_cohorts(sweep_family(3))
    assert c.K == 3 and c.lifted == 0
    rows = torch.zeros((2, c.width), dtype=torch.int64)
    tags = torch.tensor([0, 2], dtype=torch.int32)
    s, v = c.step_rows(rows, tags)
    s0, v0 = c.twins[0].step_rows(rows)
    assert torch.equal(s, s0) and torch.equal(v, v0)


# -- seed-only sweeps against the JAX sweep engine ----------------------------


def _seed_sweep_parity(port_spec, jax_spec, pins, **kw):
    j = jax_sweep(jax_spec, **kw)
    p = port_sweep(port_spec, **kw)
    assert [c.K for c in p.cohorts] == [c.K for c in j.cohorts]
    for c_p, c_j in zip(p.cohorts, j.cohorts):
        assert c_p.global_index == c_j.global_index
    assert_same_sweep_state(p.final_snapshot(), j._final_snapshot)
    for inst in port_spec.instances:
        rp, rj = p.results[inst.key], j.results[inst.key]
        assert (rp.unique, rp.states, rp.max_depth) == (
            rj.unique, rj.states, rj.max_depth) == pins[inst.key]
        np.testing.assert_array_equal(rp.disc, rj.disc)
        assert rp.chains == rj.chains
        if inst.seed == 0:  # seed 0: the traces are the sequential run's
            pd, jd = p.instance_discoveries(inst.key), \
                j.instance_discoveries(inst.key)
            assert sorted(pd) == sorted(jd)
            for name in jd:
                # the packages' action objects render alike (paxos's
                # envelopes are each package's own classes)
                assert [str(a) for a in pd[name].actions()] == [
                    str(a) for a in jd[name].actions()]
                assert len(pd[name]) == len(jd[name])
    assert p.engine_compiles == j.engine_compiles
    assert len(p.growth_events) == len(j.growth_events)
    return p


def test_seed_sweep_2pc_equals_jax_sweep_engine():
    p = _seed_sweep_parity(sweep_family(4), jax_2pc_family(4),
                           {f"2pc3-seed{i}": TPC3 for i in range(4)})
    assert len(p.cohorts) == 1 and p.engine_compiles == 1


# -- the remaining JAX cases --------------------------------------------------


def test_per_instance_target_early_termination():
    """A targeted instance stops early without stalling the member that
    shares its cohort (JAX test_sweep.py:225)."""
    spec = SweepSpec([SweepInstance("full", TwoPhaseSys(3)),
                      SweepInstance("prefix", TwoPhaseSys(3), target=5)])
    c = port_sweep(spec, batch=16)
    assert c.results["full"].unique == TPC3[0]
    assert 5 <= c.results["prefix"].unique < TPC3[0]


def test_growth_preserves_per_instance_counts():
    spec = SweepSpec([SweepInstance("a", TwoPhaseSys(4)),
                      SweepInstance("b", TwoPhaseSys(4), seed=9)])
    c = port_sweep(spec, capacity=1 << 10, batch=32, steps_per_call=4)
    assert c.growth_events, "the tiny capacity must force growth"
    for k in ("a", "b"):
        assert c.results[k].unique == 1568


def test_kill_resume_mid_sweep():
    """A mid-run snapshot carries the tags and the finished cohorts'
    results; the resumed sweep finishes every member at its counts, with
    the lineage set and every depth histogram complete."""
    def spec():
        return SweepSpec([SweepInstance("2pc-3", TwoPhaseSys(3)),
                          SweepInstance("2pc-5", TwoPhaseSys(5))])

    c = (TwoPhaseSys(3).checker().telemetry(cartography=True)
         .sweep(spec()).spawn_gpu(device="cpu", capacity=1 << 12,
                                  batch=64, steps_per_call=2))
    snap = c.checkpoint(timeout=60)
    assert "q_tag" in snap
    c.stop().join()
    loaded = npz_round_trip(snap)
    c2 = (TwoPhaseSys(3).checker().telemetry(cartography=True)
          .sweep(spec()).spawn_gpu(device="cpu", capacity=1 << 12,
                                   batch=64, resume=loaded).join())
    assert c2.parent_run_id == c.run_id
    assert c2.results["2pc-3"].unique == 288
    assert c2.results["2pc-5"].unique == 8832
    assert sorted(c2.instance_discoveries("2pc-5")) == [
        "abort agreement", "commit agreement"]
    for key, unique in (("2pc-3", 288), ("2pc-5", 8832)):
        assert sum(c2.results[key].cartography["depth_hist"]) == unique


def test_resume_refuses_a_foreign_sweep_or_engine():
    spec = SweepSpec([SweepInstance("a", TwoPhaseSys(3))])
    snap = port_sweep(spec).checkpoint()
    other = SweepSpec([SweepInstance("b", TwoPhaseSys(4))])
    with pytest.raises(ValueError, match="different sweep"):
        TwoPhaseSys(3).checker().sweep(other).spawn_gpu(device="cpu",
                                                        resume=snap)
    with pytest.raises(ValueError, match="sweep"):
        TwoPhaseSys(3).checker().spawn_gpu(device="cpu", resume=snap)
    plain = TwoPhaseSys(3).checker().spawn_gpu(device="cpu",
                                               **KW).join().final_snapshot()
    with pytest.raises(ValueError, match="engine"):
        TwoPhaseSys(3).checker().sweep(spec).spawn_gpu(device="cpu",
                                                       resume=plain)


@pytest.mark.parametrize("mode", ["por", "spill", "checked", "mxu",
                                  "prededup", "symmetry", "autosave"])
def test_sweep_rejects_unsupported_modes(mode, tmp_path):
    spec = SweepSpec([SweepInstance("a", TwoPhaseSys(3))])
    b = TwoPhaseSys(3).checker().sweep(spec)
    b = (b.autosave(str(tmp_path)) if mode == "autosave"
         else getattr(b, mode)())
    with pytest.raises(NotImplementedError, match=mode):
        b.spawn_gpu(device="cpu")


def test_env_knob_routes_models_with_a_family(monkeypatch):
    monkeypatch.setenv("STATERIGHT_TPU_SWEEP", "2")
    c = TwoPhaseSys(3).checker().spawn_gpu(device="cpu", **KW).join()
    assert isinstance(c, SweepChecker) and len(c.spec.instances) == 2
    for r in c.results.values():
        assert (r.unique, r.states) == TPC3[:2]


def test_sweep_off_is_the_plain_engine_with_the_same_operations(
        monkeypatch, capsys):
    """No sweep asked for: ``spawn_gpu`` builds ``GpuChecker``, and a step
    dispatches exactly the pinned operations; the env knob on a model
    without a family prints its one-liner and changes nothing, and a
    malformed knob likewise."""
    from test_torch_engine import FLAGS_OFF_OPS_PER_STEP, OpCount

    from stateright_tpu_torch.parallel import wavefront

    steps = []
    step = wavefront._Engine.step

    def counted(self, c):
        probe = OpCount()
        with probe:
            out = step(self, c)
        steps.append(sum(probe.ops.values()))
        return out

    monkeypatch.setattr(wavefront._Engine, "step", counted)

    class NoFamily(TwoPhaseSys):
        sweep_family = None

    for env, model in ((None, TwoPhaseSys(3)), ("1", NoFamily(3)),
                       ("x", TwoPhaseSys(3))):
        if env is None:
            monkeypatch.delenv("STATERIGHT_TPU_SWEEP", raising=False)
        else:
            monkeypatch.setenv("STATERIGHT_TPU_SWEEP", env)
        c = model.checker().spawn_gpu(device="cpu", batch=64,
                                      steps_per_call=4).join()
        assert type(c) is wavefront.GpuChecker
        assert c.unique_state_count() == 288
    err = capsys.readouterr().err
    assert "defines no sweep_family" in err and "malformed" in err
    assert steps and set(steps) <= FLAGS_OFF_OPS_PER_STEP["2pc"]


def test_sweep_cli_verb(capsys):
    from stateright_tpu_torch.models import two_phase_commit

    assert two_phase_commit.main(["sweep", "2", "--device=cpu", "--batch=64",
                                  "--capacity=4096"]) == 0
    out = capsys.readouterr().out
    assert "2 instances over 1 cohort(s), 1 engine compile(s)" in out
    assert "2pc3-seed0: unique=288 states=1146" in out


# -- snapshots across the two packages ----------------------------------------


def _spec_pair():
    def port():
        return SweepSpec([SweepInstance("2pc-3", TwoPhaseSys(3)),
                          SweepInstance("2pc-4", TwoPhaseSys(4), seed=5)])

    def jax_():
        from stateright_tpu.sweep import SweepInstance as JI
        from stateright_tpu.sweep import SweepSpec as JS

        return JS([JI("2pc-3", JaxSys(3)), JI("2pc-4", JaxSys(4), seed=5)])

    return port, jax_


def test_snapshot_resumes_across_packages_both_ways():
    """A JAX mid-sweep snapshot resumes in the port and ends on the JAX
    run's final tables; a port mid-sweep snapshot resumes in JAX and ends
    on the port run's."""
    port_spec, jax_spec = _spec_pair()
    kw = dict(capacity=1 << 12, batch=32, steps_per_call=3)
    j_full = jax_sweep(jax_spec(), **kw)
    p_full = port_sweep(port_spec(), **kw)
    assert_same_sweep_state(p_full.final_snapshot(), j_full._final_snapshot)

    # JAX -> port: stop the JAX run after its first blocks
    jc = JaxSys(3).checker().sweep(jax_spec()).spawn_tpu(**kw)
    jsnap = jc.checkpoint(timeout=120)
    jc.stop().join()
    assert int(jsnap["tail"]) > 0
    p = port_sweep(port_spec(), resume=npz_round_trip(jsnap), **kw)
    assert_same_sweep_state(p.final_snapshot(), j_full._final_snapshot)

    # port -> JAX
    pc = (TwoPhaseSys(3).checker().sweep(port_spec())
          .spawn_gpu(device="cpu", **kw))
    psnap = pc.checkpoint(timeout=120)
    pc.stop().join()
    j = JaxSys(3).checker().sweep(jax_spec()).spawn_tpu(
        sync=True, resume=npz_round_trip(psnap), **kw)
    assert_same_sweep_state(p_full.final_snapshot(), j._final_snapshot)
    for key in ("2pc-3", "2pc-4"):
        assert j.results[key].unique == p_full.results[key].unique


# -- registry and diff --------------------------------------------------------


def test_registry_records_and_jax_port_instance_reports_diff(tmp_path):
    """One registry record per instance under the sweep's id, and a JAX
    sweep-instance report and a port one of 2pc-3 seed 0 diff with no
    violation (IDENTICAL, or PERF-ONLY for device or checkout drift
    alone, as every JAX/port pair)."""
    from stateright_tpu.telemetry.report import build_report as jax_build
    from stateright_tpu_torch.telemetry.diff import (
        IDENTICAL, PERF_ONLY, diff_reports,
    )
    from stateright_tpu_torch.telemetry.registry import RunRegistry
    from stateright_tpu_torch.telemetry.report import build_report

    runs = str(tmp_path / "runs")
    p = port_sweep(sweep_family(2), cartography=True, runs=runs)
    idx = RunRegistry(runs).index()
    assert {r["instance_key"] for r in idx} == {"2pc3-seed0", "2pc3-seed1"}
    assert all(r["sweep_id"] == p.run_id for r in idx)
    j = (JaxSys(3).checker().telemetry(cartography=True)
         .sweep(jax_2pc_family(2)).spawn_tpu(sync=True, **KW))
    a = json.loads(json.dumps(jax_build(j.instance_view("2pc3-seed0"))))
    b = json.loads(json.dumps(build_report(p.instance_view("2pc3-seed0"))))
    assert b["config"]["flags"]["sweep"] is True
    d = diff_reports(a, b)
    assert d["violations"] == [] and d["verdict"] in (IDENTICAL, PERF_ONLY), d
    assert set(d["config_delta"]) <= {"engine", "device", "git_rev"}
    b["totals"]["unique"] += 1
    assert diff_reports(a, b)["verdict"] == "DIVERGENT"


def test_sweep_block_stats_and_recorder_stream():
    """The recorder's ``sweep`` records of a seed sweep: one
    ``cohort_compile``, one ``instance_done`` per member, ``summary`` last,
    and ``step`` records whose totals reach the members' sum."""
    c = port_sweep(sweep_family(3), telemetry=True)
    rec = c.flight_recorder
    ev = [r["event"] for r in rec.records("sweep")]
    assert ev.count("cohort_compile") == 1 and ev.count("instance_done") == 3
    assert ev[-1] == "summary"
    assert rec.records("sweep")[-1]["engine_compiles"] == 1
    assert rec.records("step")[-1]["unique"] == 3 * TPC3[0]
    assert c.unique_state_count() == 3 * TPC3[0]
    assert c.state_count() == 3 * TPC3[1]


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    raise SystemExit(pytest.main([__file__, "-v"]))
