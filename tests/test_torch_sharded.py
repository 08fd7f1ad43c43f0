"""The port's sharded engine (``spawn_gpu(devices=N, device="cpu")``, the
plain PyTorch path) against the JAX package's ``ShardedTpuChecker`` on the
8-device CPU mesh of ``tests/conftest.py``, tolerance 0: per-shard table
bytes and parents, the frontier (rows, fingerprints and ebits at the live
lanes; the dead lanes are scratch in both engines), counts, discoveries
and their traces, ``growth_events`` and the whole snapshot; then every pin
of ``tests/test_sharded.py`` on the port alone, and resumes across the two
packages' snapshots, both ways.  The flags are in
``test_torch_sharded_flags.py``, the multi-controller form in
``test_torch_multihost.py``."""

import io
import time

import numpy as np
import pytest
import torch

from stateright_tpu.models import paxos as jpaxos
from stateright_tpu.models.two_phase_commit import TwoPhaseSys as JaxSys
from stateright_tpu_torch import convert
from stateright_tpu_torch.models import paxos
from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
from stateright_tpu_torch.parallel.sharded import ShardedGpuChecker
from stateright_tpu_torch.parallel.wavefront import GpuChecker

EMPTY = np.uint64(2 ** 64 - 1)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The port's runs here on one torch thread: their tensors are small,
    and under several test workers the default thread pool oversubscribes
    the host's cores many times over.  Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_sharded(model, n, builder=None, **kw):
    b = model.checker() if builder is None else builder(model.checker())
    return b.spawn_tpu(devices=n, sync=True, **kw)


def port_sharded(model, n, builder=None, **kw):
    b = model.checker() if builder is None else builder(model.checker())
    return b.spawn_gpu(devices=n, device="cpu", sync=True, **kw)


def assert_same_sharded(j, t):
    """Counts, growth events, the snapshot key for key (the frontier's
    rows and ebits at its live lanes), discoveries with their traces,
    cartography and the POR tallies."""
    assert isinstance(t, ShardedGpuChecker)
    assert (t.unique_state_count(), t.state_count(), t.max_depth()) == (
        j.unique_state_count(), j.state_count(), j.max_depth())
    assert t.growth_events == [(int(s), int(u)) for s, u in j.growth_events]
    js, ts = j.checkpoint(), t.final_snapshot()
    assert sorted(ts) == sorted(js)
    live = np.asarray(js["fps"]) != EMPTY
    for k in js:
        if k in ("run_id",):
            continue
        a, b = np.asarray(js[k]), np.asarray(ts[k])
        if k in ("rows", "ebits"):
            a, b = a[live], b[live]
        assert a.dtype == b.dtype or a.ndim == 0, k
        np.testing.assert_array_equal(b, a, err_msg=k)
    jd = [int(x) for x in np.asarray(j._results["disc"])]
    assert [int(x) for x in t._results["disc"]] == jd
    for fp in jd:
        if fp:
            assert t._trace(fp) == j._trace(fp)
    assert t.cartography() == j.cartography()
    assert t.por_status() == j.por_status()


@pytest.fixture(scope="module")
def jax_2pc3():
    """One JAX 2pc-3 run over 8 shards, and its snapshot at 100 unique
    (the carry a stop at that sync would give: ``more`` 1): the parity
    and cross-package resume references."""
    full = jax_sharded(JaxSys(3), 8)
    part = jax_sharded(JaxSys(3), 8, lambda b: b.target_states(100))
    snap = dict(part.checkpoint())
    snap["more"] = 1
    return full, snap


@pytest.mark.parametrize("case", ["2pc3-n8", "paxos1-n4"])
def test_sharded_matches_jax_engine(case, jax_2pc3):
    """The same run in both packages, shard for shard (``N`` = 2 is in
    ``test_torch_sharded_flags.py``, under symmetry and the pre-dedup)."""
    if case == "paxos1-n4":
        j = jax_sharded(jpaxos.paxos_model(1), 4, capacity=1 << 10,
                        frontier_capacity=1 << 8)
        t = port_sharded(paxos.paxos_model(1), 4, capacity=1 << 10,
                         frontier_capacity=1 << 8)
        assert (t.unique_state_count(), t.state_count()) == (265, 482)
    else:
        j, t = jax_2pc3[0], port_sharded(TwoPhaseSys(3), 8)
        assert t.unique_state_count() == 288
    assert_same_sharded(j, t)


def test_jax_snapshot_resumes_in_the_port(jax_2pc3):
    """A JAX sharded snapshot taken mid-run finishes in the port with the
    uninterrupted JAX run's tables, frontier and counts; after an npz round
    trip too."""
    full, snap = jax_2pc3
    buf = io.BytesIO()
    np.savez(buf, **snap)
    buf.seek(0)
    for s in (snap, dict(np.load(buf, allow_pickle=False))):
        t = TwoPhaseSys(3).checker().spawn_gpu(
            devices=8, device="cpu", sync=True, resume=s)
        assert t.unique_state_count() == 288
        assert t.parent_run_id == str(np.asarray(snap["run_id"]))
        ts, fs = t.final_snapshot(), full.checkpoint()
        for k in ("table_fp", "table_parent", "fps", "unique", "scount",
                  "disc", "depth", "cap_local"):
            np.testing.assert_array_equal(np.asarray(ts[k]),
                                          np.asarray(fs[k]), err_msg=k)


def test_port_snapshot_resumes_in_jax(jax_2pc3):
    """The port's snapshot of the same mid-run carry finishes in the JAX
    engine at the uninterrupted run's tables."""
    full, snap = jax_2pc3
    t = port_sharded(TwoPhaseSys(3), 8, lambda b: b.target_states(100))
    ps = dict(t.final_snapshot())
    np.testing.assert_array_equal(ps["table_fp"], snap["table_fp"])
    ps["more"] = 1
    j = JaxSys(3).checker().spawn_tpu(devices=8, sync=True, resume=ps)
    assert j.unique_state_count() == 288
    for a, b in zip(j._table_np(), full._table_np()):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# -- the pins of tests/test_sharded.py, on the port ---------------------------


def test_spawn_gpu_routes_devices_to_the_sharded_engine():
    """``devices=N`` and ``n_devices=N`` are the sharded engine;
    ``devices=1`` is the single-device engine, ``n_devices=1`` one shard
    (JAX ``spawn_tpu``)."""
    c = TwoPhaseSys(3).checker()
    assert isinstance(c.spawn_gpu(devices=8, device="cpu", sync=True),
                      ShardedGpuChecker)
    one = c.spawn_gpu(n_devices=1, device="cpu", sync=True)
    assert isinstance(one, ShardedGpuChecker) and one.ndev == 1
    assert one.unique_state_count() == 288
    single = c.spawn_gpu(devices=1, device="cpu", batch=64)
    assert isinstance(single, GpuChecker)
    assert single.join().unique_state_count() == 288


@pytest.mark.parametrize("n,expected", [(3, 288), (5, 8832)])
def test_sharded_2pc_pinned_counts(n, expected):
    sys = TwoPhaseSys(n)
    c = sys.checker().spawn_gpu(devices=8, device="cpu", sync=True)
    assert c.unique_state_count() == expected
    cpu = sys.checker().spawn_bfs().join()
    assert cpu.unique_state_count() == expected
    assert c.state_count() == cpu.state_count()
    assert set(c.discoveries()) == set(cpu.discoveries()) == {
        "abort agreement", "commit agreement"}
    c.assert_properties()


def test_sharded_discovery_paths_are_valid_and_shortest():
    sys = TwoPhaseSys(3)
    c = sys.checker().spawn_gpu(devices=8, device="cpu", sync=True)
    cpu = sys.checker().spawn_bfs().join()
    for name in ("abort agreement", "commit agreement"):
        path = c.discovery(name)
        assert sys.property_by_name(name).condition(sys, path.final_state())
        assert len(path) == len(cpu.discovery(name))


def test_sharded_capacity_overflow_grows():
    c = TwoPhaseSys(3).checker().spawn_gpu(
        devices=8, device="cpu", sync=True, capacity=1 << 8,
        frontier_capacity=1 << 5)
    assert c.unique_state_count() == 288
    c.assert_properties()


def test_sharded_growth_preserves_work_mid_flight():
    """Capacities far below the space force mid-run growth; every unit of
    work survives: the pinned count, the BFS's state count and
    discoveries, a monotone unique count over the growth events."""
    sys = TwoPhaseSys(5)
    c = sys.checker().spawn_gpu(
        devices=8, device="cpu", sync=True, capacity=1 << 10,
        frontier_capacity=1 << 7, steps_per_call=1)
    assert c.unique_state_count() == 8832
    cpu = sys.checker().spawn_bfs().join()
    assert c.state_count() == cpu.state_count()
    assert set(c.discoveries()) == set(cpu.discoveries())
    assert c.growth_events
    uniq = [u for _, u in c.growth_events]
    assert uniq == sorted(uniq) and all(0 < u <= 8832 for u in uniq)
    # every growth kind the step can raise but the route bucket's fired
    assert {s for s, _ in c.growth_events} == {1, 2, 4}


@pytest.mark.parametrize("status", [2, 1, 3, 4])
def test_sharded_growth_boundary_snapshot_resumes(status):
    """A snapshot carrying a growth status (a checkpoint served at a growth
    boundary: table, frontier, route bucket, candidate budget) grows on
    resume and finishes the space."""
    kw = dict(devices=8, device="cpu", capacity=1 << 13,
              frontier_capacity=1 << 9, steps_per_call=1)
    part = TwoPhaseSys(5).checker().target_states(2000).spawn_gpu(
        sync=True, **kw)
    snap = dict(part.final_snapshot())
    assert 2000 <= int(snap["unique"]) < 8832
    snap["more"], snap["status"] = 1, np.int32(status)
    c = TwoPhaseSys(5).checker().spawn_gpu(sync=True, resume=snap, **kw)
    assert c.unique_state_count() == 8832
    c.assert_properties()
    grown = {2: ("cap_local", 2 * int(snap["cap_local"])),
             1: ("fcap_local", 2 * int(snap["fcap_local"])),
             3: ("bucket_factor", 2 * int(snap["bucket_factor"])),
             4: ("cand_factor", 2 * int(snap["cand_factor"]))}[status]
    assert int(c.final_snapshot()[grown[0]]) >= grown[1]


def test_sharded_target_state_count():
    c = TwoPhaseSys(5).checker().target_states(1000).spawn_gpu(
        devices=8, device="cpu", sync=True)
    assert 1000 <= c.unique_state_count() < 8832


def test_sharded_matches_single_device_table_contents():
    sys = TwoPhaseSys(3)
    single = sys.checker().spawn_gpu(device="cpu", batch=64).join()
    sharded = sys.checker().spawn_gpu(devices=8, device="cpu", sync=True)
    assert set(single._parents()) == set(sharded._parents())
    visited = set(sharded._parents())
    for fp, parent in sharded._parents().items():
        assert parent == 0 or parent in visited


def test_sharded_on_two_devices():
    c = TwoPhaseSys(3).checker().spawn_gpu(devices=2, device="cpu",
                                           sync=True)
    assert c.unique_state_count() == 288


def test_sharded_live_progress_counters():
    c = TwoPhaseSys(5).checker().spawn_gpu(
        devices=8, device="cpu", capacity=1 << 17,
        frontier_capacity=1 << 12, steps_per_call=1)
    samples = []
    while not c.is_done():
        samples.append(c.unique_state_count())
        time.sleep(0.01)
    c.join()
    assert c.unique_state_count() == 8832
    assert samples == sorted(samples)


def test_sharded_checkpoint_resume_matches_uninterrupted():
    kw = dict(devices=8, device="cpu", capacity=1 << 15,
              frontier_capacity=1 << 10, steps_per_call=1)
    full = TwoPhaseSys(5).checker().spawn_gpu(sync=True, **kw)
    running = TwoPhaseSys(5).checker().spawn_gpu(**kw)
    snap = running.checkpoint()
    running.stop().join()
    resumed = TwoPhaseSys(5).checker().spawn_gpu(sync=True, resume=snap,
                                                 **kw)
    assert resumed.unique_state_count() == full.unique_state_count() == 8832
    assert set(resumed.discoveries()) == set(full.discoveries())
    for a, b in zip(resumed._table_np(), full._table_np()):
        np.testing.assert_array_equal(a, b)
    buf = io.BytesIO()
    np.savez(buf, **snap)
    buf.seek(0)
    loaded = dict(np.load(buf, allow_pickle=False))
    again = TwoPhaseSys(5).checker().spawn_gpu(sync=True, resume=loaded,
                                               **kw)
    assert again.unique_state_count() == 8832


def test_sharded_resume_rejects_other_model_or_mesh():
    kw = dict(devices=8, device="cpu", capacity=1 << 13,
              frontier_capacity=1 << 9)
    snap = TwoPhaseSys(3).checker().spawn_gpu(sync=True, **kw).checkpoint()
    assert snap["engine"] == "sharded" and int(snap["ndev"]) == 8
    with pytest.raises(ValueError, match="different model"):
        TwoPhaseSys(4).checker().spawn_gpu(sync=True, resume=snap, **kw)
    with pytest.raises(ValueError, match="mesh"):
        TwoPhaseSys(3).checker().spawn_gpu(
            sync=True, devices=4, device="cpu", capacity=1 << 13,
            frontier_capacity=1 << 9, resume=snap)
    # cross-engine confusion, both directions
    with pytest.raises(ValueError, match="engine"):
        TwoPhaseSys(3).checker().spawn_gpu(device="cpu", sync=True,
                                           resume=snap)
    single = TwoPhaseSys(3).checker().spawn_gpu(device="cpu", batch=64,
                                                sync=True).checkpoint()
    with pytest.raises(ValueError, match="engine"):
        TwoPhaseSys(3).checker().spawn_gpu(sync=True, resume=single, **kw)


def test_snapshot_layout_is_the_jax_layout():
    """The sharded snapshot's arrays carry the JAX dtypes, and a carry
    converts to them and back bit for bit."""
    c = TwoPhaseSys(3).checker().spawn_gpu(devices=4, device="cpu",
                                           sync=True)
    s = c.final_snapshot()
    for k, dt in zip(convert.SHARDED_SNAPSHOT_KEYS,
                     convert.SHARDED_NP_DTYPES):
        assert np.asarray(s[k]).dtype == np.dtype(dt), k
    back = convert.sharded_carry_from_arrays(
        [s[k] for k in convert.SHARDED_SNAPSHOT_KEYS], "cpu")
    for k, a in zip(convert.SHARDED_SNAPSHOT_KEYS,
                    convert.sharded_carry_to_arrays(back)):
        np.testing.assert_array_equal(a, np.asarray(s[k]), err_msg=k)
