"""The spill tier in the port (``stateright_tpu_torch/spill/``, the GPU
engine's spill paths) against the JAX package's (``stateright_tpu/spill/``,
``TpuChecker``), tolerance 0: the host index and the store, the Bloom test
bit for bit, ``lane_compact``, and 2pc-5 under a device budget that forces
eviction at the same table rung in both packages (each package's budget
from its own analytic model, ``tot(2^13) + tot(2^14) - 1``, as JAX
``tests/test_spill.py:57-71`` builds it): counts, verdicts, traces, the
final hot table, the queue rows ``[0, tail)``, the store's arrays and the
spill tallies; under symmetry too (the inject's generation order), a run
killed mid-spill and resumed both ways, and the telemetry surfaces."""

from __future__ import annotations

import contextlib
import functools
import io
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stateright_tpu.models.two_phase_commit import TwoPhaseSys as JaxSys
from stateright_tpu.ops.buckets import lane_compact as jax_lane_compact
from stateright_tpu.parallel.tensor_model import twin_or_none
from stateright_tpu.spill import HostIndex as JaxIndex
from stateright_tpu.spill import SpillStore as JaxStore
from stateright_tpu.spill import bloom_set_np as jax_bloom_set
from stateright_tpu.spill import bloom_test as jax_bloom_test
from stateright_tpu.telemetry.memory import total_bytes as jax_total
from stateright_tpu.telemetry.memory import wavefront_specs as jax_specs
from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
from stateright_tpu_torch.ops.buckets import lane_compact
from stateright_tpu_torch.parallel.wavefront import memory_spec_fn
from stateright_tpu_torch.spill import (
    SPILL_V,
    HostIndex,
    SpillStore,
    bloom_est_false_pos,
    bloom_set_np,
    bloom_test,
    bloom_test_np,
)
from stateright_tpu_torch.telemetry.memory import (
    ENV_DEVICE_BYTES,
    capacity_plan,
    snapshot_fits_guard,
    total_bytes,
)

BATCH = 128
BLOOM = 1 << 14
QCAP = 4096
KW = dict(capacity=1 << 12, batch=BATCH, queue_capacity=QCAP,
          spill_bloom_bits=BLOOM, steps_per_call=8)


def budgets(n: int, cap_fit: int, *, batch: int = BATCH, qcap: int = QCAP,
            sym: bool = False, cart: bool = False) -> tuple:
    """``(jax_budget, port_budget)``: each package's device budget that
    admits the ``cap_fit`` table rung but not the next growth, from its own
    analytic model (``cart``: with the cartography counters), so both
    evict at the same rung."""
    m = JaxSys(n)
    twin = twin_or_none(m)
    p = len(list(m.properties()))
    sp = (BLOOM, 4 * batch * twin.max_actions)
    spec = memory_spec_fn(TwoPhaseSys(n).tensor_model(), p, cuda=False,
                          spill=sp, sym=sym, cartography=cart)

    def jax_tot(cap):
        return jax_total(jax_specs(twin, p, cap, qcap, batch, spill=sp,
                                   cartography=cart))

    def port_tot(cap):
        return total_bytes(spec({"cap": cap, "qcap": qcap, "batch": batch,
                                 "cand": 4096}))

    return (jax_tot(cap_fit) + jax_tot(2 * cap_fit) - 1,
            port_tot(cap_fit) + port_tot(2 * cap_fit) - 1)


@contextlib.contextmanager
def device_bytes(budget):
    saved = {k: os.environ.get(k) for k in (ENV_DEVICE_BYTES,
                                            "STATERIGHT_TPU_CAPACITY_GUARD")}
    os.environ[ENV_DEVICE_BYTES] = str(budget)
    os.environ["STATERIGHT_TPU_CAPACITY_GUARD"] = "off"
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _builder(cls, n, sym, telemetry, checked=False):
    b = cls(n).checker().spill()
    if sym:
        b = b.symmetry()
    if checked:
        b = b.checked()
    if telemetry:
        b = b.telemetry(cartography=True, memory=True)
    return b


@functools.lru_cache(maxsize=None)
def jax_spill(n=5, sym=False, batch=BATCH, cap_fit=1 << 13, checked=False):
    jb, _ = budgets(n, cap_fit, batch=batch, sym=sym)
    with device_bytes(jb):
        return _builder(JaxSys, n, sym, False, checked).spawn_tpu(
            sync=True, **dict(KW, batch=batch))


def port_spill(n=5, sym=False, batch=BATCH, cap_fit=1 << 13, telemetry=True,
               checked=False, **kw):
    _, pb = budgets(n, cap_fit, batch=batch, sym=sym)
    with device_bytes(pb):
        return _builder(TwoPhaseSys, n, sym, telemetry, checked).spawn_gpu(
            device="cpu", **dict(KW, batch=batch, **kw)).join()


@functools.lru_cache(maxsize=None)
def jax_plain(n=5):
    return JaxSys(n).checker().spawn_tpu(sync=True, capacity=1 << 12,
                                         batch=BATCH)


@functools.lru_cache(maxsize=None)
def port_spill_5():
    return port_spill()


def _states(path):
    return [repr(s) for s in path.states()]


# -- the tiers ------------------------------------------------------------------


def test_host_index_equals_jax():
    """The same inserts (a tiny start, so it grows; repeats, first writer
    wins) give the same lookups, count, capacity and bytes."""
    rng = np.random.default_rng(7)
    fps = np.unique(rng.integers(1, 2**63, 20000, dtype=np.uint64))
    vals = fps ^ np.uint64(0xABCD)
    dup = np.asarray([5, 9, 5, 9, 5], np.uint64)
    ixs = (HostIndex(capacity=16), JaxIndex(capacity=16))
    for ix in ixs:
        ix.insert(fps[:5000], vals[:5000])
        ix.insert(fps, vals + np.uint64(1))
        ix.insert(dup, np.arange(5, dtype=np.uint64))
    (got, found), (jgot, jfound) = (ix.lookup(np.concatenate([fps, dup]))
                                    for ix in ixs)
    np.testing.assert_array_equal(got, jgot)
    np.testing.assert_array_equal(found, jfound)
    assert found.all() and got[:5000].tolist() == vals[:5000].tolist()
    assert [(len(ix), ix.capacity, ix.nbytes) for ix in ixs][0] == \
        [(len(ix), ix.capacity, ix.nbytes) for ix in ixs][1]
    assert len(ixs[0]) * 2 <= ixs[0].capacity


def test_spill_store_tiers_equal_jax(tmp_path):
    """RAM tier, disk-tier flush under a tiny budget, the portable arrays
    and the lifecycle, beside the JAX store on the same inputs."""
    fps = np.arange(1, 2001, dtype=np.uint64)
    stores = []
    for name, cls in (("port", SpillStore), ("jax", JaxStore)):
        d = tmp_path / name
        st = cls(directory=str(d), host_budget=4096)
        st.append(fps[:1000], fps[:1000] + np.uint64(10))
        assert st.append(fps[:10], fps[:10]) == 0  # re-spilled: dropped
        st.append(fps[1000:], fps[1000:] + np.uint64(10))
        stores.append((st, d))
    (p, pd), (j, jd) = stores
    assert (len(p), p.host_bytes, p.disk_bytes, p.index_bytes) == (
        len(j), j.host_bytes, j.disk_bytes, j.index_bytes)
    assert p.disk_bytes > 0 and p.contains(fps).all()
    assert not p.contains(np.asarray([5000], np.uint64)).any()
    for a, b in zip(p.to_arrays(), j.to_arrays()):
        np.testing.assert_array_equal(a, b)
    assert sorted(f.name for f in pd.glob("spill-*.bin")) == sorted(
        f.name for f in jd.glob("spill-*.bin"))
    for (f, name) in zip(sorted(pd.glob("spill-*.bin")),
                         sorted(jd.glob("spill-*.bin"))):
        assert f.read_bytes() == name.read_bytes()
    back = SpillStore.from_arrays(*p.to_arrays(), host_budget=None)
    assert len(back) == 2000 and back.contains(fps).all()
    assert back.host_bytes == 2000 * 16 and back.disk_bytes == 0
    p.close(delete=True)
    assert not list(pd.glob("spill-*.bin"))
    p.close()  # idempotent


def test_bloom_test_equals_jax_device_and_host_bit_for_bit():
    rng = np.random.default_rng(3)
    fps = np.concatenate([
        np.unique(rng.integers(1, 2**63, 8000, dtype=np.uint64)),
        rng.integers(2**63, 2**64 - 2, 500, dtype=np.uint64),  # top bit set
    ])
    members = fps[::2]
    words = bloom_set_np(np.zeros(BLOOM // 32, np.uint32), members)
    jwords = jax_bloom_set(np.zeros(BLOOM // 32, np.uint32), members)
    np.testing.assert_array_equal(words, jwords)
    dev = bloom_test(torch.from_numpy(words.view(np.int32)),
                     torch.from_numpy(fps.view(np.int64)), BLOOM).numpy()
    np.testing.assert_array_equal(
        dev, np.asarray(jax_bloom_test(jnp.asarray(jwords), jnp.asarray(fps),
                                       BLOOM)))
    np.testing.assert_array_equal(dev, bloom_test_np(words, fps))
    assert dev[::2].all()  # no false negatives
    assert 0.0 < bloom_est_false_pos(members.size, BLOOM) < 1.0
    assert bloom_est_false_pos(0, BLOOM) == 0.0


@pytest.mark.parametrize("density", [0.0, 0.3, 1.0])
def test_lane_compact_equals_jax(density):
    rng = np.random.default_rng(11)
    mask = rng.random(257) < density
    width = 300
    idx, live, count = lane_compact(torch.from_numpy(mask), width)
    jidx, jlive, jcount = jax_lane_compact(jnp.asarray(mask), width)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(live.numpy(), np.asarray(jlive))
    assert int(count) == int(jcount) == int(mask.sum())


# -- the engine under a budget ----------------------------------------------------


def _assert_same_run(c, j, *, tables=True):
    assert c.unique_state_count() == j.unique_state_count()
    assert c.state_count() == j.state_count()
    assert sorted(c.discoveries()) == sorted(j.discoveries())
    for name, path in c.discoveries().items():
        assert _states(path) == _states(j.discoveries()[name])
    ps, js = c.spill_status(), j.spill_status()
    assert ps == js
    snap, jsnap = c.final_snapshot(), j.checkpoint()
    tail = int(snap["tail"])
    assert (int(snap["head"]), tail) == (int(jsnap["head"]),
                                         int(jsnap["tail"]))
    keys = (("table_fp", "table_parent") if tables else ()) + (
        "spill_fp", "spill_parent")
    for k in keys:
        np.testing.assert_array_equal(np.asarray(snap[k]),
                                      np.asarray(jsnap[k]), err_msg=k)
    for k in ("q_rows", "q_fp", "q_ebits", "q_depth"):
        np.testing.assert_array_equal(np.asarray(snap[k])[:tail],
                                      np.asarray(jsnap[k])[:tail], err_msg=k)


def test_2pc5_under_budget_equals_jax_and_the_unconstrained_run():
    """2pc-5 under a budget below its steady footprint evicts at the
    2^13 -> 2^14 growth in both packages and equals the JAX spill run to
    the byte; counts and verdicts equal the unconstrained run's; the tiers
    partition the visited set and cartography reconciles."""
    c, j, base = port_spill_5(), jax_spill(), jax_plain()
    _assert_same_run(c, j)
    assert c.unique_state_count() == base.unique_state_count() == 8832
    assert c.state_count() == base.state_count()
    assert sorted(c.discoveries()) == sorted(base.discoveries())
    sp = c.spill_status()
    assert sp["v"] == SPILL_V and sp["evictions"] >= 1
    assert sp["host_bytes"] == sp["spilled_fps"] * 16
    assert sp["resolved_novel"] + sp["resolved_dups"] > 0
    hot = int((c._final_carry[0] != -1).sum())
    assert hot + sp["spilled_fps"] == c.unique_state_count()
    cart = c.cartography()
    assert sum(cart["depth_hist"]) == c.unique_state_count()
    assert cart["fresh_inserts"] == c.unique_state_count()
    assert sum(cart["action_hist"]) == c.state_count() - 1
    assert cart["duplicate_hits"] == c.state_count() - c.unique_state_count()
    # the growth and spill records, with the JAX status vocabulary
    rec = c.flight_recorder
    events = [r["event"] for r in rec.records("spill")]
    assert events[0] == "arm" and "evict" in events and "resolve" in events
    assert events[-1] == "final"
    assert rec.stages()["spill_secs"] >= 0


def test_2pc7_symmetry_under_budget_equals_jax():
    """Under symmetry the inject keeps generation order: 2pc-7 with a
    32-row batch evicts at the 2^12 rung and equals the JAX run."""
    c = port_spill(7, sym=True, batch=32, cap_fit=1 << 12, telemetry=False)
    j = jax_spill(7, sym=True, batch=32, cap_fit=1 << 12)
    assert c.spill_status()["evictions"] >= 1
    assert c.spill_status()["resolved_novel"] > 0
    _assert_same_run(c, j)


def test_checked_mode_composes_with_spill_under_budget():
    """The checked word rides the carry ahead of the spill tail, through
    evictions and the inject (JAX wavefront.py:953): the run equals the
    JAX checked spill run."""
    c = port_spill(checked=True, telemetry=False)
    assert c._checked and c.spill_status()["evictions"] >= 1
    _assert_same_run(c, jax_spill(checked=True))


def test_analytic_bytes_reconcile_with_the_tier_armed():
    """The ledger's buffers cover the spill tail exactly: every analytic
    byte count equals the live tensor's."""
    c = port_spill_5()
    specs = {s.name: s for s in c._memory_spec_fn()(c._memory_caps())}
    live = c.live_buffers()
    assert set(specs) == set(live)
    for name, t in live.items():
        assert t.nbytes == specs[name].nbytes, name
        assert tuple(t.shape) == specs[name].shape, name
    for name in ("spill_bloom", "pend_fp", "pend_rows", "spill_stats"):
        assert name in specs


def test_traces_span_the_tiers():
    """Discovery paths walk parents across the hot/host boundary."""
    c = port_spill_5()
    parents = c._parents()
    spilled, _ = c._spill_store.to_arrays()
    assert set(spilled.tolist()) <= set(parents)
    for name, path in c.discoveries().items():
        fps = c._trace(c.discovery_fps()[name])
        assert any(f in set(spilled.tolist()) for f in fps), name
        assert len(path) == len(fps)
    c.assert_properties()


def test_kill_and_resume_mid_spill_both_ways():
    """A checkpoint after the first eviction, through an npz round trip,
    resumes (at the same ``steps_per_call``, so the host syncs fall where
    they fell) to the uninterrupted run's final tables, queue and store in
    the port, and to its totals in the JAX engine; resuming without the
    tier armed is refused."""
    import time

    jb, pb = budgets(5, 1 << 13)
    with device_bytes(pb):
        running = TwoPhaseSys(5).checker().spill().spawn_gpu(
            device="cpu", **KW)
        snap = None
        for _ in range(2000):
            if running.is_done():
                break
            s = running.checkpoint(timeout=120.0)
            if int(s.get("spill_base", 0)) > 0 and int(s["tail"]) > int(
                    s["head"]):
                snap = s
                break
            time.sleep(0.001)
        running.stop().join()
    assert snap is not None, "never caught a mid-spill checkpoint"
    assert int(snap["spill_base"]) == len(snap["spill_fp"])
    buf = io.BytesIO()
    np.savez(buf, **snap)
    buf.seek(0)
    snap2 = dict(np.load(buf, allow_pickle=False))
    full = port_spill_5()
    with device_bytes(pb):
        r = TwoPhaseSys(5).checker().spill().spawn_gpu(
            device="cpu", resume=snap2, spill_bloom_bits=BLOOM,
            steps_per_call=KW["steps_per_call"]).join()
    assert r.unique_state_count() == full.unique_state_count()
    assert r.state_count() == full.state_count()
    assert sorted(r.discoveries()) == sorted(full.discoveries())
    assert r._cap <= 1 << 15  # the restored base kept the hot tier pinned
    rs, fs = r.final_snapshot(), full.final_snapshot()
    tail = int(fs["tail"])
    assert int(rs["tail"]) == tail
    for k in ("table_fp", "table_parent", "spill_fp", "spill_parent"):
        np.testing.assert_array_equal(rs[k], fs[k], err_msg=k)
    for k in ("q_rows", "q_fp", "q_ebits", "q_depth"):
        np.testing.assert_array_equal(rs[k][:tail], fs[k][:tail], err_msg=k)
    with device_bytes(jb):
        jr = JaxSys(5).checker().spill().spawn_tpu(
            sync=True, resume=snap2, spill_bloom_bits=BLOOM)
    assert jr.unique_state_count() == full.unique_state_count()
    assert jr.state_count() == full.state_count()
    with pytest.raises(ValueError, match="spill-tier contents"):
        TwoPhaseSys(5).checker().spawn_gpu(device="cpu", resume=snap2)


def _eviction_boundary_generations(root) -> list:
    """Every autosave generation under ``root`` taken at a table-full sync
    (the status of the eviction boundary), oldest first."""
    from stateright_tpu_torch.checkpoint import list_generations

    out = []
    for g in list_generations(str(root)):
        with np.load(os.path.join(g["path"], "snapshot.npz"),
                     allow_pickle=False) as z:
            snap = {k: z[k] for k in z.files}
        if int(snap["status"]) == 2:  # table full
            out.append(snap)
    return out


def test_resume_at_each_eviction_boundary_both_ways(tmp_path):
    """An autosave at every host sync keeps the snapshots taken at the
    evicting syncs themselves (status table-full, served before the
    eviction): the first has an empty store, a later one a store that
    grows there.  Each resumes, evicting as the run did, to the
    uninterrupted run's final tables, queue and store in the port, and to
    its totals in the JAX engine."""
    jb, pb = budgets(5, 1 << 13)
    with device_bytes(pb):
        TwoPhaseSys(5).checker().spill().autosave(
            tmp_path, every_secs=0.0, keep=1 << 20).spawn_gpu(
            device="cpu", **KW).join()
    snaps = _eviction_boundary_generations(tmp_path)
    full = port_spill_5()
    assert len(snaps) == full.spill_status()["evictions"] >= 2
    assert int(snaps[0]["spill_base"]) == 0
    assert int(snaps[-1]["spill_base"]) > 0
    fs = full.final_snapshot()
    tail = int(fs["tail"])
    for snap in snaps:
        with device_bytes(pb):
            r = TwoPhaseSys(5).checker().spill().spawn_gpu(
                device="cpu", resume=snap, spill_bloom_bits=BLOOM,
                steps_per_call=KW["steps_per_call"]).join()
        assert r.unique_state_count() == full.unique_state_count()
        assert r.state_count() == full.state_count()
        assert sorted(r.discoveries()) == sorted(full.discoveries())
        rs = r.final_snapshot()
        assert int(rs["tail"]) == tail
        for k in ("table_fp", "table_parent", "spill_fp", "spill_parent"):
            np.testing.assert_array_equal(rs[k], fs[k], err_msg=k)
        for k in ("q_rows", "q_fp", "q_ebits", "q_depth"):
            np.testing.assert_array_equal(rs[k][:tail], fs[k][:tail],
                                          err_msg=k)
        with device_bytes(jb):
            jr = JaxSys(5).checker().spill().spawn_tpu(
                sync=True, resume=snap, spill_bloom_bits=BLOOM)
        assert jr.unique_state_count() == full.unique_state_count()
        assert jr.state_count() == full.state_count()


def test_port_resumes_a_jax_mid_spill_snapshot():
    import time

    jb, pb = budgets(5, 1 << 13)
    with device_bytes(jb):
        running = JaxSys(5).checker().spill().spawn_tpu(
            **dict(KW, steps_per_call=2))
        snap = None
        for _ in range(2000):
            if running.is_done():
                break
            s = running.checkpoint(timeout=120.0)
            if int(s.get("spill_base", 0)) > 0 and int(s["tail"]) > int(
                    s["head"]):
                snap = s
                break
            time.sleep(0.001)
        running.stop()
        running.join()
    assert snap is not None, "never caught a mid-spill checkpoint"
    with device_bytes(pb):
        r = TwoPhaseSys(5).checker().spill().spawn_gpu(
            device="cpu", resume=snap, spill_bloom_bits=BLOOM).join()
    assert r.unique_state_count() == 8832
    assert r.state_count() == jax_plain().state_count()


def test_snapshot_fits_guard_counts_the_hot_tier_only(monkeypatch, capsys):
    snap = {"table_fp": np.zeros(1024, np.uint64),
            "spill_fp": np.zeros(1 << 20, np.uint64),
            "spill_parent": np.zeros(1 << 20, np.uint64)}
    monkeypatch.setenv(ENV_DEVICE_BYTES, str(64 * 1024))
    monkeypatch.delenv("STATERIGHT_TPU_CAPACITY_GUARD", raising=False)
    snapshot_fits_guard(snap, "test")
    assert "capacity guard" not in capsys.readouterr().err
    snap["table_fp"] = np.zeros(1 << 20, np.uint64)
    snapshot_fits_guard(snap, "test")
    assert "capacity guard" in capsys.readouterr().err


def test_capacity_plan_spill_column_and_verb(capsys, monkeypatch):
    tm = TwoPhaseSys(3).tensor_model()
    spec_fn = memory_spec_fn(tm, 3, cuda=False)
    caps = {"cap": 1 << 12, "qcap": 1 << 11, "batch": 64, "cand": 4096}
    budget = total_bytes(spec_fn(caps)) * 8
    plain = capacity_plan(spec_fn, caps, budget=budget)
    sp = capacity_plan(spec_fn, caps, budget=budget, spill=True,
                       spill_host_bytes=1 << 30)
    assert "spill" not in plain
    assert sp["spill"]["hot_max_unique"] == plain["max_unique"]
    assert sp["spill"]["host_max_unique"] == (1 << 30) // 16
    assert sp["max_unique"] == plain["max_unique"] + (1 << 30) // 16
    assert "spill" not in capacity_plan(spec_fn, caps, spill=True)
    from stateright_tpu_torch.models import two_phase_commit

    monkeypatch.setenv(ENV_DEVICE_BYTES, str(1 << 24))
    monkeypatch.setenv("STATERIGHT_TPU_HOST_BYTES", str(1 << 30))
    assert two_phase_commit.main(["capacity", "3", "--spill",
                                  "--device=cpu"]) == 0
    out = capsys.readouterr().out
    assert "with --spill the hot tier holds" in out
    assert f"{(1 << 30) // 16:,} more" in out


def test_health_turns_oom_risk_into_the_spill_forecast():
    from stateright_tpu_torch.telemetry.health import HealthTracker

    def drive(tracker):
        tracker.set_memory_forecast(10_000, 5_000)  # transient > budget
        events = []
        for _ in range(3):
            events += tracker.update({"d_states": 100, "d_unique": 50,
                                      "dt": 0.1, "queue": 10,
                                      "load_factor": 0.2})
        return events

    plain = HealthTracker()
    assert any(e["event"] == "growth_oom_risk" for e in drive(plain))
    armed = HealthTracker()
    armed.spill_armed = True
    evs = drive(armed)
    assert any(e["event"] == "spill_forecast" for e in evs)
    assert not any(e["event"] == "growth_oom_risk" for e in evs)
    snap = armed.snapshot()
    assert snap["oom_risk"] is False and snap["spill_forecast"] is True
    assert any(e["event"] == "spill_forecast_cleared"
               for e in armed.mark_done())
    # the engine arms it on its recorder
    c = port_spill_5()
    assert c.flight_recorder._health.spill_armed


def test_chrome_trace_carries_the_spill_counters(tmp_path):
    from stateright_tpu_torch.telemetry.export import from_chrome_trace

    path = tmp_path / "trace.json"
    port_spill_5().flight_recorder.to_chrome_trace(path)
    counters = {}
    for e in from_chrome_trace(path)["events"]:
        if e["ph"] == "C":
            counters.setdefault(e["name"], []).append(e)
    assert "spill_bytes" in counters and "bloom_filter" in counters
    assert all("host_bytes" in e["args"] for e in counters["spill_bytes"])


def test_report_and_summary_carry_the_spill_block(tmp_path):
    from stateright_tpu_torch.telemetry.report import (
        build_report,
        write_report,
    )

    c = port_spill_5()
    rep = build_report(c)
    assert rep["spill"] == c.spill_status()
    assert rep["spill"]["evictions"] >= 1
    assert c.flight_recorder.summary()["spill"]["spilled_fps"] > 0
    write_report(c, str(tmp_path / "r.json"))
    md = (tmp_path / "r.md").read_text()
    assert "Spill tier" in md and "Bloom filter" in md


def test_jax_and_port_spill_reports_diff_identical(tmp_path):
    """The run reports of 2pc-5 under the budget (``.report()`` implies
    cartography and the memory ledger) compare ``IDENTICAL`` or
    ``PERF-ONLY`` with no violation, with equal spill and cartography
    blocks and growth events."""
    import json

    from stateright_tpu_torch.telemetry.diff import (
        IDENTICAL,
        PERF_ONLY,
        diff_reports,
    )

    j, t = str(tmp_path / "j.json"), str(tmp_path / "t.json")
    jb, pb = budgets(5, 1 << 13, cart=True)
    with device_bytes(jb):
        JaxSys(5).checker().spill().report(j).spawn_tpu(sync=True, **KW)
    with device_bytes(pb):
        TwoPhaseSys(5).checker().spill().report(t).spawn_gpu(
            device="cpu", **KW).join()
    a, b = (json.load(open(p)) for p in (j, t))
    d = diff_reports(a, b)
    assert d["verdict"] in (IDENTICAL, PERF_ONLY), d
    assert d["violations"] == []
    assert a["spill"] == b["spill"] and b["spill"]["evictions"] >= 1
    assert a["cartography"] == b["cartography"]
    assert a["growth_events"] == b["growth_events"]


def test_resolution_skips_when_nothing_spilled():
    """No budget, no eviction: the filter stays zero, nothing defers, and
    a plain run exposes no spill status."""
    c = TwoPhaseSys(3).checker().spill().spawn_gpu(
        device="cpu", capacity=1 << 12, batch=64,
        spill_bloom_bits=BLOOM).join()
    sp = c.spill_status()
    assert sp["evictions"] == sp["spilled_fps"] == 0
    assert sp["deferred"] == sp["resolved_novel"] == 0
    assert c.inject_calls == 0
    base = TwoPhaseSys(3).checker().spawn_gpu(device="cpu", capacity=1 << 12,
                                              batch=64).join()
    assert c.unique_state_count() == base.unique_state_count() == 288
    assert base.spill_status() is None


def _offload_budget(n=5, batch=64, qcap=512):
    tm = TwoPhaseSys(n).tensor_model()
    spec = memory_spec_fn(tm, 3, cuda=False,
                          spill=(BLOOM, 4 * batch * tm.max_actions))
    steady = total_bytes(spec({"cap": 8192, "qcap": qcap, "batch": batch,
                               "cand": 4096}))
    return 2 * steady - 1


def test_offloaded_rows_keep_the_depth_histogram_reconciled():
    """A run that ends (target hit) with frontier rows still offloaded to
    the host keeps ``sum(depth_hist) == unique``: offloaded depth lanes
    are banked, and un-banked at refill (JAX tests/test_spill.py:320)."""
    with device_bytes(_offload_budget()):
        c = (TwoPhaseSys(5).checker().spill().telemetry(cartography=True)
             .target_states(6000)
             .spawn_gpu(device="cpu", capacity=1 << 12, batch=64,
                        queue_capacity=512, spill_bloom_bits=BLOOM,
                        steps_per_call=4).join())
    sp = c.spill_status()
    assert sp["queue_offloaded"] > 0 and sp["queue_host_rows"] > 0
    cart = c.cartography()
    assert sum(cart["depth_hist"]) == c.unique_state_count()
    assert cart["fresh_inserts"] == c.unique_state_count()


@pytest.mark.medium
def test_queue_offload_under_a_queue_blocking_budget():
    """A budget that blocks the queue doubling too: the frontier's tail
    rides the host FIFO and refills as the queue drains; counts equal the
    unconstrained run's and every offloaded row comes back (JAX
    tests/test_spill.py:297)."""
    with device_bytes(_offload_budget()):
        c = (TwoPhaseSys(5).checker().spill()
             .spawn_gpu(device="cpu", capacity=1 << 12, batch=64,
                        queue_capacity=512, spill_bloom_bits=BLOOM,
                        steps_per_call=4).join())
    assert c.unique_state_count() == 8832
    assert c.state_count() == jax_plain().state_count()
    sp = c.spill_status()
    assert sp["queue_offloaded"] > 0
    assert sp["queue_offloaded"] == sp["queue_refilled"]
    assert sp["queue_host_rows"] == 0


@pytest.mark.slow
def test_2pc7_under_budget_on_the_cpu():
    """The acceptance run (JAX tests/test_spill.py:643-689) on the plain
    path: 2pc-7 under a budget that blocks the 2^20 -> 2^21 growth."""
    tm = TwoPhaseSys(7).tensor_model()
    batch, qcap = 1024, 1 << 17
    spec = memory_spec_fn(tm, 3, cuda=False, cartography=True,
                          spill=(BLOOM, 4 * batch * tm.max_actions))

    def tot(cap):
        return total_bytes(spec({"cap": cap, "qcap": qcap, "batch": batch,
                                 "cand": 4096}))

    with device_bytes(tot(1 << 20) + tot(1 << 21) - 1):
        c = (TwoPhaseSys(7).checker().spill()
             .telemetry(cartography=True, memory=True)
             .spawn_gpu(device="cpu", capacity=1 << 17, queue_capacity=qcap,
                        batch=batch, steps_per_call=64,
                        spill_bloom_bits=BLOOM).join())
    assert c.unique_state_count() == 296448
    assert c.spill_status()["evictions"] >= 1
    cart = c.cartography()
    assert sum(cart["depth_hist"]) == c.unique_state_count()
    assert sum(cart["action_hist"]) == c.state_count() - 1
    c.assert_properties()
