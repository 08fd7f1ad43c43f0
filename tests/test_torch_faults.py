"""The port's fault-injection layer (``stateright_tpu_torch/testing/
faults.py``) against the JAX package's (``stateright_tpu/testing/
faults.py``; the port's counterparts of ``tests/test_robustness.py:
63-145``), tolerance 0: plans written by either package load in the other
and fire at the same occurrences, a seeded schedule is the same plan in
both, and the ``fault`` ring record carries the JAX fields.  Also the
seams that need no engine run: the atomic write, the generation write and
the spill store's flush."""

import errno
import json

import numpy as np
import pytest

import jax  # noqa: F401  (both frameworks in one process, JAX on the CPU)

from stateright_tpu.telemetry import FlightRecorder as JaxRecorder
from stateright_tpu.testing import faults as jax_faults
from stateright_tpu_torch import checkpoint as ckpt
from stateright_tpu_torch.spill import SpillStore
from stateright_tpu_torch.telemetry import FlightRecorder
from stateright_tpu_torch.telemetry._atomic import (
    atomic_write_json,
    durable_append_line,
)
from stateright_tpu_torch.testing import faults
from stateright_tpu_torch.testing.faults import (
    Fault,
    FaultPlan,
    InjectedKill,
    InjectedOOM,
    fire,
)

PACKAGES = {"port": faults, "jax": jax_faults}


def test_sites_and_actions_are_the_jax_packages():
    assert faults.SITES == jax_faults.SITES
    assert faults.ACTIONS == jax_faults.ACTIONS
    assert faults.FAULT_V == jax_faults.FAULT_V


def test_fault_plan_fires_once_at_the_scheduled_occurrence():
    plan = FaultPlan([Fault(site="host_sync", action="kill", at=2)])
    with plan:
        fire("host_sync")  # 0
        fire("host_sync")  # 1
        with pytest.raises(InjectedKill):
            fire("host_sync")  # 2: fires
        fire("host_sync")  # 3: one-shot, never again
    assert plan.fired == [{"site": "host_sync", "action": "kill", "at": 2}]
    assert plan.faults[0].fired


def test_fault_plan_uninstalled_is_inert():
    plan = FaultPlan([Fault(site="host_sync", action="kill", at=0)])
    fire("host_sync")  # no plan installed: nothing can fire
    assert plan.fired == [] and faults.active() is None


def test_fault_plan_sites_are_independent_counters():
    plan = FaultPlan([
        Fault(site="growth", action="oom", at=1),
        Fault(site="spill_flush", action="enospc", at=0),
    ])
    with plan:
        fire("growth")  # growth[0]: not yet
        with pytest.raises(OSError) as ei:
            fire("spill_flush")
        assert ei.value.errno == errno.ENOSPC
        with pytest.raises(InjectedOOM) as oi:
            fire("growth")
        assert "RESOURCE_EXHAUSTED" in str(oi.value)


def test_fault_plan_rejects_unknown_site_and_action():
    with pytest.raises(ValueError):
        FaultPlan([Fault(site="nope")])
    with pytest.raises(ValueError):
        FaultPlan([Fault(site="growth", action="nope")])


@pytest.mark.parametrize("seed", [0, 1, 7, 42, 2024])
@pytest.mark.parametrize("site", ["host_sync", "growth", "snapshot_write"])
def test_seeded_schedule_is_the_same_plan_in_both_packages(seed, site):
    a = FaultPlan.scheduled(seed, site, "oom", lo=1, hi=32)
    b = jax_faults.FaultPlan.scheduled(seed, site, "oom", lo=1, hi=32)
    assert a.to_json() == b.to_json()
    assert 1 <= a.faults[0].at < 32
    assert FaultPlan.scheduled(seed, site).faults[0].at == \
        jax_faults.FaultPlan.scheduled(seed, site).faults[0].at


def _drive(pkg, plan, sites: list) -> list:
    """Fire ``sites`` in order under ``plan``; the index and class name
    of each firing."""
    out = []
    with plan:
        for i, site in enumerate(sites):
            try:
                pkg.fire(site, step=i)
            except (pkg.InjectedFault, OSError) as e:
                out.append((i, type(e).__name__))
    return out


SCHEDULE = [
    {"site": "host_sync", "action": "kill", "at": 3},
    {"site": "growth", "action": "oom", "at": 1},
    {"site": "atomic_write", "action": "io", "at": 0},
    {"site": "spill_flush", "action": "enospc", "at": 2},
]
SITES_FIRED = ["host_sync", "growth", "atomic_write", "host_sync",
               "growth", "spill_flush", "host_sync", "spill_flush",
               "host_sync", "spill_flush", "growth", "host_sync"]


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_a_plan_file_from_either_package_fires_the_same_in_the_other(
        tmp_path, writer, reader):
    w, r = PACKAGES[writer], PACKAGES[reader]
    path = tmp_path / "plan.json"
    plan = w.FaultPlan.from_json({"v": 1, "seed": 5, "faults": SCHEDULE})
    path.write_text(json.dumps(plan.to_json()))
    back = r.FaultPlan.from_file(str(path))
    assert back.to_json() == plan.to_json()
    got_w = _drive(w, plan, SITES_FIRED)
    got_r = _drive(r, back, SITES_FIRED)
    assert got_w == got_r == [(2, "OSError"), (4, "InjectedOOM"),
                              (8, "InjectedKill"), (9, "OSError")]
    assert plan.fired == back.fired
    out_w, out_r = tmp_path / "w.jsonl", tmp_path / "r.jsonl"
    plan.to_jsonl(str(out_w))
    back.to_jsonl(str(out_r))
    assert out_w.read_text() == out_r.read_text()


def test_fault_plan_jsonl_trail(tmp_path):
    plan = FaultPlan([Fault(site="growth", action="io", at=0)], seed=3)
    with plan:
        with pytest.raises(OSError):
            fire("growth", unique=17)
    out = tmp_path / "faults.jsonl"
    plan.to_jsonl(str(out))
    lines = [json.loads(ln) for ln in out.read_text().splitlines()]
    assert lines[0]["kind"] == "plan" and lines[0]["seed"] == 3
    assert lines[1] == {"kind": "fired", "site": "growth", "action": "io",
                        "at": 0, "unique": 17}


def test_fault_ring_record_has_the_jax_fields():
    recs = []
    for pkg, rec in ((faults, FlightRecorder()),
                     (jax_faults, JaxRecorder())):
        plan = pkg.FaultPlan([pkg.Fault(site="host_sync", action="kill",
                                        at=1)])
        with plan:
            pkg.fire("host_sync", recorder=rec)
            with pytest.raises(pkg.InjectedKill):
                pkg.fire("host_sync", recorder=rec, step=1)
        (r,) = rec.records("fault")
        recs.append({k: v for k, v in r.items() if k not in ("t", "seq")})
    assert recs[0] == recs[1] == {"kind": "fault", "v": 1,
                                  "site": "host_sync", "action": "kill",
                                  "at": 1}


# -- the seams that need no engine run ----------------------------------------


def test_atomic_write_failure_leaves_old_contents(tmp_path):
    path = tmp_path / "doc.json"
    atomic_write_json(str(path), {"gen": 1})
    plan = FaultPlan([Fault(site="atomic_write", action="io", at=0)])
    with plan:
        with pytest.raises(OSError):
            atomic_write_json(str(path), {"gen": 2})
    assert json.loads(path.read_text()) == {"gen": 1}
    assert [p.name for p in tmp_path.iterdir()] == ["doc.json"]  # no litter


def test_ledger_append_fires_the_atomic_write_seam(tmp_path):
    path = tmp_path / "index.jsonl"
    durable_append_line(str(path), '{"a": 1}')
    plan = FaultPlan([Fault(site="atomic_write", action="enospc", at=0)])
    with plan:
        with pytest.raises(OSError) as ei:
            durable_append_line(str(path), '{"a": 2}')
    assert ei.value.errno == errno.ENOSPC
    assert path.read_text() == '{"a": 1}\n'


def _snap(unique: int) -> dict:
    return {"unique": np.int64(unique), "scount": np.int64(unique * 3),
            "maxdepth": np.int32(4), "disc": np.zeros(3, np.uint64)}


def test_failed_snapshot_write_preserves_previous_generation(tmp_path):
    root = str(tmp_path)
    ckpt.save_generation(root, 0, _snap(3),
                         {"run_id": "r", "totals": {"unique": 3}})
    plan = FaultPlan([Fault(site="snapshot_write", action="enospc", at=0)])
    with plan:
        with pytest.raises(OSError):
            ckpt.save_generation(root, 1, _snap(9),
                                 {"run_id": "r", "totals": {"unique": 9}})
    snap, man = ckpt.latest_generation(root)
    assert int(snap["unique"]) == 3 and man["gen"] == 0
    assert plan.fired == [{"site": "snapshot_write", "action": "enospc",
                           "at": 0, "gen": 1}]


def test_torn_generation_is_skipped_loudly(tmp_path, capsys):
    """A generation without a committed manifest, or with an unreadable
    npz, is torn: resume warns and falls back to the previous one."""
    root = str(tmp_path)
    ckpt.save_generation(root, 0, _snap(7),
                         {"run_id": "r", "totals": {"unique": 7}})
    torn = tmp_path / "gen-000001"
    torn.mkdir()
    (torn / "snapshot.npz").write_bytes(b"\x00garbage")
    torn2 = tmp_path / "gen-000002"
    torn2.mkdir()
    (torn2 / "snapshot.npz").write_bytes(b"not-an-npz")
    (torn2 / "MANIFEST.json").write_text('{"v": 1, "gen": 2}\n')
    snap, man = ckpt.latest_generation(root)
    assert int(snap["unique"]) == 7 and man["gen"] == 0
    err = capsys.readouterr().err
    assert "torn generation" in err and "unreadable" in err


def test_spill_store_degrades_on_enospc_instead_of_crashing(capsys):
    store = SpillStore(host_budget=1)  # any append overflows the budget
    fps = np.arange(1, 300, dtype=np.uint64)
    plan = FaultPlan([Fault(site="spill_flush", action="enospc", at=0)])
    with plan:
        store.append(fps, fps)
    assert store.degraded
    assert "enospc" in (store.degraded_reason or "").lower()
    assert "degraded" in capsys.readouterr().err
    # exactness survives: the index and the RAM segments are intact
    assert store.disk_bytes == 0 and store.host_bytes > 0
    assert bool(store.contains(np.asarray([5], np.uint64))[0])
    store.append(fps + 1000, fps)  # warn once, never retry
    assert store.disk_bytes == 0
    assert "degraded" not in capsys.readouterr().err
    got = np.concatenate([f for f, _ in store.iter_segments()])
    assert got.size == len(store)
    store.close()


def test_no_fault_plan_outlives_this_file():
    """Runs last in the file (the test workers run a file's tests in
    order, in one process): every plan armed above was disarmed, so no
    later file's run in the same process meets its faults."""
    assert faults.active() is None
