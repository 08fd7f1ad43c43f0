"""The port's live checkpoint, stop and autosave against the JAX package's
(``tests/test_checkpoint.py`` and the autosave cases of
``tests/test_robustness.py`` that use no telemetry and no faults),
tolerance 0: counts, discoveries, and the table bytes of the runs that
finish from a snapshot, equal to an uninterrupted run's and to the JAX
engine's at the same capacities.  Snapshots and autosave generations
cross between the engines both ways.  Every wait has a deadline."""

import io
import time

import numpy as np
import pytest

import jax  # noqa: F401  (both frameworks in one process, JAX on the CPU)

from stateright_tpu import checkpoint as jax_ckpt
from stateright_tpu.models.two_phase_commit import TwoPhaseSys as JaxSys
from stateright_tpu_torch import checkpoint as ckpt
from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

# 2pc pinned counts (examples/2pc.rs:125-140)
UNIQUE_2PC3, STATES_2PC3 = 288, 1146
UNIQUE_2PC5, STATES_2PC5 = 8832, 58146
# the live-checkpoint runs: about 70 blocks, so a request made as the run
# starts is served before its first block ends, mid-run
LIVE_KW = dict(batch=64, steps_per_call=2)
DEADLINE_SECS = 120.0


def port_live(n=5, builder=None):
    b = TwoPhaseSys(n).checker()
    if builder is not None:
        b = builder(b)
    return b.spawn_gpu(device="cpu", **LIVE_KW)


def npz_round_trip(snap: dict) -> dict:
    buf = io.BytesIO()
    np.savez(buf, **snap)
    buf.seek(0)
    with np.load(buf) as z:
        return {k: z[k] for k in z.files}


def assert_same_tables(port, other):
    for a, b in zip(port._table_np(), other._table_np()):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.fixture(scope="module")
def uninterrupted():
    """2pc-5 at the live runs' capacities, on both engines: the same
    counts and table bytes, the reference every resumed run ends with."""
    t = TwoPhaseSys(5).checker().spawn_gpu(device="cpu", **LIVE_KW).join()
    j = JaxSys(5).checker().spawn_tpu(sync=True, **LIVE_KW)
    assert (t.unique_state_count(), t.state_count()) == (
        j.unique_state_count(), j.state_count()) == (UNIQUE_2PC5, STATES_2PC5)
    assert_same_tables(t, j)
    return t


def wait_for(cond, what: str) -> None:
    deadline = time.monotonic() + DEADLINE_SECS
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.01)


def test_checkpoint_survives_npz_round_trip(uninterrupted):
    running = port_live()
    snap = running.checkpoint(timeout=DEADLINE_SECS)
    running.stop().join()
    assert 0 < int(snap["unique"]) < UNIQUE_2PC5, "checkpoint was not mid-run"
    assert int(snap["head"]) < int(snap["tail"])
    resumed = TwoPhaseSys(5).checker().spawn_gpu(
        device="cpu", resume=npz_round_trip(snap)).join()
    assert (resumed.unique_state_count(), resumed.state_count()) == (
        UNIQUE_2PC5, STATES_2PC5)
    resumed.assert_properties()
    assert resumed.discovery_fps() == uninterrupted.discovery_fps()
    assert_same_tables(resumed, uninterrupted)


def test_checkpoint_after_completion_is_final_state():
    checker = TwoPhaseSys(3).checker().spawn_gpu(device="cpu",
                                                 **LIVE_KW).join()
    snap = checker.checkpoint()
    assert int(snap["unique"]) == UNIQUE_2PC3  # examples/2pc.rs:128
    assert int(snap["head"]) == int(snap["tail"])
    # the JAX engine's final snapshot at the same capacities
    jsnap = JaxSys(3).checker().spawn_tpu(sync=True, **LIVE_KW).checkpoint()
    for k in ("table_fp", "table_parent", "head", "tail", "unique", "scount"):
        np.testing.assert_array_equal(snap[k], np.asarray(jsnap[k]), err_msg=k)
    # resuming a finished run is a no-op with identical results
    resumed = TwoPhaseSys(3).checker().spawn_gpu(device="cpu",
                                                 resume=snap).join()
    assert resumed.unique_state_count() == UNIQUE_2PC3
    resumed.assert_properties()


@pytest.mark.parametrize("status", [2, 1, 3])
def test_growth_boundary_checkpoint_resume(status, uninterrupted):
    """A snapshot taken at a growth boundary carries ``status != OK``:
    table full (rehash), queue full (compact), candidate budget full
    (doubles).  The resume applies the growth before stepping and finishes
    with the pinned counts."""
    running = port_live()
    snap = running.checkpoint(timeout=DEADLINE_SECS)
    running.stop().join()
    assert 0 < int(snap["unique"]) < UNIQUE_2PC5, "checkpoint was not mid-run"
    snap["status"] = np.int32(status)
    resumed = TwoPhaseSys(5).checker().spawn_gpu(device="cpu",
                                                 resume=snap).join()
    assert (resumed.unique_state_count(), resumed.state_count()) == (
        UNIQUE_2PC5, STATES_2PC5)
    resumed.assert_properties()


def test_resume_rejects_snapshot_from_different_model():
    snap = TwoPhaseSys(3).checker().spawn_gpu(
        device="cpu", **LIVE_KW).join().checkpoint()
    with pytest.raises(ValueError, match="different model"):
        TwoPhaseSys(4).checker().spawn_gpu(device="cpu", resume=snap)


def test_unserved_checkpoint_times_out(monkeypatch):
    """A request that no host sync serves raises at its deadline and is
    withdrawn, so a later sync does not serve a stale request."""
    from stateright_tpu_torch.parallel._base import WavefrontChecker

    monkeypatch.setattr(WavefrontChecker, "_at_host_sync",
                        lambda self, snap_fn: None)
    running = TwoPhaseSys(6).checker().spawn_gpu(device="cpu", **LIVE_KW)
    with pytest.raises(TimeoutError):
        running.checkpoint(timeout=0.3)
    assert not running._ckpt_req.is_set()
    running.stop().join()
    assert running.unique_state_count() < 100_000


# -- the generation store (the JAX robustness cases) --------------------------


def _snap(unique: int) -> dict:
    return {
        "unique": np.int64(unique), "scount": np.int64(unique * 3),
        "maxdepth": np.int32(4), "disc": np.zeros(3, np.uint64),
    }


@pytest.mark.parametrize("mod", [ckpt, jax_ckpt], ids=["port", "jax"])
def test_generations_rotate_and_latest_wins(tmp_path, mod):
    root = str(tmp_path)
    for i in range(5):
        mod.save_generation(
            root, i, _snap(i), {"run_id": "r", "totals": {"unique": i}},
            keep=2,
        )
    gens = mod.list_generations(root)
    assert [g["gen"] for g in gens] == [3, 4]
    assert all(g["complete"] for g in gens)
    snap, man = mod.latest_generation(root)
    assert int(snap["unique"]) == 4
    assert man["gen"] == 4 and man["v"] == ckpt.CKPT_V == jax_ckpt.CKPT_V
    # numbering continues across restarts
    assert mod.next_generation(root) == 5
    assert mod.latest_gen_number(root) == 4
    # the other package reads the same files
    other = jax_ckpt if mod is ckpt else ckpt
    osnap, oman = other.latest_generation(root)
    assert oman == man and int(osnap["unique"]) == 4


def test_torn_generation_is_skipped_loudly(tmp_path, capsys):
    """A generation without a committed manifest (or with a garbage npz) is
    TORN: resume warns and falls back to the previous complete one."""
    root = str(tmp_path)
    ckpt.save_generation(
        root, 0, _snap(7), {"run_id": "r", "totals": {"unique": 7}},
    )
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
    assert jax_ckpt.latest_generation(root)[1] == man
    assert ckpt.latest_gen_number(root) == 2  # the manifest-only view
    # a torn generation older than the newest committed manifest can never
    # be resumed from: pruning removes it
    ckpt.prune_generations(root, keep=2)
    assert [g["gen"] for g in ckpt.list_generations(root)] == [0, 2]


def test_atomic_write_leaves_no_temp_files(tmp_path):
    path = tmp_path / "doc.json"
    ckpt.atomic_write_json(str(path), {"gen": 1})
    ckpt.atomic_write_json(str(path), {"gen": 2})
    assert path.read_text() == '{\n "gen": 2\n}\n'
    assert [p.name for p in tmp_path.iterdir()] == ["doc.json"]


def test_resolve_autosave_env_knobs(monkeypatch, tmp_path, capsys):
    monkeypatch.delenv(ckpt.ENV_AUTOSAVE, raising=False)
    assert ckpt.resolve_autosave(None) is None
    monkeypatch.setenv(ckpt.ENV_AUTOSAVE, str(tmp_path))
    monkeypatch.setenv(ckpt.ENV_AUTOSAVE_SECS, "5")
    monkeypatch.setenv(ckpt.ENV_AUTOSAVE_KEEP, "junk")
    got = ckpt.resolve_autosave(None)
    assert got == {
        "dir": str(tmp_path), "every_secs": 5.0, "keep": ckpt.DEFAULT_KEEP,
    }
    assert "malformed" in capsys.readouterr().err
    assert got == jax_ckpt.resolve_autosave(None)
    # builder opts win over env
    assert ckpt.resolve_autosave({"dir": "x", "every_secs": 1, "keep": 2})[
        "dir"
    ] == "x"


# -- autosave through the engine ----------------------------------------------


def test_autosave_generations_resume_bit_identical(tmp_path):
    root = str(tmp_path / "auto")
    running = TwoPhaseSys(3).checker().autosave(
        root, every_secs=0.0, keep=2
    ).spawn_gpu(device="cpu", capacity=1 << 12, batch=32, steps_per_call=2)
    wait_for(lambda: ckpt.list_generations(root) or running.is_done(),
             "a generation")
    running.stop().join()
    gens = ckpt.list_generations(root)
    assert gens and len(gens) <= 2  # rotation held
    snap, man = ckpt.latest_generation(root)
    assert man["model"] == "TwoPhaseSys"
    assert man["engine"] == "wavefront"
    assert man["restarts"] == 0 and man["written_at"]
    assert man["totals"]["unique"] == int(snap["unique"])
    assert {p["name"] for p in man["properties"]} == {
        "abort agreement", "commit agreement", "consistent",
    }
    dur = running.durability_status()
    assert dur["autosave"]["generations"] >= 1
    assert dur["restarts"] == 0 and dur["v"] == ckpt.CKPT_V
    assert (dur["autosave"]["every_secs"], dur["autosave"]["keep"]) == (0.0, 2)
    assert len(running.autosave_secs) == dur["autosave"]["generations"]
    resumed = TwoPhaseSys(3).checker().spawn_gpu(device="cpu",
                                                 resume=snap).join()
    assert (resumed.unique_state_count(), resumed.state_count()) == (
        UNIQUE_2PC3, STATES_2PC3)
    resumed.assert_properties()
    # without autosave there is no durability block at all
    plain = TwoPhaseSys(3).checker().spawn_gpu(device="cpu", **LIVE_KW)
    assert plain.join().durability_status() is None


def test_stop_writes_a_forced_last_generation(tmp_path):
    """A long cadence saves nothing on its own: the one generation on disk
    is the forced one that the stop writes at the sync where it stops."""
    root = str(tmp_path)
    running = port_live(builder=lambda b: b.autosave(root, every_secs=3600.0))
    running.checkpoint(timeout=DEADLINE_SECS)  # the run is under way
    running.stop().join()
    gens = ckpt.list_generations(root)
    assert [g["gen"] for g in gens] == [0]
    snap, man = ckpt.latest_generation(root)
    assert int(snap["unique"]) == running.unique_state_count()
    assert man["totals"]["states"] == running.state_count()


def test_stop_at_a_due_sync_writes_one_generation(tmp_path):
    """With a generation due at every sync, the sync where the run stops
    writes one generation, not the cadence's and then a forced copy of the
    same carry: no two generations hold the same snapshot."""
    root = str(tmp_path)
    running = port_live(
        builder=lambda b: b.autosave(root, every_secs=0.0, keep=1000))
    running.checkpoint(timeout=DEADLINE_SECS)  # the run is under way
    running.stop().join()
    gens = ckpt.list_generations(root)
    assert gens and len(gens) == len(running.autosave_secs)
    snaps = []
    for g in gens:
        with np.load(f"{g['path']}/snapshot.npz") as z:
            snaps.append({k: z[k] for k in z.files})
    for a, b in zip(snaps, snaps[1:]):
        assert any(not np.array_equal(a[k], b[k]) for k in a)
    assert int(snaps[-1]["unique"]) == running.unique_state_count()


def test_timeout_writes_a_forced_last_generation(tmp_path):
    running = TwoPhaseSys(5).checker().timeout(0.0).autosave(
        str(tmp_path), every_secs=3600.0).spawn_gpu(device="cpu", **LIVE_KW)
    running.join()
    assert running.unique_state_count() < UNIQUE_2PC5
    snap, _ = ckpt.latest_generation(str(tmp_path))
    assert int(snap["unique"]) == running.unique_state_count()


def test_failed_generation_write_never_kills_the_run(tmp_path, monkeypatch,
                                                     capsys):
    def boom(*a, **k):
        raise ValueError("a manufactured write failure")

    monkeypatch.setattr(ckpt, "save_generation", boom)
    c = TwoPhaseSys(3).checker().autosave(str(tmp_path), every_secs=0.0) \
        .spawn_gpu(device="cpu", capacity=1 << 12, batch=64).join()
    assert c.unique_state_count() == UNIQUE_2PC3
    assert c.durability_status()["autosave"]["failures"] >= 1
    assert "durability degraded" in capsys.readouterr().err


def test_jax_engine_finishes_from_a_port_generation(tmp_path, uninterrupted):
    """Every sync of a port run saved (keep all), and the JAX engine
    resumed from a generation half way through."""
    root = str(tmp_path)
    TwoPhaseSys(5).checker().autosave(root, every_secs=0.0, keep=1000) \
        .spawn_gpu(device="cpu", **LIVE_KW).join()
    gens = ckpt.list_generations(root)
    assert len(gens) > 10
    mid = gens[len(gens) // 2]["path"]
    with np.load(f"{mid}/snapshot.npz") as z:
        snap = {k: z[k] for k in z.files}
    assert 0 < int(snap["unique"]) < UNIQUE_2PC5
    j = JaxSys(5).checker().spawn_tpu(sync=True, resume=snap)
    assert (j.unique_state_count(), j.state_count()) == (
        UNIQUE_2PC5, STATES_2PC5)
    assert_same_tables(uninterrupted, j)


def test_port_finishes_from_a_jax_generation(tmp_path, uninterrupted):
    root = str(tmp_path)
    JaxSys(5).checker().autosave(root, every_secs=0.0, keep=1000) \
        .spawn_tpu(sync=True, **LIVE_KW)
    gens = jax_ckpt.list_generations(root)
    assert len(gens) > 10
    mid = gens[len(gens) // 2]["path"]
    with np.load(f"{mid}/snapshot.npz") as z:
        snap = {k: z[k] for k in z.files}
    assert 0 < int(snap["unique"]) < UNIQUE_2PC5
    t = TwoPhaseSys(5).checker().spawn_gpu(device="cpu", resume=snap).join()
    assert (t.unique_state_count(), t.state_count()) == (
        UNIQUE_2PC5, STATES_2PC5)
    assert t.discovery_fps() == uninterrupted.discovery_fps()
    assert_same_tables(t, uninterrupted)
