"""The port's progress heartbeat, the ``status`` verb and the supervised
span chain, against the JAX package's (the port's counterparts of
``tests/test_observability.py:188-266`` and :327-364), tolerance 0 on
every count: ``ProgressHeartbeat`` beats, throttles and writes the JAX
document's keys, ``read_progress`` gives the same verdicts, an
autosave-armed run leaves a terminal ``done`` heartbeat with its counts,
``status`` renders live, dead and finished runs, and a supervised run's
spans chain attempt -> engine_run -> autosave under the caller's parent."""

import json
import time

import jax  # noqa: F401  (both frameworks in one process, JAX on the CPU)

from stateright_tpu import checkpoint as jax_ckpt
from stateright_tpu.telemetry import FlightRecorder as JaxRecorder
from stateright_tpu_torch.checkpoint import (
    PROGRESS_FILE,
    STALE_FACTOR,
    ProgressHeartbeat,
    read_progress,
)
from stateright_tpu_torch.models._cli import fleet_status
from stateright_tpu_torch.models._cli import main as cli_main
from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
from stateright_tpu_torch.supervisor import supervise
from stateright_tpu_torch.telemetry import FlightRecorder
from stateright_tpu_torch.telemetry.spans import SpanContext
from stateright_tpu_torch.testing.faults import Fault, FaultPlan


def test_heartbeat_constants_are_the_jax_packages():
    assert (PROGRESS_FILE, STALE_FACTOR) == (jax_ckpt.PROGRESS_FILE,
                                              jax_ckpt.STALE_FACTOR)
    assert jax_ckpt.PROGRESS_V == 1


def test_heartbeat_beats_throttle_and_verdicts(tmp_path):
    rec = FlightRecorder(capacity=64, meta={"engine": "t"})
    rec.step(engine="single", dt=0.1, states=10, unique=5)
    hb = ProgressHeartbeat(str(tmp_path), every_secs=30.0)
    assert hb.beat(rec) is True  # the first beat always lands
    assert hb.beat(rec) is False  # throttled
    assert hb.beat(rec, force=True) is True
    doc = read_progress(str(tmp_path))
    assert doc["status"] == "running" and doc["verdict"] == "running"
    assert doc["states"] == 10 and doc["unique"] == 5
    assert doc["fresh"] is True
    hb.beat(rec, status="done", force=True)
    assert read_progress(str(tmp_path))["verdict"] == "done"
    assert hb.beats == 3


def test_heartbeat_document_has_the_jax_keys(tmp_path):
    """The same recorder history beaten by both packages' heartbeats gives
    documents with the same keys and counters (``ts`` aside)."""
    docs = []
    for pkg_hb, rec in ((ProgressHeartbeat, FlightRecorder(capacity=64)),
                        (jax_ckpt.ProgressHeartbeat, JaxRecorder(capacity=64))):
        rec.step(engine="single", dt=0.1, states=10, unique=5, depth=2,
                 queue=3)
        rec.step(engine="single", dt=0.1, states=30, unique=12, depth=3,
                 queue=7)
        d = tmp_path / pkg_hb.__module__.replace(".", "_")
        d.mkdir()
        pkg_hb(str(d), meta={"model": "M"}).beat(rec, force=True)
        doc = json.loads((d / PROGRESS_FILE).read_text())
        doc.pop("ts")
        docs.append({k: v for k, v in doc.items()
                     if k not in ("ewma_states_per_sec", "eta_secs")})
    assert docs[0] == docs[1]
    assert docs[0]["steps"] == 2 and docs[0]["unique"] == 12


def test_stale_running_heartbeat_reads_dead(tmp_path):
    p = tmp_path / PROGRESS_FILE
    doc = {"v": 1, "status": "running", "ts": time.time() - 120.0,
           "every_secs": 1.0, "states": 42, "unique": 17}
    p.write_text(json.dumps(doc))
    back = read_progress(str(tmp_path))
    assert back["verdict"] == "dead" and back["fresh"] is False
    assert back["states"] == 42
    assert jax_ckpt.read_progress(str(tmp_path))["verdict"] == "dead"
    doc["status"] = "done"  # a finished heartbeat never goes dead
    p.write_text(json.dumps(doc))
    assert read_progress(str(tmp_path))["verdict"] == "done"
    assert read_progress(str(tmp_path / "absent")) is None


def test_a_failed_beat_is_dropped_and_never_kills(tmp_path):
    hb = ProgressHeartbeat(str(tmp_path))
    plan = FaultPlan([Fault(site="atomic_write", action="io", at=0)])
    with plan:
        assert hb.beat(force=True) is False
    assert plan.fired and hb.beats == 0
    assert hb.beat(force=True) is True


def test_autosave_armed_run_writes_terminal_heartbeat(tmp_path):
    c = TwoPhaseSys(3).checker().telemetry().autosave(
        str(tmp_path), every_secs=3600.0).spawn_gpu(
        device="cpu", capacity=1 << 12, batch=64).join()
    doc = read_progress(str(tmp_path))
    assert doc is not None and doc["verdict"] == "done"
    assert doc["states"] == c.state_count() == 1146
    assert doc["unique"] == c.unique_state_count() == 288
    assert doc["engine"] == "gpu-wavefront" and doc["model"] == "TwoPhaseSys"
    assert c._heartbeat.beats >= 2  # at the first sync, and the last one


def test_a_failed_run_leaves_a_failed_heartbeat(tmp_path):
    plan = FaultPlan([Fault(site="host_sync", action="kill", at=1)])
    with plan:
        c = TwoPhaseSys(3).checker().autosave(
            str(tmp_path), every_secs=0.0).spawn_gpu(
            device="cpu", batch=32, steps_per_call=2)
        c._thread.join(60)
    assert c._run_error is not None
    assert read_progress(str(tmp_path))["verdict"] == "failed"


def test_status_verb_reports_live_and_dead_runs(tmp_path, capsys):
    (tmp_path / PROGRESS_FILE).write_text(json.dumps(
        {"v": 1, "status": "done", "ts": time.time(), "every_secs": 1.0,
         "jobs": 2, "completed": 2}))
    dead = tmp_path / "jobs" / "killed"
    dead.mkdir(parents=True)
    (dead / PROGRESS_FILE).write_text(json.dumps(
        {"v": 1, "status": "running", "ts": time.time() - 300.0,
         "every_secs": 1.0, "states": 7, "phase": "explore"}))
    live = tmp_path / "jobs" / "ok"
    live.mkdir()
    (live / PROGRESS_FILE).write_text(json.dumps(
        {"v": 1, "status": "running", "ts": time.time(),
         "every_secs": 1.0, "states": 3}))
    assert fleet_status([str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "DONE" in out
    assert "jobs/killed: DEAD" in out and "states=7" in out
    assert "jobs/ok: RUNNING" in out
    empty = tmp_path / "nothing"
    empty.mkdir()
    assert fleet_status([str(empty)]) == 1  # a loud exit 1
    assert cli_main(["status", str(tmp_path)]) == 0
    assert cli_main([]) == 2


def test_supervised_run_span_chain(tmp_path):
    """attempt -> engine_run -> autosave under an injected parent, and the
    builder's context restored afterwards; an unparented run roots a fresh
    trace."""
    b = TwoPhaseSys(3).checker().telemetry()
    parent = SpanContext()
    b._span_ctx = parent
    res = supervise(b, autosave_dir=str(tmp_path / "auto"), every_secs=0.0,
                    max_restarts=0, sleep=lambda s: None, device="cpu",
                    capacity=1 << 12, batch=64)
    spans = res.checker.flight_recorder.records("span")
    att = [s for s in spans if s["name"] == "attempt"]
    run = [s for s in spans if s["name"] == "engine_run"]
    saves = [s for s in spans if s["name"] == "autosave"]
    assert len(att) == 1 and len(run) == 1 and saves
    assert att[0]["parent_id"] == parent.span_id
    assert run[0]["parent_id"] == att[0]["span_id"]
    assert all(s["parent_id"] == run[0]["span_id"] for s in saves)
    assert {s["trace_id"] for s in spans} == {parent.trace_id}
    assert b._span_ctx is parent
    steps = res.checker.flight_recorder.records("step")
    assert steps and all(s["span"] == run[0]["span_id"] for s in steps)
    c2 = TwoPhaseSys(3).checker().telemetry().spawn_gpu(
        device="cpu", capacity=1 << 12, batch=64).join()
    roots = c2.flight_recorder.records("span")
    assert [s["name"] for s in roots] == ["engine_run"]
    assert "parent_id" not in roots[0]
