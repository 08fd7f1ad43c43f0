"""The port's flight recorder and its producers
(``stateright_tpu_torch/telemetry/``), against the JAX package where the
two meet:

 - a JSONL written by either package's recorder reads in the other's, with
   the same records and summary, and the Chrome trace exports;
 - the GPU engine's stream: one ``step`` per block, ``growth`` records and
   spans, the ``engine_run`` span, stage seconds, occupancy samples,
   ``checkpoint`` records and the autosave manifest's run identity;
 - the host BFS, DFS and mp checkers emit the JAX record kinds;
 - the scoped profiler writes a ``torch.profiler`` trace, and a broken
   profiler records its error while the run goes on;
 - the metrics bus (typed families, the label cap, Prometheus text);
 - the CLI: ``--watch`` on a non-tty stream, and the ``profile``,
   ``capacity``, ``report`` and ``compare`` verbs.
"""

import io
import json
import os

import numpy as np
import pytest

from stateright_tpu.models.two_phase_commit import TwoPhaseSys as JaxSys
from stateright_tpu.telemetry import FlightRecorder as JaxRecorder
from stateright_tpu_torch.models import two_phase_commit as port_2pc
from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
from stateright_tpu_torch.telemetry import (
    FlightRecorder, MetricsBus, STATUS_NAMES,
)

KW = dict(device="cpu", batch=32, queue_capacity=64, capacity=1 << 12,
          steps_per_call=4)


def port_run(builder=None, **kw):
    b = TwoPhaseSys(3).checker().telemetry(cartography=True, memory=True,
                                           occupancy_every=2)
    if builder is not None:
        b = builder(b)
    return b.spawn_gpu(**{**KW, **kw}).join()


@pytest.mark.parametrize("direction", ["port-to-jax", "jax-to-port"])
def test_jsonl_reads_in_the_other_package(direction, tmp_path):
    path = str(tmp_path / "t.jsonl")
    if direction == "port-to-jax":
        rec, reader = port_run().flight_recorder, JaxRecorder
    else:
        rec = (JaxSys(3).checker().telemetry(cartography=True)
               .spawn_tpu(sync=True, capacity=1 << 12, frontier_capacity=32,
                          queue_capacity=64, steps_per_call=4)
               .flight_recorder)
        reader = FlightRecorder
    rec.to_jsonl(path)
    back = reader.from_jsonl(path)
    assert back.records() == rec.records()
    assert back.summary() == rec.summary()
    assert back.cartography() == rec.cartography()
    trace = str(tmp_path / "t.trace.json")
    back.to_chrome_trace(trace)
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    assert any(str(e.get("name")).startswith("step:") for e in events)


def test_gpu_engine_stream(tmp_path):
    c = port_run(lambda b: b.autosave(str(tmp_path / "ck"), every_secs=0.0))
    rec = c.flight_recorder
    steps = rec.records("step")
    assert steps and steps[-1]["unique"] == 288
    assert {s["engine"] for s in steps} == {"gpu-wavefront"}
    assert {"d_states", "d_unique", "dedup", "queue", "load_factor",
            "cap", "cand", "depth", "status"} <= set(steps[-1])
    growth = rec.records("growth")
    assert growth and {g["status"] for g in growth} <= STATUS_NAMES
    spans = rec.records("span")
    assert {"engine_run", "growth", "autosave"} <= {s["name"] for s in spans}
    run_span = next(s for s in spans if s["name"] == "engine_run")
    assert all(s["span"] == run_span["span_id"] for s in steps)
    stages = rec.stages()
    assert {"device_secs", "growth_secs", "checkpoint_secs", "wall_secs",
            "host_secs"} <= set(stages)
    assert stages["growth_secs"] == pytest.approx(sum(c.growth_secs),
                                                   abs=1e-5)
    occ = rec.records("occupancy")
    assert {o["at"] for o in occ} >= {"growth", "final", "sync2"}
    assert occ[-1]["occupied"] == 288
    assert c.occupancy_stats()["occupied"] == 288
    assert c.health()["phase"] == "done"
    ck = rec.records("checkpoint")
    assert ck and all(r["ok"] for r in ck)
    summary = rec.summary()
    assert summary["growth_events"] == len(growth)
    assert summary["d2h_bytes"] > 0 and summary["h2d_bytes"] > 0
    # the autosave manifest carries the run's identity and config, and a
    # resumed run records it as its parent
    from stateright_tpu_torch import checkpoint

    snap, man = checkpoint.latest_generation(str(tmp_path / "ck"))
    assert man["run_id"] == c.run_id
    assert man["config"]["engine"] == "gpu-wavefront"
    r = TwoPhaseSys(3).checker().telemetry().spawn_gpu(
        device="cpu", resume=snap).join()
    assert r.parent_run_id == c.run_id
    assert r.unique_state_count() == 288


def record_kinds(c):
    return {r["kind"] for r in c.flight_recorder.records()}


@pytest.mark.parametrize("strategy", ["bfs", "dfs", "mp"])
def test_host_checkers_emit_the_jax_record_kinds(strategy):
    def spawn(b):
        b = b.telemetry()
        if strategy == "mp":
            return b.spawn_mp_bfs(processes=2).join()
        return getattr(b, f"spawn_{strategy}")().join()

    j, t = spawn(JaxSys(3).checker()), spawn(TwoPhaseSys(3).checker())
    assert record_kinds(t) == record_kinds(j)
    assert set(t.flight_recorder.records("step")[-1]) == set(
        j.flight_recorder.records("step")[-1])
    assert t.flight_recorder.summary()["unique"] == 288
    assert t.health()["phase"] == j.flight_recorder.health()["phase"]


def test_scoped_profiler_writes_a_trace_and_survives_a_broken_one(
        tmp_path, monkeypatch):
    c = port_run(lambda b: b.telemetry(profile_steps=2,
                                       profile_dir=str(tmp_path)))
    events = c.flight_recorder.records("profile")
    assert [e["event"] for e in events] == ["start", "stop"]
    assert events[-1]["profiled_steps"] == 2
    with open(events[-1]["trace"]) as f:
        assert json.load(f)["traceEvents"]
    import torch

    def broken(*a, **k):
        raise RuntimeError("no profiler here")

    monkeypatch.setattr(torch.profiler, "profile", broken)
    c = port_run(lambda b: b.telemetry(profile_steps=2,
                                       profile_dir=str(tmp_path)))
    assert c.unique_state_count() == 288
    (ev,) = c.flight_recorder.records("profile")
    assert ev["event"] == "unavailable" and "no profiler" in ev["error"]


def test_scoped_profiler_leaves_cuda_out_with_its_reason(tmp_path,
                                                         monkeypatch):
    """A session started with a ``cuda_off`` reason (a block-graph
    engine's) asks ``torch.profiler`` for CPU activity only, even with a
    CUDA device present, and its ``start`` event carries the reason; with
    none it asks for CUDA activity too.  A CPU engine gives no reason."""
    import torch

    from stateright_tpu_torch.ops.block_loop import CUPTI_FAULT
    from stateright_tpu_torch.telemetry.profile import ScopedProfiler
    from stateright_tpu_torch.telemetry.recorder import FlightRecorder

    acts = torch.profiler.ProfilerActivity
    asked = []

    class Session:
        def __init__(self, activities):
            asked.append(list(activities))

        def start(self):
            pass

        def stop(self):
            pass

        def export_chrome_trace(self, path):
            with open(path, "w") as f:
                f.write("{}")

    monkeypatch.setattr(torch.profiler, "profile", Session)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for off in (CUPTI_FAULT, None):
        rec = FlightRecorder(capacity=64, meta={"engine": "t"})
        p = ScopedProfiler(str(tmp_path), steps=1, recorder=rec)
        p.maybe_start(off)
        p.tick()
        start, stop = rec.records("profile")
        assert (start["event"], stop["event"]) == ("start", "stop")
        assert start["cuda"] is (off is None)
        assert start.get("cuda_off") == off
    assert asked == [[acts.CPU], [acts.CPU, acts.CUDA]]
    monkeypatch.undo()
    c = port_run(lambda b: b.telemetry(profile_steps=1,
                                       profile_dir=str(tmp_path)))
    start = c.flight_recorder.records("profile")[0]
    assert start["cuda"] is False and "cuda_off" not in start


def test_metrics_bus_families_cap_and_prometheus_text():
    bus = MetricsBus(max_series=2)
    c = bus.counter("srt_states_total", "states", ("engine",))
    c.inc(3, engine="a")
    assert bus.counter("srt_states_total", "states", ("engine",)) is c
    with pytest.raises(Exception):
        bus.gauge("srt_states_total")
    with pytest.raises(ValueError):
        c.inc(-1, engine="a")
    c.inc(1, engine="b")
    with pytest.raises(Exception):
        c.inc(1, engine="c")  # the label-cardinality cap
    h = bus.histogram("srt_step_seconds", "step", buckets=(0.1, 1.0))
    h.observe(0.5)
    text = bus.expose()
    assert 'srt_states_total{engine="a"} 3' in text
    assert "# TYPE srt_step_seconds histogram" in text
    # the recorder publishes the engine families at its step records
    bus = MetricsBus()
    rec = FlightRecorder(meta={"engine": "gpu-wavefront", "model": "m"},
                         metrics=bus)
    rec.step(engine="gpu-wavefront", states=10, unique=4, queue=3)
    assert "gpu-wavefront" in bus.expose()


def test_watch_line_on_a_plain_stream():
    from stateright_tpu_torch.models._cli import apply_watch, watch_checker

    c = apply_watch(TwoPhaseSys(3).checker(), True).spawn_gpu(**KW)
    out = io.StringIO()
    watch_checker(c, stream=out, interval=0.01, plain_every=0.0)
    lines = out.getvalue().splitlines()
    assert lines and "\r" not in out.getvalue()
    assert lines[-1].startswith("depth=10 states=1146 unique=288 ")
    assert "phase=done" in lines[-1] and "mem=" in lines[-1]


def test_cli_profile_capacity_report_and_compare(tmp_path, capsys):
    main = port_2pc.main
    out = str(tmp_path / "p.jsonl")
    assert main(["profile", "3", "--device=cpu", "--batch=64", f"--out={out}",
                 f"--chrome={tmp_path / 'p.json'}"]) == 0
    assert FlightRecorder.from_jsonl(out).summary()["unique"] == 288
    assert main(["capacity", "3", "--device=cpu", "--batch=64"]) == 0
    assert "capacity plan" in capsys.readouterr().out
    a, b = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    assert main(["report", "3", "--device=cpu", "--batch=64", f"--out={a}"]) == 0
    assert main(["report", "3", "--device=cpu", "--batch=64", f"--out={b}"]) == 0
    assert os.path.exists(str(tmp_path / "a.md"))
    capsys.readouterr()
    assert main(["compare", a, b, "--expect=IDENTICAL"]) == 0
    assert "verdict: IDENTICAL" in capsys.readouterr().out
    assert main(["compare", a, b, "--expect=DIVERGENT"]) == 1
    with open(a) as f:
        doc = json.load(f)
    doc["totals"]["unique"] += 1
    with open(b, "w") as f:
        json.dump(doc, f)
    assert main(["compare", a, b]) == 1  # DIVERGENT
    assert main(["check-gpu", "3", "--device=cpu", "--batch=64", "--watch"]) == 0
    err = capsys.readouterr().err
    assert "unique=288" in err and "phase=done" in err


def test_cli_capacity_plans_the_engine_buffers(capsys):
    # the verb's first rung is the buffers a run with the same --batch=
    # starts with (2pc offers a symmetric GPU verb: the plan is its)
    from stateright_tpu_torch.telemetry.memory import fmt_bytes, total_bytes

    c = TwoPhaseSys(3).checker().symmetry().spawn_gpu(device="cpu",
                                                      batch=64).join()
    start = total_bytes(c._memory_spec_fn()(c._memory_caps()))
    capsys.readouterr()
    assert port_2pc.main(["capacity", "3", "--device=cpu", "--batch=64"]) == 0
    rung = capsys.readouterr().out.splitlines()[2].split()
    assert rung[:2] == [str(c._cap), fmt_bytes(start)]


def test_status_names_are_the_engine_words():
    from stateright_tpu_torch.parallel.wavefront import (
        _STATUS_TELEMETRY_NAMES,
    )

    assert set(_STATUS_TELEMETRY_NAMES.values()) == STATUS_NAMES
    assert np.all([isinstance(k, int) for k in _STATUS_TELEMETRY_NAMES])
