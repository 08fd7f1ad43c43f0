"""Engine prewarm, the persistent compile cache and compile-time attribution
(``stateright_tpu_torch/parallel/prewarm.py``) against the JAX package's
(``stateright_tpu/parallel/prewarm.py``; the port's counterparts of
``tests/test_perf_round.py:141-342``), on the CPU:

 - the prewarmer's contract, the same scenarios run on both classes with
   the same outcomes;
 - a growth boundary of a prewarmed 2pc-3 run on ``device="cpu"`` equals
   the JAX engine's prewarmed run (counts, growth events, table bytes,
   queue rows, traces and the ``(rung, cap, qcap, cand)`` sequence of the
   ``compile`` events), every rung after ``init`` served by the
   ``stateright-prewarm`` thread, and the same run without prewarm leaves
   the same tables;
 - the compile cache: the native module (``g++``) builds into the
   builder's directory in one process (a miss) and loads from it in the
   next (a hit), through the builder and through the env knob;
 - the verbs' ``--prewarm`` and ``--compile-cache=DIR``, and the stage
   breakdown and a report diff with prewarm on against off (PERF-ONLY);
 - the recorded differences from JAX: the cache holds the kernel library
   and the native module, not engines; engines are per checker, so a
   growth rung in a second process reads ``fresh``; no
   ``donation_supported``.
"""

import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

import jax  # noqa: F401  (both frameworks in one process, JAX on the CPU)
import torch

from stateright_tpu.models.two_phase_commit import TwoPhaseSys as JaxSys
from stateright_tpu.parallel import prewarm as jax_prewarm
from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
from stateright_tpu_torch.parallel import prewarm
from stateright_tpu_torch.parallel import wavefront
from test_torch_engine import assert_same_run

REPO = Path(__file__).resolve().parent.parent
PACKAGES = {"jax": jax_prewarm, "port": prewarm}
# JAX's growth-boundary setup (tests/test_perf_round.py:221-270): batch 8 x
# arity 17 lanes clamp the budget to full width, and 1,024 slots force one
# table doubling at 258 unique, a full sync after the 1/16-load gate
GROWTH_CAPS = dict(capacity=1 << 10, batch=8, steps_per_call=1,
                   queue_capacity=1 << 12)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The port's runs here on one torch thread: their tensors are small,
    and under several test workers the default thread pool oversubscribes
    the host's cores many times over.  Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def no_cache_dir_left():
    """The compile cache directory is process-wide: every test leaves it
    at the default."""
    yield
    prewarm.disable_persistent_compile_cache()
    assert prewarm.compile_cache_dir() == prewarm.DEFAULT_CACHE_DIR


def wait_ready(p, key, secs=20.0):
    deadline = time.monotonic() + secs
    while not p.ready(key):
        assert time.monotonic() < deadline, "background build hung"
        time.sleep(0.01)


# -- the prewarmer, held to JAX's ------------------------------------------------


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_prewarmer_ready_rung_swaps_in_without_blocking(pkg):
    """Once the background build finished, taking it costs ~nothing, and
    the build ran on the prewarm thread, never on the caller's."""
    mod = PACKAGES[pkg]
    threads = []

    def build():
        threads.append(threading.current_thread().name)
        time.sleep(0.3)  # an artificially slow build
        return "engine"

    p = mod.EnginePrewarmer()
    try:
        assert p.schedule("k", build)
        assert not p.schedule("k", build)  # idempotent per key
        wait_ready(p, "k")
        t0 = time.monotonic()
        result, waited, was_ready, job = p.take("k")
        assert time.monotonic() - t0 < 0.1  # no blocking on a ready rung
        assert result == "engine" and was_ready and waited < 0.1
        assert threads == [mod.PREWARM_THREAD_NAME] == ["stateright-prewarm"]
        assert p.take("k") is None  # consumed
    finally:
        p.close()


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_prewarmer_waits_out_in_flight_and_cancels_queued(pkg):
    started = threading.Event()

    def slow():
        started.set()
        time.sleep(0.4)
        return "slow"

    p = PACKAGES[pkg].EnginePrewarmer()
    try:
        p.schedule("a", slow)
        assert started.wait(10)
        p.schedule("b", lambda: "never")
        # b is queued behind the in-flight a: taking it CANCELS it
        assert p.take("b") is None
        assert not p.scheduled("b")
        # a is in flight: take waits it out
        result, waited, was_ready, _ = p.take("a")
        assert result == "slow" and not was_ready and waited > 0
    finally:
        p.close()


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_prewarmer_close_drops_queue_and_surfaces_errors(pkg):
    def boom():
        raise ValueError("bad build")

    p = PACKAGES[pkg].EnginePrewarmer()
    p.schedule("e", boom)
    deadline = time.monotonic() + 20
    while p.scheduled("e") and not p.ready("e"):
        assert time.monotonic() < deadline
        time.sleep(0.01)
    with pytest.raises(ValueError, match="bad build"):
        p.take("e")
    blocker = threading.Event()
    p.schedule("x", lambda: blocker.wait(2))
    p.schedule("y", lambda: "y")
    p.close()
    assert not p.schedule("z", lambda: "z")  # closed
    assert not p.scheduled("y")  # the queued job was dropped
    blocker.set()
    assert p.wait_idle(20)


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_prewarmer_prune_drops_dead_rungs_only(pkg):
    """``prune`` cancels queued and releases finished jobs outside the
    kept keys and leaves the in-flight one alone."""
    gate, started = threading.Event(), threading.Event()

    def held():
        started.set()
        gate.wait(10)
        return "held"

    p = PACKAGES[pkg].EnginePrewarmer()
    try:
        p.schedule("done", lambda: "done")
        wait_ready(p, "done")
        p.schedule("flight", held)
        assert started.wait(10)
        p.schedule("queued", lambda: "queued")
        p.schedule("next", lambda: "next")
        assert p.prune(["next"]) == 2  # "done" and "queued"
        assert not p.scheduled("done") and not p.scheduled("queued")
        assert p.scheduled("flight") and p.scheduled("next")
        gate.set()
        assert p.take("flight")[0] == "held"
        wait_ready(p, "next")
        assert p.take("next")[0] == "next"
        assert p.pending() == 0
    finally:
        gate.set()
        p.close()


# -- a growth boundary, held to JAX's run -------------------------------------------


def compile_seq(c) -> list:
    return [(e["rung"], e["cap"], e["qcap"], e["cand"])
            for e in c.flight_recorder.records("compile")]


def test_growth_boundary_consumes_prewarmed_engine_like_jax(monkeypatch):
    builds = []
    engine = wavefront.GpuChecker._engine

    def spy(self, cap, qcap, batch, cand):
        eng = engine(self, cap, qcap, batch, cand)
        builds.append((threading.current_thread().name, cap, qcap, eng))
        return eng

    monkeypatch.setattr(wavefront.GpuChecker, "_engine", spy)
    j = JaxSys(3).checker().prewarm().telemetry().spawn_tpu(
        sync=True, **GROWTH_CAPS)
    t = TwoPhaseSys(3).checker().prewarm().telemetry().spawn_gpu(
        device="cpu", sync=True, **GROWTH_CAPS)
    assert t.unique_state_count() == 288 and t._prewarm
    assert_same_run(j, t)
    assert t.growth_events == j.growth_events and t.growth_events
    js, ts = j.checkpoint(), t.final_snapshot()
    tail = int(ts["tail"])
    assert int(js["tail"]) == tail and int(js["head"]) == int(ts["head"])
    for k in ("q_rows", "q_fp", "q_ebits", "q_depth"):
        np.testing.assert_array_equal(np.asarray(ts[k])[:tail],
                                      np.asarray(js[k])[:tail], err_msg=k)
    assert compile_seq(t) == compile_seq(j)
    events = t.flight_recorder.records("compile")
    assert events[0]["rung"] == "init" and events[0]["source"] == "fresh"
    rungs = events[1:]
    assert rungs and all(e["source"] == "prewarm" and e["cache_hit"]
                         for e in rungs), rungs
    for e in events:
        assert {"duration", "build_secs", "prewarm_ready"} <= set(e)
        assert e["duration"] >= 0 and e["build_secs"] >= 0
    counters = t.flight_recorder.counters()
    assert counters["prewarm_consumed"] >= len(rungs)
    assert counters["prewarm_scheduled"] >= len(rungs)
    # each consumed rung's engine was built on the prewarm thread, and it
    # is the engine the run used last
    by_cap = {cap: name for name, cap, _, _ in builds}
    for e in rungs:
        assert by_cap[e["cap"]] == prewarm.PREWARM_THREAD_NAME, builds
    last = [eng for name, cap, q, eng in builds
            if (cap, q) == (t._cap, t._qcap)]
    assert t._last_engine is last[0]
    assert t._prewarmer._closed  # the run closed its worker
    off = TwoPhaseSys(3).checker().telemetry().spawn_gpu(
        device="cpu", sync=True, **GROWTH_CAPS)
    assert not off._prewarm and off._prewarmer is None
    for a, b in zip(off._table_np(), t._table_np()):
        np.testing.assert_array_equal(a, b)
    assert off.growth_events == t.growth_events
    assert compile_seq(off) == compile_seq(t)
    assert all(e["source"] == "fresh"
               for e in off.flight_recorder.records("compile"))


def test_prewarmed_engines_dispatch_the_cold_engines_operations(monkeypatch):
    """A run that grows onto engines the prewarm thread built dispatches,
    step for step, exactly the operations of the same run built cold."""
    from test_torch_engine import OpCount

    steps = []
    step = wavefront._Engine.step

    def counted(self, c):
        probe = OpCount()
        with probe:
            out = step(self, c)
        steps.append(probe.ops)
        return out

    monkeypatch.setattr(wavefront._Engine, "step", counted)
    m = TwoPhaseSys(3)  # one twin: its lazy constants are built once
    runs = []
    for on in (False, False, True):
        steps.clear()
        b = m.checker().telemetry()
        c = (b.prewarm() if on else b).spawn_gpu(device="cpu", sync=True,
                                                 **GROWTH_CAPS)
        runs.append((c, list(steps)))
    _, (cold, cold_steps), (warm, warm_steps) = runs
    assert warm.growth_events == cold.growth_events != []
    assert warm.flight_recorder.records("compile")[-1]["source"] == "prewarm"
    assert warm_steps == cold_steps


def test_a_rung_within_the_next_blocks_reach_is_prewarmed():
    """The port's gate also fires when the next block can reach a trigger
    (here any step can overflow a budget of 256 lanes): both budget rungs
    of this 2pc-5 run come at 67 and 237 unique, far below JAX's 1/16
    table load, where JAX's gate alone would have left them cold."""
    c = TwoPhaseSys(5).checker().prewarm().telemetry().spawn_gpu(
        device="cpu", sync=True, batch=64, cand=256)
    assert c.unique_state_count() == 8832
    events = c.flight_recorder.records("compile")
    assert [(e["rung"], e["cand"], e["source"]) for e in events] == [
        ("init", 256, "fresh"), ("growth", 512, "prewarm"),
        ("growth", 1024, "prewarm")]
    growth = c.flight_recorder.records("growth")
    assert growth and all(g["unique"] * 16 <= g["cap"] for g in growth)


def test_env_knob_turns_prewarm_on_and_the_builder_wins(monkeypatch):
    monkeypatch.setenv(prewarm.ENV_PREWARM, "1")
    on = TwoPhaseSys(3).checker().spawn_gpu(device="cpu", sync=True,
                                            **GROWTH_CAPS)
    off = TwoPhaseSys(3).checker().prewarm(False).spawn_gpu(
        device="cpu", sync=True, **GROWTH_CAPS)
    assert on._prewarm and on._prewarmer is not None
    assert not off._prewarm and off._prewarmer is None
    assert on.unique_state_count() == off.unique_state_count() == 288
    # the step flags' knobs and their resolution are re-exported here, as
    # JAX's module defines them
    from stateright_tpu_torch.parallel import _base

    assert prewarm.resolve_flag is _base.resolve_flag
    for name in ("ENV_PREDEDUP", "ENV_POR", "ENV_SPILL", "ENV_PREWARM",
                 "ENV_COMPILE_CACHE"):
        assert getattr(prewarm, name) == getattr(jax_prewarm, name)


def test_the_sharded_and_sweep_engines_record_measured_builds():
    """Only the single-device engine prewarms (as in JAX); the others
    record one ``compile`` event per acquisition with the build they
    measured."""
    from stateright_tpu_torch.models.two_phase_commit import sweep_family

    s = TwoPhaseSys(3).checker().prewarm().telemetry().spawn_gpu(
        devices=2, device="cpu", sync=True)
    assert s._prewarmer is None and s.unique_state_count() == 288
    ev = s.flight_recorder.records("compile")
    assert ev[0]["rung"] == "init" and ev[0]["source"] == "fresh"
    assert all(e["duration"] > 0 and e["build_secs"] == e["duration"]
               for e in ev)
    w = TwoPhaseSys(3).checker().telemetry().sweep(sweep_family(2)).spawn_gpu(
        device="cpu", sync=True, capacity=1 << 12, batch=64)
    ev = w.flight_recorder.records("compile")
    assert ev and ev[0]["rung"] == "init"
    assert all(e["duration"] > 0 for e in ev)
    assert w.flight_recorder.stages()["compile_secs"] > 0


# -- the compile cache ---------------------------------------------------------------

CHILD = """
import json, sys
import torch
torch.set_num_threads(1)
from stateright_tpu_torch import native
from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
from stateright_tpu_torch.native.build import module_path
from stateright_tpu_torch.ops import _cuda
from stateright_tpu_torch.parallel.prewarm import CompileWatch
b = TwoPhaseSys(3).checker().telemetry()
if sys.argv[1]:
    b = b.compile_cache(sys.argv[1])
c = b.spawn_gpu(device="cpu", sync=True, capacity=1 << 10, batch=8,
                queue_capacity=1 << 12)
w = CompileWatch()
assert native.load() is not None
print(json.dumps({
    "unique": c.unique_state_count(), "delta": w.delta(),
    "module": str(module_path()), "library": str(_cuda.library_path()),
    "compile": c.flight_recorder.records("compile"),
    "flags": c._compile_cache_dir}))
"""


def child(arg: str, **env) -> dict:
    out = subprocess.run(
        [sys.executable, "-c", CHILD, arg], cwd=REPO,
        env=dict(os.environ, OMP_NUM_THREADS="1", **env),
        capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_compile_cache_builds_once_then_loads_across_processes(tmp_path):
    """The native module builds with ``g++`` into the builder's directory
    in a fresh process (a miss) and loads from it in the next, which names
    the directory by the env knob only (a hit).  The kernel library's path
    resolves there too.  Only the two artefacts live there, never an
    engine, so the second process's growth rung compiles ``fresh``."""
    d = tmp_path / "cache"
    first = child(str(d))
    assert first["unique"] == 288 and first["flags"] == str(d)
    assert first["delta"]["persistent_misses"] == 1
    assert first["delta"]["persistent_hits"] == 0
    assert first["delta"]["compile_secs"] > 0
    assert Path(first["module"]).parent.parent == d
    assert Path(first["library"]).parent == d
    second = child("", STATERIGHT_TPU_COMPILE_CACHE=str(d))
    assert second["unique"] == 288 and second["flags"] == str(d)
    assert second["delta"]["persistent_hits"] == 1
    assert second["delta"]["persistent_misses"] == 0
    assert second["module"] == first["module"]
    assert all(p.name.startswith(("native-", "libsrt_kernels-"))
               for p in d.iterdir())
    rungs = [e for e in second["compile"] if e["rung"] != "init"]
    assert rungs and all(e["source"] == "fresh" and not e["cache_hit"]
                         for e in rungs)


def test_compile_cache_dir_resolution(tmp_path, monkeypatch):
    from stateright_tpu_torch.native.build import module_path
    from stateright_tpu_torch.ops import _cuda

    assert prewarm.compile_cache_dir() == prewarm.DEFAULT_CACHE_DIR
    assert _cuda.library_path().parent == prewarm.DEFAULT_CACHE_DIR
    assert prewarm.enable_persistent_compile_cache() is None  # nothing set
    monkeypatch.setenv(prewarm.ENV_COMPILE_CACHE, str(tmp_path / "env"))
    assert prewarm.compile_cache_dir() == tmp_path / "env"
    assert _cuda.library_path().parent == tmp_path / "env"
    d = str(tmp_path / "builder")
    assert prewarm.enable_persistent_compile_cache(d) == d  # last wins
    assert _cuda.library_path().parent == Path(d)
    assert module_path().parent.parent == Path(d)
    prewarm.disable_persistent_compile_cache()
    assert prewarm.compile_cache_dir() == tmp_path / "env"


def test_the_kernel_library_is_built_once_and_charged_once(monkeypatch):
    """Many threads asking for the kernel library at once run one build,
    charged (one miss, its seconds) to the thread that ran it and to no
    other; every thread gets the same library."""
    import sys
    import types

    from stateright_tpu_torch.ops import _cuda

    builds = []

    def build():
        builds.append(threading.current_thread().name)
        time.sleep(0.05)
        return Path("libsrt_kernels-stub.so")

    class Lib:
        def __getattr__(self, name):
            return types.SimpleNamespace()

    monkeypatch.setattr(_cuda, "build", build)
    monkeypatch.setattr(_cuda.ctypes, "CDLL", lambda path: Lib())
    monkeypatch.setattr(_cuda, "_LIB", None)
    out, start = {}, threading.Barrier(24)

    def ask():
        start.wait(10)
        watch = prewarm.CompileWatch()
        lib = _cuda.library()
        out[threading.current_thread().name] = (lib, watch.delta())

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=ask) for _ in range(24)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(20)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and len(out) == 24
    assert len(builds) == 1
    assert len({id(lib) for lib, _ in out.values()}) == 1
    charged = {n: d for n, (_, d) in out.items() if d["persistent_misses"]}
    assert list(charged) == builds and charged[builds[0]]["compile_secs"] > 0
    assert all(d == {"compile_secs": 0, "persistent_hits": 0,
                     "persistent_misses": 0}
               for n, (_, d) in out.items() if n not in charged)


def test_engines_are_per_checker_and_donation_is_not_a_knob():
    """Two checkers of one model never share an engine (each owns mutable
    buffers): the second's rungs are built again, where JAX's engine cache
    on the twin would serve them.  The port updates in place, so it has no
    ``donation_supported``."""
    m = TwoPhaseSys(3)
    a = m.checker().telemetry().spawn_gpu(device="cpu", sync=True,
                                          **GROWTH_CAPS)
    b = m.checker().telemetry().spawn_gpu(device="cpu", sync=True,
                                          **GROWTH_CAPS)
    assert a._last_engine is not b._last_engine
    for c in (a, b):
        counters = c.flight_recorder.counters()
        assert counters["compile_cache_misses"] == len(compile_seq(c)) == 2
        assert counters.get("compile_cache_hits", 0) == 0
    assert hasattr(jax_prewarm, "donation_supported")
    assert not hasattr(prewarm, "donation_supported")


# -- the verbs, attribution and the report diff ---------------------------------------


def test_check_gpu_verb_takes_prewarm_and_compile_cache(tmp_path, monkeypatch,
                                                        capsys):
    from stateright_tpu_torch.models import two_phase_commit
    from stateright_tpu_torch.models._cli import pop_step_flags

    d = str(tmp_path / "cache")
    flags, rest = pop_step_flags(["check-gpu", "3", "--prewarm",
                                  f"--compile-cache={d}", "--device=cpu"])
    assert flags == ["--prewarm", f"--compile-cache={d}"]
    assert rest == ["check-gpu", "3", "--device=cpu"]
    runs = tmp_path / "runs"
    monkeypatch.setenv("STATERIGHT_TPU_RUN_DIR", str(runs))
    assert two_phase_commit.main(
        ["check-gpu", "3", "--device=cpu", "--batch=64", "--prewarm",
         f"--compile-cache={d}"]) == 0
    assert "unique=288" in capsys.readouterr().out
    (doc,) = [json.loads(p.read_text()) for p in (runs / "runs").iterdir()]
    assert doc["config"]["flags"]["prewarm"] is True
    assert doc["config"]["flags"]["compile_cache"] is True
    assert prewarm.compile_cache_dir() == Path(d)
    assert two_phase_commit.main(["no-such-verb"]) == 2
    usage = capsys.readouterr().err
    assert "[--prewarm]" in usage and "[--compile-cache=DIR]" in usage


def test_stage_breakdown_present_and_sane(tmp_path):
    """JAX's ``test_stage_breakdown_present_and_sane`` on the port: the
    compile stage is there, and the named stages fit in the wall."""
    from stateright_tpu_torch.telemetry import FlightRecorder

    c = TwoPhaseSys(3).checker().telemetry().spawn_gpu(
        device="cpu", sync=True, capacity=1 << 12, batch=64)
    stages = c.flight_recorder.stages()
    assert stages is not None
    for key in ("compile_secs", "device_secs", "wall_secs", "host_secs"):
        assert key in stages and stages[key] >= 0.0, stages
    named = sum(v for k, v in stages.items()
                if k.endswith("_secs") and k not in ("wall_secs", "host_secs"))
    assert named <= stages["wall_secs"] + 0.05, stages
    assert c.flight_recorder.summary()["stages"] == stages
    # the breakdown survives a JSONL round trip (counters ride the header)
    c.flight_recorder.to_jsonl(str(tmp_path / "t.jsonl"))
    back = FlightRecorder.from_jsonl(str(tmp_path / "t.jsonl")).stages()
    assert back["compile_secs"] == stages["compile_secs"]
    assert back["device_secs"] == stages["device_secs"]


def test_report_diff_prewarm_on_against_off_is_perf_only():
    from stateright_tpu_torch.telemetry.diff import PERF_ONLY, diff_reports
    from stateright_tpu_torch.telemetry.report import build_report

    docs = []
    for on in (True, False):
        b = TwoPhaseSys(3).checker().telemetry()
        c = (b.prewarm() if on else b).spawn_gpu(device="cpu", sync=True,
                                                 **GROWTH_CAPS)
        docs.append(build_report(c))
    assert docs[0]["config"]["flags"]["prewarm"] is True
    d = diff_reports(docs[0], docs[1])
    assert d["verdict"] == PERF_ONLY, d
