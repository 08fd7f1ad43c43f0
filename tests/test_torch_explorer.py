"""The port's Explorer (``stateright_tpu_torch/explorer.py``) against the
JAX Explorer, both served from ``localhost:0`` over the same model
(tolerance 0):

 - ``/.status`` for the keys ``tests/test_explorer.py`` pins (LinearEquation
   on host BFS; 2pc-3 on ``strategy="gpu", device="cpu"`` against JAX's
   ``strategy="tpu"``, both agreement paths), the POR block (JAX's values
   through the test-side conjunct evaluator, ``test_torch_footprint``);
 - ``/.states/`` and ``/.states/{fp...}`` views, fingerprints and SVGs (the
   actor sequence diagram and the timeout circle), and the 404 bodies;
 - a live discovery mid-run at 2pc-5 (``batch=32, steps_per_call=1``),
   raft-3 with ``sync=True``;
 - the metrics bus: the family catalogue equals JAX's, metrics on or off
   give the same step records, a publisher crash detaches the bus and not
   the run, ``/metrics`` and ``/.progress[/job]`` as
   ``tests/test_observability.py`` pins them; the ``/.runs`` endpoints and
   their stable error bodies.
"""

import json
import time
import urllib.error
import urllib.request

import pytest

import stateright_tpu.analysis.footprint as jfp
from fixtures import LinearEquation as JaxLinearEquation
from fixtures_por import WorkersSys as JaxWorkers
from stateright_tpu.explorer import _Snapshot as JaxSnapshot
from stateright_tpu.explorer import _status_view as jax_status_view
from stateright_tpu.explorer import serve as jax_serve
from stateright_tpu.models.paxos import paxos_model as jax_paxos
from stateright_tpu.models.two_phase_commit import TwoPhaseSys as JaxSys
from stateright_tpu.telemetry.metrics import MetricsBus as JaxBus
from stateright_tpu.telemetry.metrics import engine_families as jax_engine
from stateright_tpu.telemetry.metrics import fleet_families as jax_fleet
from stateright_tpu_torch.checkpoint import PROGRESS_FILE
from stateright_tpu_torch.explorer import _Snapshot, _status_view, serve
from stateright_tpu_torch.models.paxos import paxos_model
from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
from stateright_tpu_torch.telemetry.metrics import (
    ENGINE_LABELS,
    MetricsBus,
    default_bus,
    engine_families,
    fleet_families,
    reset_default_bus,
)
from stateright_tpu_torch.testing.por_fixtures import WorkersSys
from test_torch_footprint import jax_conjunct_eval_fn
from test_torch_mp import LinearEquation

# the /.status keys tests/test_explorer.py pins
STATUS_KEYS = ("done", "model", "state_count", "unique_state_count",
               "properties")


def get_status(server, path):
    try:
        with urllib.request.urlopen(f"http://{server.addr}{path}") as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def get(server, path):
    code, body = get_status(server, path)
    assert code == 200, (path, body)
    return body


def pinned(status):
    return {k: status[k] for k in STATUS_KEYS}


@pytest.fixture(autouse=True)
def _fresh_default_bus():
    reset_default_bus()
    yield
    reset_default_bus()


@pytest.fixture(scope="module")
def lineq_pair():
    """The same LinearEquation served by both Explorers (host BFS)."""
    j = jax_serve(JaxLinearEquation(a=2, b=10, c=14).checker(),
                  "localhost:0", block=False)
    t = serve(LinearEquation(a=2, b=10, c=14).checker(), "localhost:0",
              block=False)
    j.checker.join()
    t.checker.join()
    yield j, t
    j.shutdown()
    t.shutdown()


def test_lineq_status_and_views_equal_jax(lineq_pair):
    j, t = lineq_pair
    js, ts = get(j, "/.status"), get(t, "/.status")
    assert pinned(ts) == pinned(js)
    assert ts["unique_state_count"] == 12 and ts["state_count"] == 15
    disc = {n: d for _, n, d in ts["properties"]}["solvable"]
    assert disc is not None and "/" in disc
    init = get(t, "/.states/")
    assert init == get(j, "/.states/")
    assert init[0]["state"] == "(0, 0)" and "action" not in init[0]
    fps = disc.split("/")
    for i in range(len(fps)):
        path = "/.states/" + "/".join(fps[: i + 1])
        assert get(t, path) == get(j, path)


@pytest.mark.parametrize("path", ["/.states/12345", "/.states/zzz",
                                  "/.metrics", "/.runs", "/.runs/abc",
                                  "/.progress", "/.progress/job"])
def test_error_bodies_equal_jax(lineq_pair, path):
    j, t = lineq_pair
    assert get_status(t, path) == get_status(j, path)
    code, body = get_status(t, path)
    assert code == 404 and "error" in body


def test_ui_is_served(lineq_pair):
    _, t = lineq_pair
    with urllib.request.urlopen(f"http://{t.addr}/") as r:
        assert "State Space Explorer" in r.read().decode()
    with urllib.request.urlopen(f"http://{t.addr}/app.js") as r:
        assert "pollStatus" in r.read().decode()
    with urllib.request.urlopen(f"http://{t.addr}/app.css") as r:
        assert r.status == 200
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(f"http://{t.addr}/nothing")
    assert e.value.code == 404


def test_2pc3_gpu_status_and_discovery_views_equal_jax_tpu():
    j = jax_serve(JaxSys(3).checker(), "localhost:0", block=False,
                  strategy="tpu", sync=True, capacity=1 << 12,
                  frontier_capacity=64)
    t = serve(TwoPhaseSys(3).checker(), "localhost:0", block=False,
              strategy="gpu", device="cpu", capacity=1 << 12, batch=64)
    try:
        t.checker.join()
        js, ts = get(j, "/.status"), get(t, "/.status")
        assert pinned(ts) == pinned(js)
        assert ts["done"] is True and ts["unique_state_count"] == 288
        assert ts["table"] == js["table"]
        disc = {n: d for _, n, d in ts["properties"] if d is not None}
        assert set(disc) == {"abort agreement", "commit agreement"}
        for encoded in disc.values():
            fps = encoded.split("/")
            for i in range(len(fps)):
                path = "/.states/" + "/".join(fps[: i + 1])
                assert get(t, path) == get(j, path)
        assert get(t, "/.states/") == get(j, "/.states/")
    finally:
        j.shutdown()
        t.shutdown()


def test_spawn_keywords_need_the_gpu_strategy():
    with pytest.raises(TypeError, match="strategy='gpu'"):
        serve(TwoPhaseSys(3).checker(), "localhost:0", block=False, batch=8)
    with pytest.raises(ValueError, match="unknown Explorer strategy"):
        serve(TwoPhaseSys(3).checker(), "localhost:0", block=False,
              strategy="tpu")


def test_actor_svgs_equal_jax():
    """The sequence diagrams of the ``/.states`` step views (reference
    ``src/actor/model.rs:384-475``) are byte-equal to the JAX Explorer's."""
    j = jax_serve(jax_paxos(1).checker().target_states(50), "localhost:0",
                  block=False)
    t = serve(paxos_model(1).checker().target_states(50), "localhost:0",
              block=False)
    try:
        j.checker.join()
        t.checker.join()
        inits = get(t, "/.states/")
        assert inits == get(j, "/.states/")
        steps = get(t, f"/.states/{inits[0]['fingerprint']}")
        assert steps == get(j, f"/.states/{inits[0]['fingerprint']}")
        svgs = [v["svg"] for v in steps if "svg" in v]
        assert svgs and all(s.startswith("<svg") for s in svgs)
        assert any("svg-event-line" in s for s in svgs)
        deeper = f"/.states/{inits[0]['fingerprint']}/{steps[0]['fingerprint']}"
        assert get(t, deeper) == get(j, deeper)
    finally:
        j.shutdown()
        t.shutdown()


def _timer_model(pkg):
    actor = __import__(f"{pkg}.actor", fromlist=["Actor"])
    core = __import__(f"{pkg}.core", fromlist=["Expectation"])

    class TimerActor(actor.Actor):
        def on_start(self, id, out):
            out.set_timer()
            return 0

        def on_timeout(self, id, state, out):
            out.send(id, "tick")
            return state + 1

        def on_msg(self, id, state, src, msg, out):
            return state + 10

    return actor.ActorModel().actor(TimerActor()).property(
        core.Expectation.ALWAYS, "small",
        lambda m, s: s.actor_states[0] < 3)


@pytest.mark.parametrize("steps", [1, 2])
def test_timeout_circle_svg_equals_jax(steps):
    svgs = []
    for pkg in ("stateright_tpu", "stateright_tpu_torch"):
        path_mod = __import__(f"{pkg}.checker.path", fromlist=["Path"])
        model = _timer_model(pkg)
        state = model.init_states()[0]
        pairs = []
        for _ in range(steps):
            # the timeout, then the delivery of the tick it sent
            action = min(model.actions(state),
                         key=lambda a: type(a).__name__ != "Timeout")
            pairs.append((state, action))
            state = model.next_state(state, action)
        svgs.append(model.as_svg(path_mod.Path(pairs + [(state, None)])))
    assert svgs[0] == svgs[1]
    assert "<circle" in svgs[1] and "Timeout" in svgs[1]


def test_live_discovery_mid_run_2pc5():
    """``/.status`` surfaces live counters and discovery paths while the GPU
    run is in flight (JAX ``tests/test_explorer.py:250-290``)."""
    server = serve(TwoPhaseSys(5).checker(), "localhost:0", block=False,
                   strategy="gpu", device="cpu", batch=32, steps_per_call=1)
    try:
        saw_live = saw_live_disc = False
        deadline = time.monotonic() + 120.0
        while time.monotonic() < deadline:
            status = get(server, "/.status")
            if status["done"]:
                break
            if status["unique_state_count"] > 0:
                saw_live = True
            disc = {n: d for _, n, d in status["properties"]
                    if d is not None}
            if disc:
                saw_live_disc = True
                # a live path resolves through /.states as it is
                for encoded in disc.values():
                    assert get_status(server, f"/.states/{encoded}")[0] == 200
                break
            time.sleep(0.02)
        assert saw_live, "no live counter surfaced before completion"
        assert saw_live_disc, "no discovery path surfaced mid-run"
        server.checker.join()
        status = get(server, "/.status")
        assert status["done"] is True
        assert status["unique_state_count"] == 8832
        disc = {n for _, n, d in status["properties"] if d is not None}
        assert disc == {"abort agreement", "commit agreement"}
    finally:
        server.checker.stop()
        server.shutdown()


def test_live_discoveries_skip_and_an_unserved_checkpoint():
    """A poll whose discoveries are all in ``skip`` takes no checkpoint,
    and a poll whose checkpoint is not served in time (one long block)
    returns ``{}`` instead of blocking the handler."""
    c = TwoPhaseSys(5).checker().spawn_gpu(device="cpu", batch=32,
                                           steps_per_call=1)
    names = frozenset(p.name for p in c.model.properties())
    asked = []

    def unserved(timeout=60.0):
        asked.append(timeout)
        raise TimeoutError("checkpoint request not served")

    c.checkpoint = unserved
    polled = False
    try:
        while not c.is_done():
            with c._live_lock:
                disc = c._live_disc
            if disc is not None and any(int(x) for x in disc):
                assert c.live_discoveries(skip=names) == {}
                assert not asked
                got = c.live_discoveries(timeout=0.1)
                polled = not c.is_done()
                assert got == {} or not polled
                break
            time.sleep(0.001)
    finally:
        del c.checkpoint
        c.join()
    assert polled and asked == [0.1]
    assert set(c.live_discoveries()) == {"abort agreement",
                                         "commit agreement"}
    assert c.live_discoveries(skip=names) == {}


def test_raft3_sync_served():
    """The Explorer over a synchronous GPU run of the compiled general
    fragment (JAX ``tests/test_explorer.py:292-320``)."""
    from stateright_tpu_torch.models.raft import raft_model

    server = serve(raft_model(3).checker(), "localhost:0", strategy="gpu",
                   block=False, sync=True, device="cpu", capacity=1 << 14,
                   batch=256)
    try:
        assert server.checker.is_done()
        s = get(server, "/.status")
        assert s["done"] is True and s["unique_state_count"] == 5_725
        props = {name: disc for _, name, disc in s["properties"]}
        assert props["a leader is elected"] is not None
        code, view = get_status(server,
                                "/.states/" + props["a leader is elected"])
        assert code == 200 and isinstance(view, list)
    finally:
        server.shutdown()


def test_por_block_in_status_equals_jax(monkeypatch):
    """The ``/.status`` POR block (JAX ``test_independence.py:440``, which
    this jax cannot run: its values come through the test-side conjunct
    evaluator)."""
    monkeypatch.setattr(jfp, "conjunct_eval_fn", jax_conjunct_eval_fn)
    jm, tm = JaxWorkers(4), WorkersSys(4)
    jc = jm.checker().por().spawn_tpu(sync=True, capacity=1 << 10,
                                      frontier_capacity=16)
    tc = tm.checker().por().spawn_gpu(device="cpu", capacity=1 << 10,
                                      batch=16, sync=True)
    jv = jax_status_view(jm, jc, JaxSnapshot())
    tv = _status_view(tm, tc, _Snapshot())
    assert tv["por"]["enabled"] is True and tv["por"]["rows_reduced"] > 0
    for k in ("enabled", "fallback", "rows_reduced", "rows_full_proviso",
              "candidates_masked"):
        assert tv["por"][k] == jv["por"][k], k
    assert pinned(tv) == pinned(jv)
    plain = WorkersSys(4).checker().spawn_gpu(device="cpu", capacity=1 << 10,
                                              batch=16, sync=True)
    assert _status_view(tm, plain, _Snapshot())["por"] is None


# -- the metrics bus and the service plane -----------------------------------


def test_family_catalogue_equals_jax():
    j, t = JaxBus(), MetricsBus()
    jax_engine(j)
    jax_fleet(j)
    eng, flt = engine_families(t), fleet_families(t)
    assert t.expose() == j.expose()
    assert sorted(t.families()) == sorted(j.families())
    assert eng["states"].name == "stateright_states_total"
    assert flt["queue"].name == "stateright_fleet_queue_depth"
    assert flt["admissions"].kind == "counter"
    assert ENGINE_LABELS == ("engine", "model")
    assert engine_families(t)["states"] is eng["states"]


def _spawn_2pc3(metrics: bool, **kw):
    b = TwoPhaseSys(3).checker().telemetry(metrics=metrics)
    return b.spawn_gpu(device="cpu", capacity=1 << 12, batch=64, sync=True,
                       **kw)


def test_engine_publishes_per_sync_samples():
    c = _spawn_2pc3(metrics=True)
    exp = default_bus().expose()
    assert 'stateright_states_total{engine="gpu-wavefront",' in exp
    assert "} %d\n" % c.state_count() in exp
    assert "stateright_step_seconds_bucket" in exp
    assert "stateright_table_load{" in exp
    assert "stateright_frontier_size{" in exp


def test_metrics_env_attaches_the_default_bus(monkeypatch):
    monkeypatch.setenv("STATERIGHT_TPU_METRICS", "1")
    c = TwoPhaseSys(3).checker().telemetry().spawn_gpu(
        device="cpu", batch=64, sync=True)
    assert c.flight_recorder.metrics_bus is default_bus()
    assert "stateright_states_total" in default_bus().families()


def test_metrics_on_off_step_records_are_identical():
    def strip(rec):
        return [{k: v for k, v in r.items() if k not in ("t", "dt", "span")}
                for r in rec.records("step")]

    off, on = _spawn_2pc3(metrics=False), _spawn_2pc3(metrics=True)
    assert strip(off.flight_recorder) == strip(on.flight_recorder)
    assert off.unique_state_count() == on.unique_state_count() == 288
    assert off.flight_recorder.metrics_bus is None


def test_publisher_crash_detaches_bus_not_run(monkeypatch):
    from stateright_tpu_torch.telemetry import recorder as recmod

    def boom(*a, **kw):
        raise RuntimeError("bus exploded")

    monkeypatch.setattr(recmod.FlightRecorder, "_engine_fams", boom)
    c = _spawn_2pc3(metrics=True)
    assert c.unique_state_count() == 288
    notes = [r for r in c.flight_recorder.records("note")
             if r.get("what") == "metrics bus detached"]
    assert notes


def _raw(addr, path):
    with urllib.request.urlopen(f"http://{addr}{path}") as r:
        return r.status, dict(r.headers), r.read()


def test_metrics_and_progress_endpoints(tmp_path):
    b = (TwoPhaseSys(3).checker().telemetry(metrics=True)
         .autosave(str(tmp_path), every_secs=3600.0))
    server = serve(b, "localhost:0", block=False, strategy="gpu", sync=True,
                   device="cpu", capacity=1 << 12, batch=64)
    try:
        status, headers, body = _raw(server.addr, "/metrics")
        assert status == 200
        assert headers["Content-Type"].startswith("text/plain; version=0.0.4")
        text = body.decode()
        assert "# TYPE stateright_states_total counter" in text
        assert 'engine="gpu-wavefront"' in text
        doc = get(server, "/.progress")
        assert doc["verdict"] == "done"
        assert doc["states"] == server.checker.state_count()
        code, body = get_status(server, "/.progress/../evil")
        assert code == 404 and body["error"] == "bad_job_key"
        code, body = get_status(server, "/.progress/nojob")
        assert code == 404 and body["error"] == "no_heartbeat"
        job = tmp_path / "jobs" / "j1"
        job.mkdir(parents=True)
        (job / PROGRESS_FILE).write_text(json.dumps(
            {"v": 1, "status": "running", "ts": time.time(),
             "every_secs": 1.0, "states": 3}))
        assert get(server, "/.progress/j1")["verdict"] == "running"
        m = get(server, "/.metrics")
        assert m["summary"]["unique"] == 288
        assert m["durability"] is not None and m["fleet"] is None
    finally:
        server.shutdown()


def test_progress_disabled_without_root_and_metrics_still_answers():
    server = serve(TwoPhaseSys(3).checker(), "localhost:0", block=False)
    try:
        server.checker.join()
        code, body = get_status(server, "/.progress")
        assert code == 404 and body["error"] == "progress_disabled"
        status, _, _ = _raw(server.addr, "/metrics")
        assert status == 200
    finally:
        server.shutdown()


def test_runs_endpoints(tmp_path):
    runs = str(tmp_path / "runs")
    ids = [TwoPhaseSys(3).checker().runs(runs).spawn_gpu(
        device="cpu", batch=64, sync=True).run_id for _ in range(2)]
    server = serve(TwoPhaseSys(3).checker(), "localhost:0", block=False,
                   runs_dir=runs)
    try:
        server.checker.join()
        view = get(server, "/.runs")
        assert [r["run_id"] for r in view["runs"]] == ids
        assert view["v"] == 1 and len(view["trends"]) == 1
        doc = get(server, f"/.runs/{ids[0]}")
        assert doc["totals"]["unique"] == 288
        diff = get(server, f"/.runs/diff/{ids[0]}/{ids[1]}")
        assert diff["verdict"] == "IDENTICAL"
        for path, err in (("/.runs/nope", "unknown_run"),
                          (f"/.runs/diff/{ids[0]}/nope", "unknown_run"),
                          ("/.runs/diff/a", "bad_diff_request")):
            code, body = get_status(server, path)
            assert (code, body["error"]) == (404, err)
    finally:
        server.shutdown()


EXPLORE_VERBS = {
    "two_phase_commit": "Exploring 2PC state space with 2 RMs on localhost:0.",
    "paxos": "Exploring Paxos state space with 2 clients on localhost:0.",
    "linearizable_register":
        "Exploring ABD state space with 2 clients on localhost:0.",
    "raft": None, "dining": None, "single_copy_register": None,
    "write_once_register": None, "increment": None, "increment_lock": None,
}


@pytest.mark.parametrize("module", list(EXPLORE_VERBS))
def test_explore_verb_serves_the_host_bfs(module, monkeypatch, capsys):
    """``explore [N] [ADDRESS]`` on every model CLI that has it in JAX
    (e.g. ``two_phase_commit.py:499-503``): the banner JAX prints, then
    the Explorer over a host BFS of the model at ``N``."""
    import importlib

    from stateright_tpu_torch import explorer

    served = []

    def once(self):
        served.append((type(self.checker).__name__,
                       type(self.model).__name__))
        self.checker._stop.set()
        self.checker.join()
        self.httpd.server_close()  # never served: nothing to shut down

    monkeypatch.setattr(explorer.ExplorerServer, "serve_forever", once)
    mod = importlib.import_module(f"stateright_tpu_torch.models.{module}")
    assert mod.main(["explore", "2", "localhost:0"]) == 0
    banner = EXPLORE_VERBS[module]
    assert capsys.readouterr().out == (banner + "\n" if banner else "")
    assert len(served) == 1 and served[0][0] != "GpuChecker"
    assert mod.main(["explore", "2", "localhost:0", "extra"]) == 2
