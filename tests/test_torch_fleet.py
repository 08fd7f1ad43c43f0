"""The port's fleet (``stateright_tpu_torch/fleet/``) against the JAX
package's fleet and its pins (tolerance 0).

Unit tier (engine-free, ``stateright_tpu_torch/testing/fleet_fakes.py``):
the JAX unit tier of ``tests/test_fleet.py:72-540`` case for case — spec
validation, admission under simulated budgets, cohort packing, the
preempt → yield → re-queue → resume cycle with its record trail,
campaigns and ledgers, the CLI surfaces, and no engine module importing
the fleet.

Acceptance, on ``device="cpu"`` at the JAX sizes: three packable 2pc-3
tenants and a 2pc-4 singleton over two slots (288 / 1,146 each, 1,568 /
8,258, two engine builds), and a preempted 2pc-4 resuming exactly once,
its parent/child reports comparing ``IDENTICAL (contract: lineage)``.
Beside them: the ``runs`` verb's campaign and sweep grouping, the canned
``fleet`` and ``campaign`` verbs in process, a re-queued job taken by an
idle slot, and the launch counters' exactness under threads.

Against the JAX package (``test_fleet_matches_jax``,
``test_fleet_acceptance_matches_jax``): the unit tier's scenarios with
JAX's fakes and both acceptances with JAX's TwoPhaseSys run through the
JAX fleet and the port's on the same jobs, and their decisions, reasons,
cohorts, record trails, results, ledgers and verb output must be equal.
"""

import io
import json
import os
import re
import threading
import time

import pytest

from stateright_tpu_torch.checker.base import CheckerBuilder
from stateright_tpu_torch.fleet import (
    ADMITTED,
    ADMITTED_SPILL,
    COMPLETED,
    FAILED,
    FLEET_V,
    LEDGER_NAME,
    REFUSED,
    FleetScheduler,
    FleetSpec,
    Job,
    PreemptionPlan,
    build_ledger,
    campaign_spec,
    expand_grid,
    run_campaign,
    run_fleet,
)
from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
from stateright_tpu_torch.telemetry import FlightRecorder
from stateright_tpu_torch.testing.fleet_fakes import FakeBuilder, FakeModel


def _job(key, builder=None, **kw):
    b = builder if builder is not None else FakeBuilder()
    return Job(key=key, build=lambda: b, **kw)


def _sched(jobs, **spec_kw):
    return FleetScheduler(FleetSpec(jobs=jobs, **spec_kw), stream=None)


def _build_2pc(n, **builder_calls):
    def build():
        b = CheckerBuilder(TwoPhaseSys(n))
        for name, arg in builder_calls.items():
            b = getattr(b, name)(arg)
        return b

    return build


# -- spec validation ---------------------------------------------------------


def test_fleet_spec_validation():
    with pytest.raises(ValueError):
        FleetSpec(jobs=[])
    with pytest.raises(ValueError):
        FleetSpec(jobs=[_job("a"), _job("a")])  # duplicate keys
    with pytest.raises(ValueError):
        FleetSpec(jobs=[_job("a")], slots=0)
    with pytest.raises(TypeError):
        FleetSpec(jobs=[Job(key="a", build="not-callable")])
    spec = FleetSpec(jobs=[_job("a"), _job("b")], slots=3)
    assert spec.slots == 3 and len(spec.jobs) == 2


def test_job_engine_kw_hints_then_overrides():
    j = Job(key="a", build=lambda: FakeBuilder(), capacity=1 << 10,
            batch=64, queue_capacity=2048, steps_per_call=8,
            spawn_kw={"batch": 128})
    kw = j.engine_kw()
    assert kw["capacity"] == 1024
    assert kw["batch"] == 128  # explicit spawn_kw wins over the hint
    assert kw["queue_capacity"] == 2048 and kw["steps_per_call"] == 8


def test_preemption_plan_is_one_shot_per_key():
    p = PreemptionPlan({"a": 3})
    assert not p.due("a", 2)
    assert p.due("a", 3)
    assert not p.due("a", 4)  # fired once, never again
    assert not p.due("b", 99)  # unplanned keys never fire


# -- admission (capacity_plan pricing under simulated budgets) ---------------


def test_admission_host_side_and_unbudgeted_jobs_admit(monkeypatch):
    monkeypatch.delenv("STATERIGHT_TPU_DEVICE_BYTES", raising=False)
    # twin-less model: host-side check, no HBM ladder to price
    j = _job("a")
    d, reason, _b = _sched([j])._admit(j)
    assert d == ADMITTED and "host-side" in reason
    # a priced model with no budget known degrades to admission (the
    # capacity verb's rule), loudly
    jp = Job(key="2pc", build=_build_2pc(3), capacity=1 << 12, batch=256)
    d, reason, _b = _sched([jp])._admit(jp)
    assert d == ADMITTED and "budget" in reason
    # ...and a roomy budget admits with nothing to report
    monkeypatch.setenv("STATERIGHT_TPU_DEVICE_BYTES", str(100 * 10**9))
    d, reason, _b = _sched([jp])._admit(jp)
    assert d == ADMITTED and reason is None


def test_admission_refuses_and_spills_under_budgets(monkeypatch):
    # a budget the requested capacity cannot even start under: REFUSED
    tiny = Job(key="2pc", build=_build_2pc(3), capacity=1 << 20,
               batch=1024)
    monkeypatch.setenv("STATERIGHT_TPU_DEVICE_BYTES", "1000000")
    d, reason, _b = _sched([tiny])._admit(tiny)
    assert d == REFUSED and "budget" in reason
    # demand beyond the ladder's reach: REFUSED without spill...
    big = Job(key="2pc-big",
              build=_build_2pc(3, target_states=10_000_000),
              capacity=1 << 12, batch=256)
    monkeypatch.setenv("STATERIGHT_TPU_DEVICE_BYTES", "30000000")
    d, reason, _b = _sched([big])._admit(big)
    assert d == REFUSED and "demand" in reason
    # ...and routed to the host tier with spill enabled
    d, reason, _b = _sched([big], spill=True)._admit(big)
    assert d == ADMITTED_SPILL and "spill" in reason.lower()


def test_twin_less_job_runs_the_host_engine():
    """A REAL model with no tensor twin is served by the host BFS
    engine in its slot (unsupervised, the packed-cohort rule) — never
    spawned on the device engine it cannot run on."""
    from stateright_tpu_torch.core import Model, Property

    class Ring(Model):
        n = 4

        def init_states(self):
            return [0]

        def actions(self, state):
            return [("tick",)]

        def next_state(self, state, action):
            return (state + 1) % self.n

        def properties(self):
            return [
                Property.sometimes("wrapped", lambda m, s: s == self.n - 1)
            ]

    sched = _sched([Job(key="ring", build=lambda: Ring().checker())])
    res = sched.run()
    r = res["ring"]
    assert r.status == COMPLETED and r.decision == ADMITTED
    assert "host-side" in r.reason
    assert r.unique == 4 and r.discoveries == ["wrapped"]
    assert res.engine_compiles == 0  # nothing compiled for the device


# -- cohort packing ----------------------------------------------------------


def test_pack_groups_same_shape_admitted_jobs():
    jobs = [
        Job(key="a", build=_build_2pc(3), packable=True),
        Job(key="b", build=_build_2pc(3), packable=True),
        Job(key="c", build=_build_2pc(4), packable=True),  # other shape
        Job(key="d", build=_build_2pc(3), packable=False),  # opted out
    ]
    packed, leftover = _sched(jobs, slots=2)._pack(
        [(j, ADMITTED, None) for j in jobs]
    )
    assert len(packed) == 1
    members, cohort_id = packed[0]
    assert sorted(j.key for j in members) == ["a", "b"]
    assert cohort_id.startswith("pack-")
    # the different-shape and opted-out jobs fall back to singletons
    assert sorted(j.key for j, _d, _r in leftover) == ["c", "d"]


def test_pack_disabled_spilled_or_unsignable_yields_singletons():
    jobs = [_job("a", packable=True), _job("b", packable=True)]
    admitted = [(j, ADMITTED, None) for j in jobs]
    # pack=False: nobody packs
    packed, leftover = _sched(jobs, slots=1, pack=False)._pack(admitted)
    assert packed == [] and len(leftover) == 2
    # pack=True but twin-less fakes cannot shape-sign: loud singleton
    # fallback (reason pack_fallback), never a crash
    packed, leftover = _sched(jobs, slots=1)._pack(admitted)
    assert packed == []
    assert [r for _j, _d, r in leftover] == ["pack_fallback"] * 2
    # spill-admitted jobs never pack (the sweep engine rejects spill)
    real = [
        Job(key="a", build=_build_2pc(3), packable=True),
        Job(key="b", build=_build_2pc(3), packable=True),
    ]
    packed, leftover = _sched(real, slots=1)._pack(
        [(j, ADMITTED_SPILL, "spilled") for j in real]
    )
    assert packed == [] and len(leftover) == 2


# -- scheduling, priorities, records -----------------------------------------


def test_fleet_runs_jobs_and_respects_priority(tmp_path):
    order = []

    def tracked(key):
        b = FakeBuilder(unique=3, states=5, depth=1)
        real = b.spawn_gpu

        def spy(resume=None, **kw):
            order.append(key)
            return real(resume=resume, **kw)

        b.spawn_gpu = spy
        return lambda: b

    jobs = [
        Job(key="low", build=tracked("low"), priority=0),
        Job(key="high", build=tracked("high"), priority=9),
        Job(key="mid", build=tracked("mid"), priority=5),
    ]
    res = run_fleet(
        FleetSpec(jobs=jobs, slots=1), root=str(tmp_path), stream=None
    )
    assert order == ["high", "mid", "low"]
    assert res.completed == 3 and res.failed == 0 and res.refused == 0
    assert all(r.status == COMPLETED for r in res.results.values())
    # results read back in SPEC order regardless of run order
    assert [r.key for r in res.results.values()] == ["low", "high", "mid"]
    assert res["mid"].unique == 3 and res["mid"].states == 5


def test_fleet_job_failure_is_a_ledger_row_not_a_crash(tmp_path):
    boom = FakeBuilder(
        spawn_plan={0: {"fail": RuntimeError("device on fire")}}
    )
    jobs = [_job("bad", builder=boom), _job("good")]
    res = run_fleet(
        FleetSpec(jobs=jobs, slots=1, max_restarts=0),
        root=str(tmp_path), stream=None,
    )
    assert res.failed == 1 and res.completed == 1
    assert res["bad"].status == FAILED
    assert "device on fire" in (res["bad"].reason or "")
    assert res["good"].status == COMPLETED


def test_fleet_refused_job_never_spawns(tmp_path, monkeypatch):
    monkeypatch.setenv("STATERIGHT_TPU_DEVICE_BYTES", "1000000")
    huge = Job(key="huge", build=_build_2pc(3), capacity=1 << 20,
               batch=1024)
    res = run_fleet(
        FleetSpec(jobs=[huge, _job("ok")], slots=1),
        root=str(tmp_path), stream=None,
    )
    assert res.refused == 1 and res.completed == 1
    assert res["huge"].status == REFUSED and res["huge"].run_id is None
    assert res["huge"].reason and "budget" in res["huge"].reason


def test_injected_stall_preempts_requeues_and_resumes(tmp_path):
    """The chaos cycle with fakes: the victim blocks on the only slot,
    the in-band injection (armed at spawn) forces a stall record on its
    third step, the monitor yields it, the waiting job drains FIRST
    (the re-queue landed the victim behind equal-priority work — that
    is what the yield bought), then the victim resumes and completes —
    with the submit/place/preempt/resume/done trail on the fleet
    recorder."""
    recs = []

    def rf():
        r = FlightRecorder(capacity=256)
        recs.append(r)
        return r

    victim = FakeBuilder(unique=7, states=9, depth=2,
                         recorder_factory=rf,
                         spawn_plan={0: {"block": True}})
    other = FakeBuilder(unique=1, states=2, depth=1)
    jobs = [
        Job(key="victim", build=lambda: victim),
        Job(key="other", build=lambda: other),
    ]
    rec = FlightRecorder(capacity=1024)
    sched = FleetScheduler(
        FleetSpec(jobs=jobs, slots=1), root=str(tmp_path),
        recorder=rec, preemption=PreemptionPlan({"victim": 3}),
        stream=None,
    )
    stop_driving = threading.Event()

    def drive():
        # emit step records on the victim's recorder until the injected
        # stall lands (the in-band seam fires on the crossing step)
        deadline = time.monotonic() + 10.0
        n = 0
        while not stop_driving.is_set() and time.monotonic() < deadline:
            if recs:
                n += 1
                recs[0].step(engine="fake", states=n, unique=n)
                if any(
                    h.get("reason") == "injected"
                    for h in recs[0].records("health")
                ):
                    return
            time.sleep(0.005)

    t = threading.Thread(target=drive, daemon=True)
    t.start()
    try:
        res = sched.run()
    finally:
        stop_driving.set()
        t.join(timeout=5)
    assert res.preemptions == 1
    v = res["victim"]
    assert v.status == COMPLETED and v.preemptions == 1
    assert v.unique == 7 and v.states == 9
    assert res["other"].status == COMPLETED
    # the trail: victim preempted, then the waiting job drained, then
    # the victim resumed — the yield actually bought the slot
    trail = [(r["key"], r["event"]) for r in rec.records("job")]
    assert trail.index(("victim", "preempt")) \
        < trail.index(("other", "done")) \
        < trail.index(("victim", "resume")) \
        < trail.index(("victim", "done"))
    # two spawns: the preempted attempt and the resume
    assert len(victim.spawn_log) == 2
    # pool snapshot reconciles on the shared recorder
    snap = rec.fleet()
    assert snap["v"] == FLEET_V and snap["completed"] == 2
    assert snap["preemptions"] == 1 and snap["running"] == []


def test_requeued_job_taken_by_an_idle_slot_drains(tmp_path):
    """Two slots: a quick job drains on one while the victim blocks the
    other; the preempted victim re-queues while the quick job's slot waits
    idle, and that slot takes it before the first has closed its episode
    (the re-queue is held open 0.2 s here so that it always does).  Each episode closes its own ``job`` span and the pool drains
    (JAX's worker closes whatever span the unit holds by then, the next
    episode's: that slot's thread dies and the pool waits for it
    forever)."""

    class SlowRequeue(FleetScheduler):
        def _push(self, unit, fresh):
            super()._push(unit, fresh)
            if not fresh:
                time.sleep(0.2)

    recs = []

    def rf():
        r = FlightRecorder(capacity=256)
        recs.append(r)
        return r

    victim = FakeBuilder(unique=7, states=9, depth=2, recorder_factory=rf,
                         spawn_plan={0: {"block": True}})
    rec = FlightRecorder(capacity=1024)
    quick = FakeBuilder(unique=1, states=2, depth=1)
    sched = SlowRequeue(
        FleetSpec(jobs=[Job(key="victim", build=lambda: victim),
                        Job(key="quick", build=lambda: quick)], slots=2),
        root=str(tmp_path), recorder=rec,
        preemption=PreemptionPlan({"victim": 3}), stream=None,
    )
    out = {}
    runner = threading.Thread(
        target=lambda: out.setdefault("res", sched.run()), daemon=True)
    runner.start()
    deadline = time.monotonic() + 10.0
    n = 0
    while runner.is_alive() and time.monotonic() < deadline:
        if recs:
            n += 1
            recs[0].step(engine="fake", states=n, unique=n)
        time.sleep(0.005)
    runner.join(timeout=1.0)
    assert "res" in out, "the pool never drained"
    v = out["res"]["victim"]
    assert v.status == COMPLETED and v.preemptions == 1
    assert out["res"]["quick"].status == COMPLETED
    spans = [r for r in rec.records("span")
             if r["name"] == "job" and r["key"] == "victim"]
    # the two episodes ran on the two slots, each closing its own span
    assert len({r["span_id"] for r in spans}) == len(spans) == 2
    assert sorted(r["slot"] for r in spans) == [0, 1]


def test_fleet_result_json_and_metrics_view(tmp_path):
    res = run_fleet(
        FleetSpec(jobs=[_job("a"), _job("b")], slots=2),
        root=str(tmp_path), stream=None,
    )
    doc = res.to_json()
    assert doc["v"] == FLEET_V and doc["completed"] == 2
    assert len(doc["jobs"]) == 2
    json.dumps(doc)  # JSON-serializable end to end
    # the Explorer pool panel reads the fleet block off /.metrics
    from stateright_tpu_torch.explorer import _metrics_view

    class Host:
        flight_recorder = res.recorder

    view = _metrics_view(Host())
    assert view["fleet"]["slots"] == 2
    assert view["fleet"]["completed"] == 2


# -- campaigns ---------------------------------------------------------------


def test_expand_grid_cross_product_and_validation():
    pts = expand_grid({"b": [1, 2], "a": ["x"]})
    assert pts == [{"a": "x", "b": 1}, {"a": "x", "b": 2}]
    assert expand_grid({}) == [{}]
    assert expand_grid({"a": 3}) == [{"a": 3}]  # scalars auto-wrap
    with pytest.raises(ValueError):
        expand_grid({"a": []})


def test_campaign_spec_maps_grid_points_to_jobs():
    spec = campaign_spec(
        lambda n=3: FakeModel(), {"n": [3, 4]},
        campaign_id="c-test", priority_fn=lambda p: p["n"],
    )
    assert spec.campaign_id == "c-test"
    assert [j.key for j in spec.jobs] == ["n=3", "n=4"]
    assert [j.priority for j in spec.jobs] == [3, 4]
    assert all(j.packable for j in spec.jobs)
    assert spec.jobs[0].params == {"n": 3}
    # an omitted campaign_id still mints one (the grouping tag)
    anon = campaign_spec(lambda n=3: FakeModel(), {"n": [3]})
    assert anon.campaign_id


class _CampaignModel(FakeModel):
    """A fake model whose ``.checker()`` yields a FakeBuilder — the
    campaign build path prefers a model-provided checker factory."""

    def __init__(self, n):
        self.n = int(n)

    def checker(self):
        return FakeBuilder(unique=self.n, states=2 * self.n, depth=1)


def test_run_campaign_writes_the_ledger(tmp_path):
    spec = campaign_spec(_CampaignModel, {"n": [3, 5]},
                         campaign_id="c-led")
    res, ledger = run_campaign(spec, root=str(tmp_path), stream=None)
    assert res.completed == 2
    assert ledger["v"] == FLEET_V and ledger["campaign_id"] == "c-led"
    assert ledger["completed"] == 2 and ledger["failed"] == 0
    assert ledger["total_states"] == 6 + 10
    assert {r["key"] for r in ledger["results"]} == {"n=3", "n=5"}
    on_disk = json.loads((tmp_path / LEDGER_NAME).read_text())
    assert on_disk == ledger
    assert build_ledger(spec, res)["total_states"] == 16


def test_run_campaign_ledger_write_failure_degrades_loudly(tmp_path):
    target = tmp_path / "blocked"
    target.write_text("a file where the campaign root must go")
    spec = campaign_spec(_CampaignModel, {"n": [1]})
    err = io.StringIO()
    res, ledger = run_campaign(spec, root=str(target), stream=err)
    assert res.completed == 1  # the answer survives the artifact
    assert ledger["completed"] == 1
    assert "ledger write failed" in err.getvalue()


# -- CLI surfaces ------------------------------------------------------------


def test_pop_fleet_opts_parses_shared_flags():
    from stateright_tpu_torch.models._cli import _pop_fleet_opts

    opts, rest = _pop_fleet_opts(
        ["--slots=4", "--budget=1000", "--spill", "--no-pack",
         "--root=/r", "--runs=/q", "--every=0.5", "--stall=k@7",
         "--max-restarts=1", "--id=cid", "--grid={\"a\":[1]}",
         "positional"],
        {"slots": 2, "budget": None, "spill": False, "pack": True,
         "root": None, "runs": None, "every": 0.0, "stall": None,
         "max_restarts": 2, "id": None, "grid": None},
    )
    assert opts["slots"] == 4 and opts["budget"] == 1000
    assert opts["spill"] is True and opts["pack"] is False
    assert opts["root"] == "/r" and opts["runs"] == "/q"
    assert opts["every"] == 0.5 and opts["stall"] == "k@7"
    assert opts["max_restarts"] == 1 and opts["id"] == "cid"
    assert json.loads(opts["grid"]) == {"a": [1]}
    assert rest == ["positional"]


def test_campaign_verb_rejects_unknown_factory():
    from stateright_tpu_torch.models._cli import fleet_campaign

    out = io.StringIO()
    assert fleet_campaign(["nope"], stream=out) == 2
    assert "usage: campaign" in out.getvalue()


def test_runs_verb_groups_campaign_jobs(tmp_path):
    from stateright_tpu_torch.models._cli import fleet_runs

    reg = tmp_path / "runs"
    reg.mkdir()
    recs = [
        {"v": 1, "run_id": f"r{i}", "config_key": "cfg",
         "model": "M", "engine": "wavefront",
         "campaign_id": "camp-1", "job_key": f"job-{i}",
         "headline": {"unique": 10 + i, "done": True,
                      "discoveries": ["p"] if i else []},
         "generated_at": "2026-08-07T00:00:00+00:00"}
        for i in range(2)
    ]
    with open(reg / "index.jsonl", "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")
    out = io.StringIO()
    assert fleet_runs([str(reg)], stream=out) == 0
    text = out.getvalue()
    assert "campaign camp-1  2 job(s)  verdicts [.*]" in text
    assert "[job-0]" in text and "[job-1]" in text


# -- zero-coupling contract --------------------------------------------------


def test_engine_modules_never_import_the_fleet():
    """Fleet off ⇒ zero coupling: no engine/checker/sweep/telemetry
    module of the port may import its fleet (the scheduler calls into the
    engines, never the reverse), so a fleet-less run dispatches what it
    did by construction."""
    import stateright_tpu_torch

    root = os.path.dirname(stateright_tpu_torch.__file__)
    offenders = []
    for sub in ("parallel", "checker", "sweep", "telemetry", "spill",
                "ops"):
        for dirpath, _dirs, files in os.walk(os.path.join(root, sub)):
            for name in files:
                if not name.endswith(".py"):
                    continue
                path = os.path.join(dirpath, name)
                with open(path) as f:
                    src = f.read()
                for ln in src.splitlines():
                    stmt = ln.strip().split("#")[0]
                    if not (stmt.startswith("import ")
                            or stmt.startswith("from ")):
                        continue
                    if "fleet" in stmt:
                        offenders.append(
                            f"{os.path.relpath(path, root)}: {stmt}"
                        )
    assert not offenders, (
        f"engine modules import the fleet subsystem: {offenders}"
    )


def test_supervisor_yield_event_is_optional(tmp_path):
    """The cooperative-yield hook is pay-for-use: supervise() without
    yield_event completes as it does for every other caller."""
    from stateright_tpu_torch.supervisor import supervise

    b = FakeBuilder(unique=4, states=6, depth=1)
    run = supervise(b, autosave_dir=str(tmp_path), every_secs=60)
    assert run.yielded is False
    assert run.unique_state_count() == 4


# -- acceptance on device="cpu" (JAX tests/test_fleet.py:545-621) ------------
#
# Each acceptance fleet runs once per package (module fixtures): the pin
# tests read the port's run, ``test_fleet_matches_jax`` holds it against
# the JAX package's run of the same job list.


def _accept_pack(side, tmp):
    """Three packable 2pc-3 tenants and a 2pc-4 singleton over a 2-slot
    pool (JAX ``tests/test_fleet.py:545``)."""
    f = side.fleet
    runs = str(tmp / "runs")

    def job(key, n, packable, cap):
        return f.Job(key=key, build=side.build_2pc(n, runs=runs),
                     packable=packable, capacity=cap, batch=256)

    jobs = [
        job("2pc3-a", 3, True, 1 << 12),
        job("2pc3-b", 3, True, 1 << 12),
        job("2pc3-c", 3, True, 1 << 12),
        job("2pc4", 4, False, 1 << 13),
    ]
    res = f.run_fleet(
        f.FleetSpec(jobs=jobs, slots=2, campaign_id="camp-accept"),
        root=str(tmp / "fleet"), stream=None, **side.run_kw,
    )
    out = io.StringIO()
    rc = side.cli.fleet_runs([runs], stream=out)
    return {"res": res, "runs": runs, "runs_rc": rc,
            "runs_text": out.getvalue(),
            "index": side.RunRegistry(runs).index()}


def _accept_preempt(side, tmp):
    """A stall-preempted 2pc-4 resuming once beside a 2pc-3 on one slot
    (JAX ``tests/test_fleet.py:588``); its parent/child compare."""
    f = side.fleet
    runs = str(tmp / "runs")
    jobs = [
        f.Job(key="victim", build=side.build_2pc(4, runs=runs),
              capacity=1 << 13, batch=256),
        f.Job(key="other", build=side.build_2pc(3, runs=runs),
              capacity=1 << 12, batch=256),
    ]
    res = f.run_fleet(
        f.FleetSpec(jobs=jobs, slots=1), root=str(tmp / "fleet"),
        preemption=f.PreemptionPlan({"victim": 2}),
        every_secs=0.2, stream=None, **side.run_kw,
    )
    v = res["victim"]
    out = io.StringIO()
    rc = side.cli.compare_reports_cmd(
        [v.parent_run_id, v.run_id, f"--registry={runs}",
         "--expect=IDENTICAL"],
        out,
    )
    return {"res": res, "runs": runs, "root": tmp / "fleet",
            "compare_rc": rc, "compare_text": out.getvalue()}


def _both(factory, tmp_path_factory, name):
    return {side: factory(_SIDES[side](),
                          tmp_path_factory.mktemp(f"{name}-{side}"))
            for side in ("torch", "jax")}


@pytest.fixture(scope="module")
def accept_pack(tmp_path_factory):
    return _both(_accept_pack, tmp_path_factory, "pack")


@pytest.fixture(scope="module")
def accept_preempt(tmp_path_factory):
    return _both(_accept_preempt, tmp_path_factory, "preempt")


def test_fleet_acceptance_packs_and_matches_solo_counts(accept_pack):
    """Three packable 2pc-3 tenants and a 2pc-4 singleton over a 2-slot
    pool: every count at the solo pins, the three same-shape jobs in one
    cohort (one engine build), and every member in the registry under the
    campaign tag."""
    run = accept_pack["torch"]
    res = run["res"]
    assert res.completed == 4 and res.failed == 0 and res.refused == 0
    for k in ("2pc3-a", "2pc3-b", "2pc3-c"):
        assert (res[k].unique, res[k].states) == (288, 1146), k
        assert res[k].cohort
    assert (res["2pc4"].unique, res["2pc4"].states) == (1568, 8258)
    assert res["2pc4"].cohort is None
    assert res.engine_compiles < 4
    assert res.engine_compiles == 2
    assert sum(len(p["jobs"]) for p in res.packed) == 3
    tagged = [r for r in run["index"]
              if r.get("campaign_id") == "camp-accept"]
    assert {r.get("job_key") for r in tagged} == {
        "2pc3-a", "2pc3-b", "2pc3-c", "2pc4",
    }
    # the runs verb groups them under the campaign
    assert run["runs_rc"] == 0
    assert "campaign camp-accept  4 job(s)  verdicts [****]" \
        in run["runs_text"]


def test_fleet_acceptance_preempt_resume_exactly_once(accept_preempt):
    """An injected stall preempts the victim mid-run (snapshot + yield),
    the victim resumes from its final autosave generation, and the
    parent/child reports compare IDENTICAL under the lineage contract,
    with the uninterrupted run's counts."""
    run = accept_preempt["torch"]
    res = run["res"]
    assert res.completed == 2 and res.preemptions == 1
    v = res["victim"]
    assert v.status == COMPLETED and v.preemptions == 1
    assert (v.unique, v.states) == (1568, 8258)
    assert v.parent_run_id and v.run_id
    assert (res["other"].unique, res["other"].states) == (288, 1146)
    assert run["compare_rc"] == 0, run["compare_text"]
    assert "IDENTICAL (contract: lineage)" in run["compare_text"]
    # the victim's heartbeat lives under the pool root's jobs/
    from stateright_tpu_torch.checkpoint import read_progress

    assert read_progress(str(run["root"] / "jobs" / "victim"))[
        "verdict"] == "done"
    assert read_progress(str(run["root"]))["verdict"] == "done"


def test_runs_verb_groups_sweep_members(tmp_path):
    """JAX ``tests/test_sweep.py:468`` (which this jax cannot run; its
    pinned lines)."""
    from stateright_tpu_torch.models._cli import fleet_runs
    from stateright_tpu_torch.testing.sweep_fixtures import (
        bounded_counter_spec,
    )

    runs = str(tmp_path / "runs")
    spec = bounded_counter_spec([2, 3])
    spec.instances[0].model.checker().sweep(spec).runs(runs).spawn_gpu(
        device="cpu", batch=32).join()
    buf = io.StringIO()
    assert fleet_runs([runs], stream=buf) == 0
    out = buf.getvalue()
    assert "2 instance(s)" in out
    assert "verdicts [**]" in out
    assert "[bc-b2]" in out and "[bc-b3]" in out


def test_runs_verb_without_a_registry(tmp_path, monkeypatch):
    from stateright_tpu_torch.models._cli import fleet_runs

    monkeypatch.delenv("STATERIGHT_TPU_RUN_DIR", raising=False)
    out = io.StringIO()
    assert fleet_runs([], stream=out) == 2
    assert "no registry configured" in out.getvalue()
    out = io.StringIO()
    assert fleet_runs([str(tmp_path)], stream=out) == 0
    assert "is empty" in out.getvalue()


def test_fleet_verb_in_process(tmp_path):
    """The canned six-tenant fleet (JAX ``_cli.py:1347``) on the CPU: every
    pin, one packed cohort, the stall in 2pc-5 at step 5 resumed once and
    its lineage IDENTICAL, exit 0."""
    from stateright_tpu_torch.models._cli import fleet_schedule

    out = io.StringIO()
    rc = fleet_schedule([f"--root={tmp_path}", "--device=cpu"], stream=out)
    text = out.getvalue()
    assert rc == 0, text
    pins = {"2pc-a": (288, 1146), "2pc-b": (288, 1146),
            "2pc-c": (288, 1146), "2pc-4": (1568, 8258),
            "2pc-5": (8832, 58146), "paxos-1": (265, 482)}
    for key, (u, s) in pins.items():
        line = next(ln for ln in text.splitlines()
                    if ln.startswith(f"fleet job {key}:"))
        assert f"status=completed" in line and f"unique={u}" in line
        assert f"states={s}" in line, line
    assert "preemptions=1" in text and "packed=3" in text
    assert "IDENTICAL (contract: lineage)" in text


def test_campaign_verb_in_process(tmp_path):
    from stateright_tpu_torch.models._cli import fleet_campaign

    out = io.StringIO()
    rc = fleet_campaign(["2pc", f"--root={tmp_path}", "--device=cpu",
                         "--id=c-2pc"], stream=out)
    assert rc == 0, out.getvalue()
    ledger = json.loads((tmp_path / LEDGER_NAME).read_text())
    assert ledger["campaign_id"] == "c-2pc" and ledger["completed"] == 2
    assert ledger["total_states"] == 1146 + 8258
    assert "campaign c-2pc: completed=2 failed=0" in out.getvalue()


def test_launch_counters_are_exact_under_threads():
    from stateright_tpu_torch.ops import _cuda
    from stateright_tpu_torch.ops.cand_prep import cand_prep

    before = cand_prep.launches
    threads = [threading.Thread(target=lambda: [
        _cuda.count_launch(cand_prep) for _ in range(2000)])
        for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert cand_prep.launches - before == 16000
    cand_prep.launches = before


# -- against the JAX fleet on the same job lists (tolerance 0) ---------------
#
# Each scenario runs once through the JAX package (its fakes from
# tests/fleet_fakes.py, its TwoPhaseSys, its CLI) and once through the port
# (its fakes, its TwoPhaseSys on device="cpu", its CLI), and the two
# documents must be equal.  Normalised away, and only these: wall-clock
# fields (``t``, ``secs``, ``states_per_sec``) and the record ``seq``;
# run ids, which are random, kept as present or absent; the autosave
# generation number (``gen``), whose cadence is wall time; a job's
# ``slot`` where two slots race for the queue; the program name in a
# message; each side's own temporary directory; and the byte count in a
# start-rung refusal, which prices each engine's own buffers.  The port's names for the
# device engines (``gpu-wavefront``, ``gpu-sweep`` for ``wavefront``,
# ``sweep``) and its config keys, which hash those names, are mapped where
# the ``runs`` verb prints them.


def _jax_side():
    import stateright_tpu.fleet as fleet
    from stateright_tpu import core
    from stateright_tpu.checker.base import CheckerBuilder as Builder
    from stateright_tpu.explorer import _metrics_view
    from stateright_tpu.models import _cli
    from stateright_tpu.models.two_phase_commit import TwoPhaseSys as Sys
    from stateright_tpu.telemetry import FlightRecorder as Recorder
    from stateright_tpu.telemetry.registry import RunRegistry
    from tests import fleet_fakes as fakes

    return _side(fleet, core, Builder, _metrics_view, _cli, Sys, Recorder,
                 RunRegistry, fakes, "spawn_tpu", {})


def _torch_side():
    import stateright_tpu_torch.fleet as fleet
    from stateright_tpu_torch import core
    from stateright_tpu_torch.explorer import _metrics_view
    from stateright_tpu_torch.models import _cli
    from stateright_tpu_torch.telemetry.registry import RunRegistry
    from stateright_tpu_torch.testing import fleet_fakes as fakes

    return _side(fleet, core, CheckerBuilder, _metrics_view, _cli,
                 TwoPhaseSys, FlightRecorder, RunRegistry, fakes, "spawn_gpu",
                 {"device": "cpu"})


def _side(fleet, core, builder, metrics_view, cli, sys_, recorder,
          registry, fakes, spawn, run_kw):
    from types import SimpleNamespace

    def build_2pc(n, **builder_calls):
        def build():
            b = builder(sys_(n))
            for name, arg in builder_calls.items():
                b = getattr(b, name)(arg)
            return b

        return build

    return SimpleNamespace(
        fleet=fleet, core=core, metrics_view=metrics_view, cli=cli,
        Recorder=recorder, RunRegistry=registry,
        fakes=fakes, spawn=spawn, run_kw=run_kw, build_2pc=build_2pc,
    )


_SIDES = {"jax": _jax_side, "torch": _torch_side}

_WALL = {"t", "seq", "secs", "states_per_sec", "gen"}
_RUN_IDS = {"run_id", "parent_run_id"}
_PROG = re.compile(r"stateright-tpu(-torch)?:")
_TRANSIENT = re.compile(r"\(\d+B transient\)")


def _norm(x, slots=1):
    """The comparable part of a result, ledger or record document."""
    if isinstance(x, dict):
        return {
            k: (bool(v) if k in _RUN_IDS else _norm(v, slots))
            for k, v in x.items()
            if k not in _WALL and not (k == "slot" and slots > 1)
        }
    if isinstance(x, (list, tuple)):
        return [_norm(v, slots) for v in x]
    if isinstance(x, str):
        # a start rung's transient bytes price each engine's own buffers
        # (the port's are held to its live tensors by test_torch_memory)
        return _TRANSIENT.sub("(<B> transient)", _PROG.sub("stateright:", x))
    return x


def _trail(rec, slots):
    """The ``fleet`` and ``job`` records: in ring order on one slot, per
    job key where two slots interleave them."""
    fleet = [_norm(r, slots) for r in rec.records("fleet")]
    jobs = [_norm(r, slots) for r in rec.records("job")]
    if slots > 1:
        per_key = {}
        for r in jobs:
            per_key.setdefault(r["key"], []).append(r)
        jobs = per_key
    return {"fleet": fleet, "job": jobs}


def _result_doc(res):
    return {"result": _norm(res.to_json(), res.slots),
            "trail": _trail(res.recorder, res.slots),
            "snapshot": _norm(res.recorder.fleet(), res.slots)}


def _raised(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the error is the document
        return [type(e).__name__, str(e)]
    return None


def _fake_job(side, key, builder=None, **kw):
    b = builder if builder is not None else side.fakes.FakeBuilder()
    return side.fleet.Job(key=key, build=lambda: b, **kw)


def _sched_of(side, jobs, **spec_kw):
    f = side.fleet
    return f.FleetScheduler(f.FleetSpec(jobs=jobs, **spec_kw), stream=None,
                            **side.run_kw)


def _sc_spec(side, tmp, mp):
    f = side.fleet
    errors = [_raised(fn) for fn in (
        lambda: f.FleetSpec(jobs=[]),
        lambda: f.FleetSpec(jobs=[_fake_job(side, "a"),
                                  _fake_job(side, "a")]),
        lambda: f.FleetSpec(jobs=[_fake_job(side, "a")], slots=0),
        lambda: f.FleetSpec(jobs=[f.Job(key="a", build="not-callable")]),
        lambda: f.FleetSpec(jobs=["not-a-job"]),
    )]
    spec = f.FleetSpec(jobs=[_fake_job(side, "a"), _fake_job(side, "b")],
                       slots=3)
    j = f.Job(key="a", build=side.fakes.FakeBuilder, capacity=1 << 10,
              batch=64, queue_capacity=2048, steps_per_call=8,
              spawn_kw={"batch": 128})
    plan = f.PreemptionPlan({"a": 3})
    return {
        "errors": errors,
        "spec": [spec.slots, len(spec.jobs), spec.slot_budget_bytes,
                 spec.spill, spec.pack, spec.max_restarts,
                 spec.campaign_id],
        "engine_kw": j.engine_kw(),
        "due": [plan.due("a", 2), plan.due("a", 3), plan.due("a", 4),
                plan.due("b", 99)],
        "constants": [f.FLEET_V, f.LEDGER_NAME, f.ADMITTED,
                      f.ADMITTED_SPILL, f.REFUSED, f.COMPLETED, f.FAILED],
    }


def _sc_admission(side, tmp, mp):
    f = side.fleet
    rows = []

    def admit(job, **spec_kw):
        d, reason, _b = _sched_of(side, [job], **spec_kw)._admit(job)
        rows.append([job.key, spec_kw, d, reason])

    mp.delenv("STATERIGHT_TPU_DEVICE_BYTES", raising=False)
    admit(_fake_job(side, "host"))
    jp = f.Job(key="2pc", build=side.build_2pc(3), capacity=1 << 12,
               batch=256)
    admit(jp)
    mp.setenv("STATERIGHT_TPU_DEVICE_BYTES", str(100 * 10**9))
    admit(jp)
    admit(jp, slot_budget_bytes=100 * 10**9)
    mp.setenv("STATERIGHT_TPU_DEVICE_BYTES", "1000000")
    admit(f.Job(key="tiny", build=side.build_2pc(3), capacity=1 << 20,
                batch=1024))
    big = f.Job(key="big", build=side.build_2pc(
        3, target_states=10_000_000), capacity=1 << 12, batch=256)
    mp.setenv("STATERIGHT_TPU_DEVICE_BYTES", "30000000")
    admit(big)
    admit(big, spill=True)
    return rows


def _sc_host_engine(side, tmp, mp):
    core = side.core

    class Ring(core.Model):
        n = 4

        def init_states(self):
            return [0]

        def actions(self, state):
            return [("tick",)]

        def next_state(self, state, action):
            return (state + 1) % self.n

        def properties(self):
            return [core.Property.sometimes(
                "wrapped", lambda m, s: s == self.n - 1)]

    f = side.fleet
    res = _sched_of(side, [f.Job(key="ring",
                                 build=lambda: Ring().checker())]).run()
    return _result_doc(res)


def _sc_pack(side, tmp, mp):
    f = side.fleet

    def groups(jobs, decision, reason, **spec_kw):
        packed, leftover = _sched_of(side, jobs, **spec_kw)._pack(
            [(j, decision, reason) for j in jobs])
        return [[[j.key for j in members], cid] for members, cid in packed], \
            [[j.key, d, r] for j, d, r in leftover]

    real = [
        f.Job(key="a", build=side.build_2pc(3), packable=True),
        f.Job(key="b", build=side.build_2pc(3), packable=True),
        f.Job(key="c", build=side.build_2pc(4), packable=True),
        f.Job(key="d", build=side.build_2pc(3), packable=False),
        f.Job(key="e", build=side.build_2pc(4), packable=True),
    ]
    fakes = [_fake_job(side, "x", packable=True),
             _fake_job(side, "y", packable=True)]
    return {
        "shapes": groups(real, f.ADMITTED, None, slots=2),
        "no_pack": groups(fakes, f.ADMITTED, None, slots=1, pack=False),
        "unsignable": groups(fakes, f.ADMITTED, None, slots=1),
        "spilled": groups(real[:2], f.ADMITTED_SPILL, "spilled", slots=1),
    }


def _sc_priority(side, tmp, mp):
    f = side.fleet
    order = []

    def tracked(key):
        b = side.fakes.FakeBuilder(unique=3, states=5, depth=1)
        real = getattr(b, side.spawn)

        def spy(resume=None, **kw):
            order.append(key)
            return real(resume=resume, **kw)

        setattr(b, side.spawn, spy)
        return lambda: b

    jobs = [f.Job(key="low", build=tracked("low"), priority=0),
            f.Job(key="high", build=tracked("high"), priority=9),
            f.Job(key="mid", build=tracked("mid"), priority=5)]
    res = f.run_fleet(f.FleetSpec(jobs=jobs, slots=1), root=str(tmp),
                      stream=None, **side.run_kw)
    return {"order": order, **_result_doc(res)}


def _sc_failure(side, tmp, mp):
    f = side.fleet
    boom = side.fakes.FakeBuilder(
        spawn_plan={0: {"fail": RuntimeError("device on fire")}})
    err = io.StringIO()
    res = f.run_fleet(
        f.FleetSpec(jobs=[_fake_job(side, "bad", builder=boom),
                          _fake_job(side, "good")], slots=1,
                    max_restarts=0),
        root=str(tmp), stream=err, **side.run_kw)
    return {"said": err.getvalue(), **_result_doc(res)}


def _sc_refused(side, tmp, mp):
    f = side.fleet
    mp.setenv("STATERIGHT_TPU_DEVICE_BYTES", "1000000")
    huge = f.Job(key="huge", build=side.build_2pc(3), capacity=1 << 20,
                 batch=1024)
    err = io.StringIO()
    res = f.run_fleet(f.FleetSpec(jobs=[huge, _fake_job(side, "ok")],
                                  slots=1),
                      root=str(tmp), stream=err, **side.run_kw)
    return {"said": err.getvalue(), **_result_doc(res)}


def _sc_stall(side, tmp, mp):
    """JAX ``tests/test_fleet.py:262``: the victim blocks on the only
    slot until its injected stall preempts it."""
    f = side.fleet
    recs = []

    def rf():
        r = side.Recorder(capacity=256)
        recs.append(r)
        return r

    log = []
    victim = side.fakes.FakeBuilder(unique=7, states=9, depth=2,
                                    recorder_factory=rf, spawn_log=log,
                                    spawn_plan={0: {"block": True}})
    other = side.fakes.FakeBuilder(unique=1, states=2, depth=1)
    jobs = [f.Job(key="victim", build=lambda: victim),
            f.Job(key="other", build=lambda: other)]
    rec = side.Recorder(capacity=1024)
    err = io.StringIO()
    sched = f.FleetScheduler(
        f.FleetSpec(jobs=jobs, slots=1), root=str(tmp), recorder=rec,
        preemption=f.PreemptionPlan({"victim": 3}), stream=err,
        **side.run_kw)
    stop = threading.Event()

    def drive():
        deadline = time.monotonic() + 10.0
        n = 0
        while not stop.is_set() and time.monotonic() < deadline:
            if recs:
                n += 1
                recs[0].step(engine="fake", states=n, unique=n)
                if any(h.get("reason") == "injected"
                       for h in recs[0].records("health")):
                    return
            time.sleep(0.005)

    t = threading.Thread(target=drive, daemon=True)
    t.start()
    try:
        res = sched.run()
    finally:
        stop.set()
        t.join(timeout=5)
    health = [h for h in recs[0].records("health")
              if h.get("event") == "stall"]
    return {"spawns": len(log), "said": err.getvalue(), "stall": health,
            **_result_doc(res)}


def _sc_result_json(side, tmp, mp):
    f = side.fleet
    res = f.run_fleet(f.FleetSpec(jobs=[_fake_job(side, "a"),
                                        _fake_job(side, "b")], slots=2),
                      root=str(tmp), stream=None, **side.run_kw)

    class Host:
        flight_recorder = res.recorder

    return {"fleet_view": _norm(side.metrics_view(Host())["fleet"], 2),
            **_result_doc(res)}


class _JaxCampaignModel:
    """``_CampaignModel`` for the JAX side: its ``checker()`` yields the
    JAX package's FakeBuilder."""

    def __init__(self, n):
        self.n = int(n)

    def checker(self):
        from tests.fleet_fakes import FakeBuilder as JaxFakeBuilder

        return JaxFakeBuilder(unique=self.n, states=2 * self.n, depth=1)


def _sc_campaign(side, tmp, mp):
    f = side.fleet
    model = _CampaignModel if side.spawn == "spawn_gpu" \
        else _JaxCampaignModel
    grids = [f.expand_grid(g) for g in (
        {"b": [1, 2], "a": ["x"]}, {}, {"a": 3}, {"b": [1], "a": [2, 3]})]
    spec = f.campaign_spec(
        lambda n=3: side.fakes.FakeModel(), {"n": [3, 4]},
        campaign_id="c-test", priority_fn=lambda p: p["n"],
        capacity=1 << 11, batch=128, slots=3, spill=True,
    )
    jobs = [[j.key, j.priority, j.packable, j.params, j.capacity,
             j.batch, j.engine_kw()] for j in spec.jobs]
    anon = f.campaign_spec(lambda n=3: side.fakes.FakeModel(), {"n": [3]})
    lspec = f.campaign_spec(model, {"n": [3, 5]}, campaign_id="c-led")
    res, ledger = f.run_campaign(lspec, root=str(tmp / "c"), stream=None,
                                 **side.run_kw)
    on_disk = json.loads((tmp / "c" / f.LEDGER_NAME).read_text())
    blocked = tmp / "blocked"
    blocked.write_text("a file where the campaign root must go")
    err = io.StringIO()
    _res, bledger = f.run_campaign(
        f.campaign_spec(model, {"n": [1]}, campaign_id="c-blocked"),
        root=str(blocked), stream=err, **side.run_kw)
    return {
        "grids": grids,
        "empty_axis": _raised(lambda: f.expand_grid({"a": []})),
        "spec": [spec.campaign_id, spec.slots, spec.spill, spec.pack,
                 spec.max_restarts, spec.slot_budget_bytes],
        "jobs": jobs,
        "anon": bool(anon.campaign_id),
        "ledger": ledger, "on_disk": on_disk == ledger,
        "rebuilt": f.build_ledger(lspec, res),
        "blocked": [bledger,
                    err.getvalue().replace(str(blocked), "<blocked>")],
    }


def _sc_cli(side, tmp, mp):
    cli = side.cli
    defaults = {"slots": 2, "budget": None, "spill": False, "pack": True,
                "root": None, "runs": None, "every": 0.0, "stall": None,
                "max_restarts": 2, "id": None, "grid": None}
    parsed = cli._pop_fleet_opts(
        ["--slots=4", "--budget=1000", "--spill", "--no-pack", "--root=/r",
         "--runs=/q", "--every=0.5", "--stall=k@7", "--max-restarts=1",
         "--id=cid", '--grid={"a":[1]}', "positional", "--other"],
        dict(defaults))
    reg = tmp / "runs"
    reg.mkdir()
    with open(reg / "index.jsonl", "w") as fh:
        for i in range(3):
            fh.write(json.dumps({
                "v": 1, "run_id": f"r{i}", "config_key": "cfg",
                "model": "M", "engine": "wavefront",
                "campaign_id": "camp-1" if i < 2 else None,
                "job_key": f"job-{i}",
                "headline": {"unique": 10 + i, "done": i != 1,
                             "discoveries": ["p"] if i else []},
                "generated_at": "2026-08-07T00:00:00+00:00"}) + "\n")
    texts = []
    for args in ([str(reg)], [str(tmp)], []):
        mp.delenv("STATERIGHT_TPU_RUN_DIR", raising=False)
        out = io.StringIO()
        rc = cli.fleet_runs(args, stream=out)
        texts.append([rc, out.getvalue().replace(str(tmp), "<tmp>")])
    out = io.StringIO()
    rc = cli.fleet_campaign(["nope"], stream=out)
    return {"parsed": list(parsed), "runs": texts,
            "campaign_usage": [rc, out.getvalue().startswith(
                "usage: campaign [2pc|paxos] [--grid=JSON]")]}


_ENGINE = re.compile(r"\b(?:gpu-)?(wavefront|sweep)\b")
_HEX16 = re.compile(r"\b[0-9a-f]{16}\b")
_STAMP = re.compile(r"\s\d+(\.\d+)?/s|\d{4}-\d\d-\d\dT[0-9:+]+")


def _runs_lines(text, tmp):
    """The ``runs`` verb's lines, ids and stamps masked, each group's
    member lines sorted (two slots finish in either order)."""
    text = _STAMP.sub("", _HEX16.sub("<id>", text.replace(str(tmp), "<tmp>")))
    return sorted(_ENGINE.sub(r"\1", ln) for ln in text.splitlines())


def _index_doc(index):
    return sorted(
        [r.get("job_key"), r.get("campaign_id"), r.get("instance_key"),
         r["model"], _ENGINE.sub(r"\1", r["engine"]),
         {k: r["headline"].get(k)
          for k in ("states", "unique", "max_depth", "done",
                    "discoveries")}]
        for r in index)


def _acc_pack_doc(run):
    res = run["res"]
    return {**_result_doc(res), "engine_compiles": res.engine_compiles,
            "packed": _norm(res.packed), "runs_rc": run["runs_rc"],
            "runs": _runs_lines(run["runs_text"],
                                os.path.dirname(run["runs"])),
            "index": _index_doc(run["index"])}


def _acc_preempt_doc(run):
    res = run["res"]
    text = _HEX16.sub("<id>", run["compare_text"])
    return {**_result_doc(res), "engine_compiles": res.engine_compiles,
            "compare_rc": run["compare_rc"],
            "compare": [ln for ln in text.splitlines()
                        if not ln.startswith(("  throughput:", "{"))]}


_SCENARIOS = {
    "spec": _sc_spec,
    "admission": _sc_admission,
    "host_engine": _sc_host_engine,
    "pack": _sc_pack,
    "priority": _sc_priority,
    "failure": _sc_failure,
    "refused": _sc_refused,
    "stall": _sc_stall,
    "result_json": _sc_result_json,
    "campaign": _sc_campaign,
    "cli": _sc_cli,
}


@pytest.mark.parametrize("scenario", list(_SCENARIOS))
def test_fleet_matches_jax(scenario, tmp_path, monkeypatch):
    """The JAX fleet and the port's over the same jobs: decisions,
    reasons, cohorts, the record trail, results and ledgers equal."""
    docs = {}
    for name in ("jax", "torch"):
        tmp = tmp_path / name
        tmp.mkdir()
        with monkeypatch.context() as mp:
            docs[name] = _norm(
                _SCENARIOS[scenario](_SIDES[name](), tmp, mp))
    assert docs["torch"] == docs["jax"]


@pytest.mark.parametrize("scenario", ["pack", "preempt"])
def test_fleet_acceptance_matches_jax(scenario, accept_pack,
                                      accept_preempt):
    """Both acceptances, JAX's TwoPhaseSys fleet against the port's on
    ``device="cpu"``: results, cohorts, ``engine_compiles``, the record
    trail, the registry and the ``runs`` and ``compare`` verbs' lines."""
    runs, doc = {"pack": (accept_pack, _acc_pack_doc),
                 "preempt": (accept_preempt, _acc_preempt_doc)}[scenario]
    assert doc(runs["torch"]) == doc(runs["jax"])
