"""The port's supervisor (``stateright_tpu_torch/supervisor.py``) against
the JAX package's (``stateright_tpu/supervisor.py``; the port's
counterparts of ``tests/test_robustness.py:127-221`` and :412-743),
tolerance 0:

 - the failure taxonomy: the JAX cases, plus the card's own shapes
   (``torch.OutOfMemoryError`` is ``oom``; every other CUDA error, a kernel
   build failure and "no CUDA device" are ``fatal``), with no retry of a
   fatal failure, the restart budget and the bounded backoff;
 - 2pc-5 supervised and killed at its seventh host sync: the JAX run's
   counts, newest generation, manifest totals, table bytes, queue rows
   and ``restart`` record;
 - an injected growth OOM: the spill tier armed (evicting, the JAX run's
   degradations and counts), or with the tier armed already the batch
   halved, in both packages;
 - a real (constructed) ``torch.OutOfMemoryError`` at a growth: the
   budget pinned from the snapshot and the resumed run evicting;
 - a killed parent's stub archived, the lineage diff ``IDENTICAL``, and
   the stub document equal to JAX's; the yield event; no trail left on
   the builder; a ``snapshot_write`` kill reaching the supervisor;
 - the ``supervise`` verb: SIGKILLed by a plan, resumed by the same
   command, lineage ``IDENTICAL``.

Every GPU run here is on ``device="cpu"``; the supervisor never moves a
run there by itself."""

import errno
import json
import os
import signal
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (both frameworks in one process, JAX on the CPU)

from stateright_tpu import checkpoint as jax_ckpt
from stateright_tpu import supervisor as jax_sup
from stateright_tpu.models.two_phase_commit import TwoPhaseSys as JaxSys
from stateright_tpu.parallel.tensor_model import twin_or_none
from stateright_tpu.telemetry.memory import total_bytes as jax_total
from stateright_tpu.telemetry.memory import wavefront_specs as jax_specs
from stateright_tpu.testing import faults as jax_faults
from stateright_tpu_torch import checkpoint as ckpt
from stateright_tpu_torch import supervisor as sup
from stateright_tpu_torch.models._cli import compare_verb
from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
from stateright_tpu_torch.ops._cuda import KernelBuildError
from stateright_tpu_torch.parallel.wavefront import GpuChecker, memory_spec_fn
from stateright_tpu_torch.supervisor import (
    FATAL,
    IO,
    OOM,
    PREEMPTION,
    classify_failure,
    supervise,
)
from stateright_tpu_torch.telemetry.memory import ENV_DEVICE_BYTES, total_bytes
from stateright_tpu_torch.telemetry.registry import RunRegistry
from stateright_tpu_torch.testing.faults import (
    Fault,
    FaultPlan,
    InjectedKill,
    InjectedOOM,
)

REPO = Path(__file__).resolve().parent.parent
UNIQUE_2PC3, STATES_2PC3 = 288, 1146
UNIQUE_2PC4, STATES_2PC4 = 1568, 8258
UNIQUE_2PC5, STATES_2PC5 = 8832, 58146
NO_SLEEP = dict(sleep=lambda s: None)
# the JAX chaos acceptance run's configuration (test_robustness.py:495)
KILL_KW = dict(batch=64, steps_per_call=2)
# the growth-OOM runs (test_robustness.py:546-591)
OOM_BATCH, OOM_BLOOM, OOM_QCAP = 128, 1 << 14, 4096
OOM_KW = dict(batch=OOM_BATCH, steps_per_call=8, capacity=1 << 12,
              queue_capacity=OOM_QCAP, spill_bloom_bits=OOM_BLOOM)


# -- the taxonomy ----------------------------------------------------------------


XlaRuntimeError = type("XlaRuntimeError", (RuntimeError,), {})
SHARED_CASES = [
    (lambda k: k.InjectedKill("x"), PREEMPTION),
    (lambda k: KeyboardInterrupt(), PREEMPTION),
    (lambda k: SystemExit(1), PREEMPTION),
    (lambda k: k.InjectedOOM("RESOURCE_EXHAUSTED: x"), OOM),
    (lambda k: XlaRuntimeError("RESOURCE_EXHAUSTED: out of memory"), OOM),
    (lambda k: XlaRuntimeError("INTERNAL: boom"), FATAL),
    (lambda k: RuntimeError("RESOURCE_EXHAUSTED: out of memory"), OOM),
    (lambda k: OSError(errno.EIO, "disk"), IO),
    (lambda k: ValueError("model bug"), FATAL),
    (lambda k: RuntimeError("poisoned rows"), FATAL),
]


@pytest.mark.parametrize("make,cls", SHARED_CASES)
def test_classify_failure_agrees_with_jax(make, cls):
    assert classify_failure(make(sup_faults())) == cls
    assert jax_sup.classify_failure(make(jax_faults)) == cls


def sup_faults():
    from stateright_tpu_torch.testing import faults

    return faults


@pytest.mark.parametrize("exc,cls", [
    (torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"),
     OOM),
    (torch.cuda.OutOfMemoryError("CUDA out of memory."), OOM),
    (type("OutOfMemoryError", (RuntimeError,), {})("allocator"), OOM),
    (RuntimeError("CUDA error: out of memory"), OOM),
    (RuntimeError("CUDA error: device-side assert triggered"), FATAL),
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     FATAL),
    (RuntimeError("CUDA error: unspecified launch failure"), FATAL),
    (RuntimeError("cand_prep: CUDA error 700 at launch"), FATAL),
    (RuntimeError("spawn_gpu(): no CUDA device is available (the port "
                  "never falls back to the CPU)"), FATAL),
    (KernelBuildError("the CUDA kernels could not be built or loaded: "
                      "OSError: libsrt_kernels.so: cannot open"), FATAL),
])
def test_classify_failure_on_the_cards_shapes(exc, cls):
    assert classify_failure(exc) == cls


def test_a_kernel_load_failure_is_fatal_though_it_wraps_an_oserror():
    try:
        try:
            raise OSError(errno.ENOENT, "no nvcc")
        except OSError as e:
            raise KernelBuildError(str(e)) from e
    except KernelBuildError as e:
        assert isinstance(e.__cause__, OSError)
        assert classify_failure(e) == FATAL


@pytest.mark.parametrize("exc", [
    ValueError("model bug"),
    RuntimeError("CUDA error: device-side assert triggered"),
    KernelBuildError("nvcc failed"),
    RuntimeError("spawn_gpu(): no CUDA device is available"),
])
def test_supervise_reraises_fatal_without_retry(tmp_path, exc):
    calls = []

    def spawn(b, resume=None, **kw):
        calls.append(1)
        raise exc

    with pytest.raises(type(exc)):
        supervise(TwoPhaseSys(3).checker(), autosave_dir=str(tmp_path),
                  spawn=spawn, **NO_SLEEP)
    assert len(calls) == 1


def test_supervise_respects_the_restart_budget(tmp_path):
    def spawn(b, resume=None, **kw):
        raise InjectedKill("always")

    with pytest.raises(InjectedKill):
        supervise(TwoPhaseSys(3).checker(), autosave_dir=str(tmp_path),
                  spawn=spawn, max_restarts=3, **NO_SLEEP)


def test_supervise_backoff_is_bounded_and_grows(tmp_path):
    delays = []
    boom = [0]

    def spawn(b, resume=None, **kw):
        if boom[0] < 4:
            boom[0] += 1
            raise InjectedKill("x")
        return b.spawn_gpu(device="cpu", batch=64, resume=resume)

    res = supervise(TwoPhaseSys(3).checker(), autosave_dir=str(tmp_path),
                    spawn=spawn, max_restarts=5, backoff_base=0.5,
                    backoff_max=2.0, sleep=delays.append, seed=1)
    assert res.restarts == 4 and len(delays) == 4
    assert delays[0] <= 0.5 * 1.25
    assert all(d <= 2.0 * 1.25 for d in delays)
    assert delays[1] >= delays[0] / 1.25
    assert res.unique_state_count() == UNIQUE_2PC3
    # the JAX supervisor draws the same jittered delays from the same seed
    jdelays = []
    jboom = [0]

    def jspawn(b, resume=None, **kw):
        if jboom[0] < 4:
            jboom[0] += 1
            raise jax_faults.InjectedKill("x")
        return b.spawn_tpu(sync=True, batch=64, resume=resume)

    jax_sup.supervise(JaxSys(3).checker(), autosave_dir=str(tmp_path / "j"),
                      spawn=jspawn, max_restarts=5, backoff_base=0.5,
                      backoff_max=2.0, sleep=jdelays.append, seed=1)
    assert delays == jdelays


# -- 2pc-5 killed mid-run, against the JAX supervisor ------------------------------


@pytest.fixture(scope="module")
def killed_2pc5(tmp_path_factory):
    """The same plan (a kill at host sync 6) under both supervisors."""
    out = {}
    for name, pkg_sup, pkg_faults, model in (
            ("port", sup, sup_faults(), TwoPhaseSys),
            ("jax", jax_sup, jax_faults, JaxSys)):
        d = str(tmp_path_factory.mktemp(f"kill-{name}"))
        plan = pkg_faults.FaultPlan(
            [pkg_faults.Fault(site="host_sync", action="kill", at=6)])
        kw = dict(KILL_KW, device="cpu") if name == "port" else KILL_KW
        with plan:
            res = pkg_sup.supervise(
                model(5).checker().telemetry(), autosave_dir=d,
                every_secs=0.0, max_restarts=3, **NO_SLEEP, **kw)
        out[name] = (res, plan, d)
    return out


def test_killed_2pc5_resumes_to_the_pinned_counts(killed_2pc5):
    res, plan, _ = killed_2pc5["port"]
    assert plan.fired and plan.fired[0]["site"] == "host_sync"
    assert res.restarts == 1
    assert (res.unique_state_count(), res.state_count()) == (
        UNIQUE_2PC5, STATES_2PC5)
    assert res.checker.parent_run_id
    res.checker.assert_properties()
    assert [a.outcome for a in res.attempts] == [PREEMPTION, "completed"]
    assert res.checker.durability_status(live=False) == {
        "v": ckpt.CKPT_V, "restarts": 1,
        "autosave": {"every_secs": 0.0, "keep": 3}}


def test_killed_2pc5_leaves_the_jax_runs_generations(killed_2pc5):
    (t, tplan, td), (j, jplan, jd) = killed_2pc5["port"], killed_2pc5["jax"]
    assert tplan.fired == jplan.fired  # the same sync, the same unique
    assert ckpt.latest_gen_number(td) == jax_ckpt.latest_gen_number(jd)
    tm, jm = ckpt.latest_generation(td)[1], jax_ckpt.latest_generation(jd)[1]
    assert tm["totals"] == jm["totals"]
    assert tm["restarts"] == jm["restarts"] == 1
    assert [g["gen"] for g in ckpt.list_generations(td)] == [
        g["gen"] for g in jax_ckpt.list_generations(jd)]


def test_killed_2pc5_ends_on_the_jax_runs_table_and_queue(killed_2pc5):
    t, j = killed_2pc5["port"][0].checker, killed_2pc5["jax"][0].checker
    for a, b in zip(t._table_np(), j._table_np()):
        np.testing.assert_array_equal(a, np.asarray(b))
    ts, js = t.final_snapshot(), j.checkpoint()
    tail = int(ts["tail"])
    assert int(js["tail"]) == tail and int(js["head"]) == int(ts["head"])
    for k in ("q_rows", "q_fp", "q_ebits", "q_depth"):
        np.testing.assert_array_equal(np.asarray(ts[k])[:tail],
                                      np.asarray(js[k])[:tail], err_msg=k)
    assert set(t.discoveries()) == set(j.discoveries())


def test_killed_2pc5_restart_record_matches_jax(killed_2pc5):
    recs = []
    for name in ("port", "jax"):
        c = killed_2pc5[name][0].checker
        (r,) = c.flight_recorder.records("restart")
        assert r["parent_run_id"] == c.parent_run_id
        recs.append({k: v for k, v in r.items()
                     if k not in ("t", "seq", "parent_run_id", "span")})
        assert c.flight_recorder.meta_snapshot()["restarts"] == 1
        assert c.flight_recorder.meta_snapshot()["supervised"] is True
    assert recs[0] == recs[1] == {"kind": "restart", "v": 1, "attempt": 1,
                                  "reason": PREEMPTION}


# -- growth OOM: the degradations --------------------------------------------------


def oom_budgets() -> tuple:
    """``(jax_budget, port_budget)``, each package's own, admitting the
    2^13 table rung but not the growth to 2^14 (test_robustness.py:
    560-571), so both evict at the same rung."""
    m = JaxSys(5)
    twin = twin_or_none(m)
    p = len(list(m.properties()))
    sp = (OOM_BLOOM, 4 * OOM_BATCH * twin.max_actions)
    spec = memory_spec_fn(TwoPhaseSys(5).tensor_model(), p, cuda=False,
                          spill=sp)

    def jtot(cap):
        return jax_total(jax_specs(twin, p, cap, OOM_QCAP, OOM_BATCH,
                                   spill=sp))

    def ttot(cap):
        return total_bytes(spec({"cap": cap, "qcap": OOM_QCAP,
                                 "batch": OOM_BATCH, "cand": 4096}))

    return (jtot(1 << 13) + jtot(1 << 14) - 1,
            ttot(1 << 13) + ttot(1 << 14) - 1)


def oom_run(pkg: str, tmp_path, monkeypatch, budget, armed: bool = False):
    monkeypatch.setenv("STATERIGHT_TPU_CAPACITY_GUARD", "off")
    if budget is None:
        monkeypatch.delenv(ENV_DEVICE_BYTES, raising=False)
    else:
        monkeypatch.setenv(ENV_DEVICE_BYTES, str(budget))
    f, s, model = ((sup_faults(), sup, TwoPhaseSys) if pkg == "port"
                   else (jax_faults, jax_sup, JaxSys))
    b = model(5).checker().telemetry()
    if armed:
        b = b.spill()
    kw = dict(OOM_KW, device="cpu") if pkg == "port" else OOM_KW
    plan = f.FaultPlan([f.Fault(site="growth", action="oom", at=0)])
    with plan:
        res = s.supervise(b, autosave_dir=str(tmp_path / f"auto-{pkg}"),
                          every_secs=0.0, max_restarts=3, **NO_SLEEP, **kw)
    assert plan.fired and plan.fired[0]["site"] == "growth"
    return res, b


def test_injected_growth_oom_degrades_to_spill_eviction(tmp_path,
                                                        monkeypatch):
    jb, tb = oom_budgets()
    t, _ = oom_run("port", tmp_path, monkeypatch, tb)
    j, _ = oom_run("jax", tmp_path, monkeypatch, jb)
    assert t.restarts == j.restarts == 1
    assert t.degradations == j.degradations == ["spill_armed"]
    assert t.attempts[0].outcome == OOM and t.attempts[0].degradation == \
        "spill_armed"
    for r in (t, j):
        assert (r.unique_state_count(), r.state_count()) == (
            UNIQUE_2PC5, STATES_2PC5)
        assert r.checker.spill_status()["evictions"] >= 1
    t.checker.assert_properties()
    assert t.checker.durability_status(live=False)["degradations"] == [
        "spill_armed"]
    (rec,) = t.checker.flight_recorder.records("restart")
    assert rec["reason"] == OOM and rec["degradation"] == "spill_armed"
    # the run report's durability block and its markdown carry the trail
    # as the JAX report does (report.py:303-310, :570)
    from stateright_tpu.telemetry.report import build_report as jax_report
    from stateright_tpu_torch.telemetry.report import (
        build_report,
        render_markdown,
    )

    body = build_report(t.checker)
    assert body["durability"] == jax_report(j.checker)["durability"] == {
        "v": 1, "restarts": 1, "degradations": ["spill_armed"],
        "autosave": {"every_secs": 0.0, "keep": 3}}
    md = render_markdown(body, t.checker.flight_recorder)
    assert "- supervised restarts: **1**" in md
    assert "- degradation: `spill_armed`" in md


def test_growth_oom_with_spill_armed_halves_the_batch(tmp_path, monkeypatch):
    """The branch the JAX POR test takes (test_robustness.py:594-621):
    with the spill tier armed already, the move is to halve the batch,
    and the halving lands on the resumed run's layout."""
    t, tb = oom_run("port", tmp_path, monkeypatch, None, armed=True)
    j, jb = oom_run("jax", tmp_path, monkeypatch, None, armed=True)
    assert t.degradations == j.degradations == ["batch_shrunk(128->64)"]
    assert t.checker._batch == j.checker._batch == 64
    for r in (t, j):
        assert (r.unique_state_count(), r.state_count()) == (
            UNIQUE_2PC5, STATES_2PC5)
    # the supervisor restores the builder's own settings
    assert tb.spill_mode is True and tb.autosave_opts is None


def test_spill_armed_by_the_env_knob_halves_the_batch(tmp_path,
                                                     monkeypatch):
    """With the tier armed by ``STATERIGHT_TPU_SPILL=1`` rather than the
    builder, arming it again would change nothing: the move is the batch
    (a deliberate difference: JAX looks at the builder only)."""
    monkeypatch.setenv("STATERIGHT_TPU_SPILL", "1")
    monkeypatch.setenv("STATERIGHT_TPU_CAPACITY_GUARD", "off")
    plan = FaultPlan([Fault(site="growth", action="oom", at=0)])
    b = TwoPhaseSys(5).checker()
    with plan:
        res = supervise(b, autosave_dir=str(tmp_path), every_secs=0.0,
                        max_restarts=2, **NO_SLEEP, device="cpu", **OOM_KW)
    assert res.degradations == ["batch_shrunk(128->64)"]
    assert res.checker._spill and res.checker._batch == 64
    assert (res.unique_state_count(), res.state_count()) == (
        UNIQUE_2PC5, STATES_2PC5)
    assert b.spill_mode is None


def test_a_second_oom_ends_the_run(tmp_path):
    plan = FaultPlan([Fault(site="growth", action="oom", at=0),
                      Fault(site="growth", action="oom", at=1)])
    with plan:
        with pytest.raises(InjectedOOM):
            supervise(TwoPhaseSys(5).checker(),
                      autosave_dir=str(tmp_path), every_secs=0.0,
                      max_restarts=5, **NO_SLEEP, device="cpu",
                      **{k: v for k, v in OOM_KW.items()
                         if k != "spill_bloom_bits"})
    assert len(plan.fired) == 2


def test_real_oom_pins_a_budget_below_the_known_one(monkeypatch):
    """The port's rule after a real OOM (supervisor.py's docstring): the
    card's memory is always known, so a budget of twice the snapshot's
    footprint is pinned whenever it is below the budget in force; an
    injected OOM pins only where none is known (JAX's rule)."""
    snap = {"footprint_bytes": np.int64(1000)}
    monkeypatch.setenv(ENV_DEVICE_BYTES, str(10 ** 9))
    assert sup._pin_budget_from_snapshot(snap, real_oom=False) is None
    pinned = sup._pin_budget_from_snapshot(snap, real_oom=True)
    assert pinned == (2000, str(10 ** 9))
    assert os.environ[ENV_DEVICE_BYTES] == "2000"
    # a budget already below the pin stays
    monkeypatch.setenv(ENV_DEVICE_BYTES, "1500")
    assert sup._pin_budget_from_snapshot(snap, real_oom=True) is None
    monkeypatch.delenv(ENV_DEVICE_BYTES)
    assert sup._pin_budget_from_snapshot(snap, real_oom=False,
                                         device="cpu") == (2000, None)
    assert sup._pin_budget_from_snapshot({}, real_oom=True) is None


def test_a_real_oom_at_growth_evicts_under_the_pinned_budget(tmp_path,
                                                             monkeypatch):
    """A ``torch.OutOfMemoryError`` raised where a growth allocates (the
    card's own failure, constructed here on the CPU) under a known budget
    too large to evict: the supervisor pins twice the boundary snapshot's
    footprint, so the spill-armed resume evicts instead of meeting the
    same wall, and the budget is restored afterwards."""
    monkeypatch.setenv(ENV_DEVICE_BYTES, str(10 ** 12))
    monkeypatch.setenv("STATERIGHT_TPU_CAPACITY_GUARD", "off")
    regrow = GpuChecker._regrow
    hit = []

    def wall(self, carry, cap, qcap, batch, status, cand, at=None,
             evict=False):
        if at == "growth" and cap >= 1 << 13 and not self._spill:
            hit.append(cap)
            raise torch.OutOfMemoryError(
                "CUDA out of memory. Tried to allocate 2.00 MiB")
        return regrow(self, carry, cap, qcap, batch, status, cand, at=at,
                      evict=evict)

    monkeypatch.setattr(GpuChecker, "_regrow", wall)
    b = TwoPhaseSys(5).checker().telemetry()
    res = supervise(b, autosave_dir=str(tmp_path), every_secs=0.0,
                    max_restarts=2, **NO_SLEEP, device="cpu", **OOM_KW)
    assert hit and res.restarts == 1
    (deg,) = res.degradations
    assert deg.startswith("spill_armed(budget=")
    assert res.attempts[0].outcome == OOM
    assert res.checker.spill_status()["evictions"] >= 1
    assert (res.unique_state_count(), res.state_count()) == (
        UNIQUE_2PC5, STATES_2PC5)
    assert os.environ[ENV_DEVICE_BYTES] == str(10 ** 12)
    assert b.spill_mode is None


# -- durability ----------------------------------------------------------------------


def test_killed_parent_gets_stub_archived_and_lineage_gate_passes(
        tmp_path, capsys):
    auto, runs = str(tmp_path / "auto"), str(tmp_path / "runs")
    kw = dict(autosave_dir=auto, every_secs=0.0, max_restarts=0,
              **NO_SLEEP, device="cpu", capacity=1 << 12, batch=32,
              steps_per_call=2)
    plan = FaultPlan([Fault(site="host_sync", action="kill", at=4)])
    with plan:
        with pytest.raises(InjectedKill):
            supervise(TwoPhaseSys(3).checker().telemetry().runs(runs), **kw)
    _, man = ckpt.latest_generation(auto)
    parent_id = man["run_id"]
    assert RunRegistry(runs).index() == []  # the parent never archived
    res = supervise(TwoPhaseSys(3).checker().telemetry().runs(runs), **kw)
    assert res.unique_state_count() == UNIQUE_2PC3
    child_id = res.checker.run_id
    reg = RunRegistry(runs)
    assert {parent_id, child_id} <= {r["run_id"] for r in reg.index()}
    stub = reg.load(parent_id)
    assert stub["totals"]["interrupted"] is True
    assert stub["totals"]["done"] is False
    assert [r["run_id"] for r in reg.chain(child_id)] == [parent_id, child_id]
    capsys.readouterr()
    rc = compare_verb([parent_id, child_id],
                      {"registry": runs, "expect": "IDENTICAL"})
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "lineage" in out
    # the stub document is the JAX package's for the same manifest
    assert ckpt.stub_report_doc(man) == jax_ckpt.stub_report_doc(man)
    assert ckpt.stub_report_doc({"run_id": "x"}) is None


def test_supervise_leaves_no_trail_on_the_builder(tmp_path):
    b = TwoPhaseSys(3).checker().telemetry()
    plan = FaultPlan([Fault(site="host_sync", action="kill", at=2)])
    with plan:
        res = supervise(b, autosave_dir=str(tmp_path / "auto"),
                        every_secs=0.0, max_restarts=2, **NO_SLEEP,
                        device="cpu", capacity=1 << 12, batch=32,
                        steps_per_call=2)
    assert res.restarts == 1
    assert not hasattr(b, "_supervise_restarts")
    assert b.autosave_opts is None and b.spill_mode is None
    assert getattr(b, "_span_ctx", None) is None
    later = b.spawn_gpu(device="cpu", capacity=1 << 12, batch=64).join()
    assert later.durability_status() is None


def test_snapshot_write_kill_fault_reaches_the_supervisor(tmp_path):
    plan = FaultPlan([Fault(site="snapshot_write", action="kill", at=0)])
    with plan:
        res = supervise(TwoPhaseSys(3).checker().telemetry(),
                        autosave_dir=str(tmp_path / "auto"), every_secs=0.0,
                        max_restarts=2, **NO_SLEEP, device="cpu",
                        capacity=1 << 12, batch=32, steps_per_call=2)
    assert res.restarts == 1
    assert res.attempts[0].outcome == PREEMPTION
    assert plan.fired and plan.fired[0]["site"] == "snapshot_write"
    assert (res.unique_state_count(), res.state_count()) == (
        UNIQUE_2PC3, STATES_2PC3)


def test_snapshot_write_io_fault_degrades_the_autosave_only(tmp_path):
    """An ``io`` fault at the generation write is a failed write, not a
    death: the run finishes unsupervised, and the durability block counts
    the failure."""
    plan = FaultPlan([Fault(site="snapshot_write", action="io", at=1)])
    with plan:
        c = TwoPhaseSys(3).checker().telemetry().autosave(
            str(tmp_path), every_secs=0.0).spawn_gpu(
            device="cpu", batch=32, steps_per_call=2).join()
    assert c.unique_state_count() == UNIQUE_2PC3
    assert c.durability_status()["autosave"]["failures"] == 1
    assert [r["ok"] for r in c.flight_recorder.records("checkpoint")
            ].count(False) == 1


def test_yield_event_stops_and_marks_partial_then_resumes(tmp_path):
    d = str(tmp_path / "auto")
    ev = threading.Event()
    ev.set()  # yield at the first opportunity
    kw = dict(autosave_dir=d, every_secs=0.0, device="cpu", **KILL_KW)
    part = supervise(TwoPhaseSys(4).checker().telemetry(), yield_event=ev,
                     **kw)
    assert part.yielded is True and part.restarts == 0
    assert part.attempts[-1].outcome == "yielded"
    assert ckpt.latest_gen_number(d) is not None
    assert part.unique_state_count() < UNIQUE_2PC4
    done = supervise(TwoPhaseSys(4).checker().telemetry(), **kw)
    assert done.yielded is False
    assert (done.unique_state_count(), done.state_count()) == (
        UNIQUE_2PC4, STATES_2PC4)
    assert done.checker.parent_run_id == part.checker.run_id
    plain = TwoPhaseSys(4).checker().spawn_gpu(device="cpu",
                                               **KILL_KW).join()
    for a, b in zip(done.checker._table_np(), plain._table_np()):
        np.testing.assert_array_equal(a, b)


# -- the supervise verb, killed by SIGKILL ------------------------------------------


def _verb(*args, timeout=120):
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    return subprocess.run(
        [sys.executable, "-m", "stateright_tpu_torch.models.two_phase_commit",
         "supervise", *args], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=timeout)


def test_supervise_verb_sigkilled_then_resumed_by_the_same_command(tmp_path):
    auto, runs, plan = tmp_path / "auto", tmp_path / "runs", tmp_path / "p"
    plan.write_text(json.dumps(FaultPlan(
        [Fault(site="host_sync", action="sigkill", at=4)]).to_json()))
    args = [str(3), f"--autosave={auto}", f"--runs={runs}", "--every=0",
            "--device=cpu", "--batch=32", "--steps=2"]
    dead = _verb(*args, f"--fault-plan={plan}")
    assert dead.returncode == -signal.SIGKILL, dead.stderr
    doc = ckpt.read_progress(str(auto))
    assert doc["status"] == "running" and doc["pid"]
    parent = ckpt.latest_generation(str(auto))[1]["run_id"]
    out = _verb(*args)
    assert out.returncode == 0, out.stderr
    line = out.stdout.strip().splitlines()[-1]
    assert line.startswith("supervised: done=True states=1146 unique=288 "
                           "restarts=0 run_id="), line
    assert f"parent_run_id={parent}" in line
    child = line.split("run_id=")[1].split()[0]
    assert ckpt.read_progress(str(auto))["verdict"] == "done"
    assert compare_verb([parent, child], {"registry": str(runs),
                                          "expect": "IDENTICAL"}) == 0


def test_a_refused_supervise_config_leaves_no_plan_armed(tmp_path):
    """The supervise verb arms its fault plan process-wide: a config it
    refuses before the run (a ``--steps`` that is not a number) must not
    leave the plan installed for the next run in the process."""
    from stateright_tpu_torch.models._cli import run_supervised
    from stateright_tpu_torch.testing import faults

    plan = tmp_path / "p.json"
    plan.write_text(json.dumps(FaultPlan(
        [Fault(site="host_sync", action="sigkill", at=0)]).to_json()))
    with pytest.raises(ValueError):
        run_supervised(TwoPhaseSys(3).checker(),
                       {"fault_plan": str(plan), "steps": "four",
                        "autosave": str(tmp_path / "a")},
                       stream=open(os.devnull, "w"), device="cpu")
    assert faults.active() is None


def test_no_fault_plan_or_run_thread_outlives_this_file():
    """Runs last in the file (the test workers run a file's tests in
    order, in one process, before the next file's): no plan stays armed
    and no engine run thread or prewarm worker is left running, or a later
    file's run in the same process would meet them."""
    from stateright_tpu_torch.testing import faults

    assert faults.active() is None
    left = [t for t in threading.enumerate()
            if t.name.endswith("(_run_guarded)")
            or t.name == "stateright-prewarm"]
    for t in left:
        t.join(30)
    assert not [t.name for t in left if t.is_alive()]
