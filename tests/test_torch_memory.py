"""The port's memory ledger (``stateright_tpu_torch/telemetry/memory.py``):

 - the analytic bytes of the GPU engine's device buffers equal the live
   tensors' ``nbytes`` exactly, at every rung of a growing run (with and
   without cartography, under symmetry too), and the buffers the port
   shares with the JAX ledger's ``wavefront_specs`` have equal bytes;
 - the ledger's snapshot, ring records and report block; the budget's env
   override, the preflight and resume guards, the capacity plan and the
   growth-OOM health condition;
 - ``device_memory_stats`` is None on the CPU;
 - the ledger adds no operation to a step.
"""

import numpy as np
import pytest

from stateright_tpu.models.two_phase_commit import TwoPhaseSys as JaxSys
from stateright_tpu.telemetry.memory import wavefront_specs as jax_specs
from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
from stateright_tpu_torch.telemetry import memory as mem

KW = dict(device="cpu", batch=32, queue_capacity=64, capacity=1 << 10,
          steps_per_call=4)


def live_bytes(checker, carry, eng):
    """name -> nbytes of a carry and an engine, under the ledger's names."""
    from stateright_tpu_torch.parallel.wavefront import BASE

    out = {n: t.nbytes for n, t in zip(mem._CARRY_NAMES, carry[:BASE])}
    out.update({n: t.nbytes for n, t in zip(mem._CART_NAMES, carry[BASE:])})
    out["lanes"] = eng.lanes.nbytes
    return out


@pytest.mark.parametrize("flags", ["plain", "cartography", "symmetry"])
def test_analytic_bytes_equal_live_bytes_at_every_rung(flags, monkeypatch):
    """At each growth (the carry as the rung left it) and at the end, the
    ledger's per-buffer bytes equal the live tensors'."""
    from stateright_tpu_torch.parallel import wavefront

    seen = []
    regrow = wavefront.GpuChecker._regrow
    run = wavefront._Engine.run

    def spy_run(self, carry):
        seen.append(("block", self, carry, (self.cap, self.qcap,
                                            self.batch, self.eff_cand)))
        return run(self, carry)

    def spy_regrow(self, carry, cap, qcap, batch, status, cand, at=None,
                   **kw):
        seen.append(("growth", None, carry, (cap, qcap, batch, cand)))
        return regrow(self, carry, cap, qcap, batch, status, cand, at=at,
                      **kw)

    monkeypatch.setattr(wavefront._Engine, "run", spy_run)
    monkeypatch.setattr(wavefront.GpuChecker, "_regrow", spy_regrow)
    b = TwoPhaseSys(5).checker()
    if flags == "cartography":
        b = b.cartography()
    if flags == "symmetry":
        b = b.symmetry()
    c = b.spawn_gpu(**KW).join()
    spec_fn = c._memory_spec_fn()
    rungs = set()
    eng = None
    for kind, e, carry, (cap, qcap, batch, cand) in seen:
        eng = e or eng
        specs = {s.name: s.nbytes for s in spec_fn(
            {"cap": cap, "qcap": qcap, "batch": batch, "cand": cand})}
        assert live_bytes(c, carry, eng) == specs, (kind, cap, qcap)
        rungs.add((cap, qcap))
    assert len(rungs) >= 3, rungs  # the run grew its queue and its table
    final = {n: t.nbytes for n, t in c.live_buffers().items()}
    assert final == {s.name: s.nbytes for s in spec_fn(c._memory_caps())}


def test_buffers_shared_with_the_jax_ledger_have_equal_bytes():
    """The table, queue, discovery and count buffers, and the cartography
    counters, have the JAX ledger's bytes at the same capacities; the
    port's 0-d cursors are int64 where the JAX carry's are int32."""
    tm = TwoPhaseSys(5).tensor_model()
    jtm = JaxSys(5).tensor_model()
    for cap, qcap, batch in ((1 << 10, 512, 32), (1 << 14, 1 << 13, 256)):
        ours = {s.name: s.nbytes for s in mem.wavefront_specs(
            tm.width, tm.max_actions, 3, cap, qcap, batch, 0,
            cartography=True, cuda=True)}
        theirs = {s.name: s.nbytes for s in jax_specs(
            jtm, 3, cap, qcap, batch, cartography=True)}
        shared = set(ours) & set(theirs)
        assert shared >= {"table_fp", "q_rows", "cart_action_hist"}
        int32_scalars = {"head", "tail", "maxdepth", "status"}
        for name in shared - int32_scalars:
            assert ours[name] == theirs[name], name
        for name in int32_scalars:
            assert ours[name] == 2 * theirs[name] == 8


def test_cuda_specs_add_the_kernels_scratch():
    """On ``cuda`` the ledger adds each engine's ``PrepBuffers`` and
    ``PlanBuffers`` (the generation-order staging area under symmetry),
    sized exactly as the classes allocate them."""
    from stateright_tpu_torch.ops.buckets import PlanBuffers
    from stateright_tpu_torch.ops.cand_prep import PrepBuffers

    tm = TwoPhaseSys(3).tensor_model()
    m = 64 * tm.max_actions
    for sym in (False, True):
        specs = {s.name: s.nbytes for s in mem.wavefront_specs(
            tm.width, tm.max_actions, 3, 1 << 12, 256, 64, 100, sym=sym)}
        cpu = {s.name for s in mem.wavefront_specs(
            tm.width, tm.max_actions, 3, 1 << 12, 256, 64, 100, cuda=False)}
        prep, plan = PrepBuffers(m, 100, "cpu"), PlanBuffers(100, "cpu", sym)
        for pre, buf, names in (
            ("prep", prep, ("fp", "payload", "cidx", "key", "n_valid",
                            "cand_overflow", "scratch")),
            ("plan", plan, ("tgt", "cfp", "cpl", "sel", "n_new", "overflow",
                            "scratch") + (("stage",) if sym else ())),
        ):
            for n in names:
                assert specs.pop(f"{pre}_{n}") == getattr(buf, n).nbytes, n
        assert set(specs) == cpu


def test_ledger_snapshot_records_and_report_block(tmp_path):
    c = (TwoPhaseSys(5).checker().memory_ledger()
         .spawn_gpu(**KW).join())
    snap = c.memory()
    assert snap["engine"] == "gpu-wavefront"
    assert snap["total_bytes"] == sum(snap["buffers"].values())
    nxt = snap["next_rung"]
    assert nxt["capacity"] == 2 * snap["capacity"]
    assert nxt["transient_bytes"] == snap["total_bytes"] + nxt["total_bytes"]
    assert nxt["transient_alloc_bytes"] > nxt["transient_bytes"]
    # the allocator's bound: 512-byte blocks, and 1 MiB more for a large one
    specs = [mem.BufferSpec("a", (1,), np.int64),
             mem.BufferSpec("b", (1 << 17,), np.int64),
             mem.BufferSpec("c", ((1 << 17) + 1,), np.int64)]
    assert mem.alloc_bytes(specs) == 512 + (1 << 20) + (
        (1 << 20) + 512 + (1 << 20))
    block = c.memory(live=False)
    assert "budget_bytes" not in block and "device" not in block
    recs = c.flight_recorder.records("memory")
    assert recs[0]["at"] == "init" and recs[-1]["at"] == "final"
    assert any(r["at"] == "growth" for r in recs)
    assert mem.device_memory_stats() is None  # no CUDA device here
    assert c.growth_memory == []  # measured on cuda only
    path = str(tmp_path / "r.json")
    r = TwoPhaseSys(3).checker().report(path).spawn_gpu(**KW).join()
    import json

    with open(path) as f:
        doc = json.load(f)
    assert doc["memory"] == r.memory(live=False)
    assert "Memory (analytic)" in open(str(tmp_path / "r.md")).read()


def test_budget_guards_plan_and_oom_risk(monkeypatch, capsys):
    monkeypatch.setenv(mem.ENV_DEVICE_BYTES, "1000")
    assert mem.device_budget() == (1000, "env")
    # the preflight guard warns once per model, errors on request
    m = TwoPhaseSys(3)
    m.checker().spawn_gpu(**KW).join()
    assert "capacity guard" in capsys.readouterr().err
    monkeypatch.setenv(mem.ENV_CAPACITY_GUARD, "error")
    with pytest.raises(mem.CapacityError):
        TwoPhaseSys(3).checker().spawn_gpu(**KW)
    snap = {"q_rows": np.zeros(400, np.uint64)}
    with pytest.raises(mem.CapacityError):
        mem.snapshot_fits_guard(snap, "resume")
    monkeypatch.setenv(mem.ENV_CAPACITY_GUARD, "off")
    mem.snapshot_fits_guard(snap, "resume")
    # the plan stops at the first rung whose transient does not fit
    tm = TwoPhaseSys(3).tensor_model()

    def spec_fn(caps):
        return mem.wavefront_specs(tm.width, tm.max_actions, 3, caps["cap"],
                                   256, 32, 100, cuda=False)

    total = mem.total_bytes(spec_fn({"cap": 1 << 10}))
    plan = mem.capacity_plan(spec_fn, {"cap": 1 << 10}, budget=3 * total)
    assert [r.get("fits") for r in plan["rungs"]] == [True, True, False]
    assert plan["max_unique"] == (1 << 11) // 4
    assert mem.fmt_bytes(None) == "-" and mem.fmt_bytes(1536) == "1.5KB"
    # a budget below the next rung's transient raises growth_oom_risk
    monkeypatch.setenv(mem.ENV_CAPACITY_GUARD, "off")
    monkeypatch.setenv(mem.ENV_DEVICE_BYTES, str(total + 1))
    c = (TwoPhaseSys(5).checker().memory_ledger()
         .spawn_gpu(device="cpu", capacity=1 << 16, batch=64).join())
    assert any(r.get("event") == "growth_oom_risk"
               for r in c.flight_recorder.records("health")), \
        c.flight_recorder.records("health")


def test_ledger_adds_no_operation_to_a_step(monkeypatch):
    from torch.utils._python_dispatch import TorchDispatchMode

    from stateright_tpu_torch.parallel import wavefront

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    counts = []
    step = wavefront._Engine.step

    def counted(self, c):
        Count.n = 0
        with Count():
            out = step(self, c)
        counts.append(Count.n)
        return out

    monkeypatch.setattr(wavefront._Engine, "step", counted)
    TwoPhaseSys(3).checker().spawn_gpu(device="cpu", batch=64).join()
    off = set(counts)
    counts.clear()
    TwoPhaseSys(3).checker().telemetry(memory=True, occupancy_every=1) \
        .spawn_gpu(device="cpu", batch=64).join()
    assert set(counts) == off
