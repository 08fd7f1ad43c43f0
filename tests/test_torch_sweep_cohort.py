"""The cohort unifier on captured aten graphs, the sweep's kernel counts and
its diff rule (``stateright_tpu_torch/sweep/cohort.py``; the port has no
jaxpr, so these cases hold the port's own graph unifier, with tolerance 0,
against each member's own kernels):

 - a ``get_attr`` constant that differs across members is lifted and
   gathered by tag, one that agrees stays shared;
 - a lifted scalar moves to its ``.Tensor`` overload and keeps the
   ``.Scalar`` overload's dtype; kernels of another structure do not
   unify, and the group splits loudly into singletons;
 - ``kernel_cost`` of the two kernel modes, and unchanged without them;
 - a port sweep instance's report against the port's plain run of the
   same instance;
 - paxos's seed family (two cohorts: the hand-written twin lossless, a
   compiled twin per lossy member) against the JAX ``SweepChecker``'s
   tables, and the lifted cohort (bounded counters, whose bound is a
   lifted scalar) against each member's JAX sequential ``spawn_tpu`` run:
   on this jax the JAX unifier crashes on a lifted constant (``Var("",
   aval)``, ``stateright_tpu/sweep/cohort.py:164``), so the sequential
   run is the reference, with ``_assert_instance_parity``'s rules.
"""

import json

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (both frameworks in one process, JAX on the CPU)

from stateright_tpu.models.paxos import sweep_family as jax_paxos_family
from stateright_tpu_torch.analysis.costmodel import kernel_cost
from stateright_tpu_torch.analysis.graph import graph_of
from stateright_tpu_torch.core import Expectation, Model, Property
from stateright_tpu_torch.models.paxos import sweep_family as paxos_family
from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
from stateright_tpu_torch.parallel.tensor_model import (
    BitPacker, TensorBackedModel, TensorModel,
)
from stateright_tpu_torch.sweep import SweepInstance, SweepSpec
from stateright_tpu_torch.sweep.cohort import build_cohorts, unify_graphs
from stateright_tpu_torch.testing.sweep_fixtures import (
    BoundedCounterSys, bounded_counter_spec,
)
from test_torch_sweep import _seed_sweep_parity, port_sweep

PAXOS1 = (265, 482, 13)
PAXOS1_LOSSY = (2378, 8197, 14)


class StepTensor(TensorModel):
    """One counter stepping by ``step`` up to 60: the step sizes sit in a
    tensor the kernel builds (a ``get_attr`` constant of the capture),
    ``kind`` picks another kernel structure."""

    def __init__(self, m):
        self.model, self.step, self.kind = m, m.step, m.kind
        self.pk = BitPacker([("c", 6)])
        self.width, self.max_actions = self.pk.width, 2

    def init_rows(self):
        return np.zeros((1, 1), np.uint64)

    def encode_state(self, s):
        return self.pk.pack(c=s)

    def decode_state(self, row):
        return self.pk.unpack(row)["c"]

    def step_rows(self, rows):
        c = self.pk.get(rows, "c")
        steps = torch.tensor([self.step, 2 * self.step], device=rows.device)
        nxt = c[:, None] + steps  # [B, 2]
        if self.kind:
            nxt = nxt.clamp(max=60)
        ok = nxt <= 60
        succ = torch.stack([self.pk.set(rows, "c", torch.where(
            ok[:, a], nxt[:, a], c)) for a in range(2)], -2)
        return succ, ok

    def property_masks(self, rows):
        return (self.pk.get(rows, "c") >= 60)[:, None]


class StepSys(TensorBackedModel, Model):
    def __init__(self, step: int, kind: int = 0):
        self.step, self.kind = step, kind

    def properties(self):
        return [Property(Expectation.SOMETIMES, "at 60",
                         lambda m, s: s >= 60)]

    def init_states(self):
        return [0]

    def actions(self, s):
        return [a for a in (self.step, 2 * self.step) if s + a <= 60]

    def next_state(self, s, a):
        return s + a

    def tensor_model(self):
        return StepTensor(self)


def graphs(models, kernel="step_rows"):
    return [graph_of(m._tensor_cached(), kernel, 1, "cpu") for m in models]


def test_differing_get_attr_constant_is_lifted_and_gathered_by_tag():
    models = [StepSys(3), StepSys(4), StepSys(5)]
    gm, stacked = unify_graphs(graphs(models))
    assert len(stacked) == 1 and stacked[0].shape == (3, 2)
    assert [n.op for n in gm.graph.nodes].count("get_attr") == 0
    spec = SweepSpec([SweepInstance(f"s{m.step}", m) for m in models])
    (c,) = build_cohorts(spec)
    assert c.K == 3 and c.lifted == 1
    rows = torch.tensor([[0], [7], [20], [59]], dtype=torch.int64)
    for tag, m in enumerate(models):
        tags = torch.full((4,), tag, dtype=torch.int32)
        s, v = c.step_rows(rows, tags)
        s0, v0 = m._tensor_cached().step_rows(rows)
        assert torch.equal(v, v0) and torch.equal(s[v0], s0[v0])
    res = []
    for m in models:
        res.append(m.checker().spawn_gpu(device="cpu", batch=8).join()
                   .unique_state_count())
    sw = models[0].checker().sweep(spec).spawn_gpu(device="cpu",
                                                   batch=8).join()
    assert [sw.results[f"s{m.step}"].unique for m in models] == res


def test_equal_constants_stay_shared():
    gm, stacked = unify_graphs(graphs([StepSys(3), StepSys(3)]))
    assert stacked == []
    assert [n.op for n in gm.graph.nodes].count("get_attr") == 1


def test_lifted_scalar_takes_the_tensor_overload_and_its_dtype():
    ms = [BoundedCounterSys(2), BoundedCounterSys(5)]
    gm, stacked = unify_graphs(graphs(ms))
    assert [s.dtype for s in stacked] == [torch.int64, torch.int64]
    assert [s.tolist() for s in stacked] == [[2, 5], [2, 5]]
    targets = [str(n.target) for n in gm.graph.nodes
               if n.op == "call_function"]
    assert "aten.lt.Tensor" in targets and "aten.lt.Scalar" not in targets
    gm_p, stacked_p = unify_graphs(graphs(ms, "property_masks"))
    assert len(stacked_p) == 1
    assert "aten.ge.Tensor" in [str(n.target) for n in gm_p.graph.nodes]


def test_other_structures_do_not_unify_and_split_loudly(capsys):
    assert unify_graphs(graphs([StepSys(3), StepSys(3, kind=1)])) is None
    spec = SweepSpec([SweepInstance("a", StepSys(3)),
                      SweepInstance("b", StepSys(4, kind=1))])
    cohorts = build_cohorts(spec)
    assert [c.K for c in cohorts] == [1, 1]
    assert not any(c.unified for c in cohorts)
    assert [c.global_index for c in cohorts] == [[0], [1]]
    assert "do not share one program" in capsys.readouterr().err


def test_cohorts_split_by_shape_signature():
    spec = SweepSpec([SweepInstance("c2", BoundedCounterSys(2, 2)),
                      SweepInstance("c3", BoundedCounterSys(2, 3)),
                      SweepInstance("c2b", BoundedCounterSys(3, 2))])
    cohorts = build_cohorts(spec)
    assert [(c.K, c.global_index) for c in cohorts] == [(2, [0, 2]),
                                                        (1, [1])]


@pytest.mark.parametrize("name,plain,extra,moved", [
    ("cand_prep", {"lanes": 75776, "width": 1, "valid": 20000,
                   "budget": 32768, "parents": 2048}, {"ns": 8},
     (2048 * 4 + 8 * 16, 20000 * 25)),
    ("insert_commit", {"novel": 9000, "width": 1, "parents": 2048},
     {"tags": True}, (2048 * 4 + 9000 * 4, 0)),
])
def test_kernel_cost_of_the_sweep_modes(name, plain, extra, moved):
    """The modes add their tag and table bytes and the namespace's
    operations; without them the counts are the plain engine's."""
    b0, o0 = kernel_cost(name, plain)
    assert kernel_cost(name, dict(plain, ns=0, tags=False)) == (b0, o0)
    b1, o1 = kernel_cost(name, dict(plain, **extra))
    assert (b1 - b0, o1 - o0) == moved


def test_sweep_instance_report_diffs_against_the_plain_run():
    """The port's sweep instance (engine ``gpu-sweep``) against the port's
    plain run of 2pc-3 with cartography: no violation, the depth
    histograms not gated across the sweep pair."""
    from stateright_tpu_torch.models.two_phase_commit import sweep_family
    from stateright_tpu_torch.telemetry.diff import (
        IDENTICAL, PERF_ONLY, diff_reports,
    )
    from stateright_tpu_torch.telemetry.report import build_report

    spec = sweep_family(2)
    s = (TwoPhaseSys(3).checker().telemetry(cartography=True).sweep(spec)
         .spawn_gpu(device="cpu", capacity=1 << 12, batch=64).join())
    p = (TwoPhaseSys(3).checker().telemetry(cartography=True)
         .spawn_gpu(device="cpu", capacity=1 << 12, batch=64).join())
    a = json.loads(json.dumps(build_report(s.instance_view("2pc3-seed0"))))
    b = json.loads(json.dumps(build_report(p)))
    assert a["engine"] == "gpu-sweep" and a["config"]["flags"]["sweep"]
    d = diff_reports(a, b)
    assert d["violations"] == [] and d["verdict"] in (IDENTICAL, PERF_ONLY), d


# -- paxos's two cohorts against the JAX sweep engine ------------------------


def test_seed_sweep_paxos_equals_jax_sweep_engine():
    """Two cohorts (the hand-written twin lossless, a compiled twin per
    lossy member), every member at its pins."""
    pins = {f"paxos1-{'lossy-' if i % 2 else ''}i{i}":
            PAXOS1_LOSSY if i % 2 else PAXOS1 for i in range(4)}
    p = _seed_sweep_parity(paxos_family(4), jax_paxos_family(4), pins,
                           capacity=1 << 14, batch=256)
    assert len(p.cohorts) == 2 and p.growth_events


# -- the lifted cohort against JAX's sequential engine ------------------------


def _assert_instance_parity(sweep, key, oracle, cartography=False):
    """JAX test_sweep.py:62's rules: counts, discovery names and traces
    (states and actions), and with cartography the generated-state
    counters, with the depth histogram reconciled by its sum."""
    r = sweep.results[key]
    assert (r.unique, r.states, r.max_depth) == (
        oracle.unique_state_count(), oracle.state_count(),
        oracle.max_depth())
    sd, od = sweep.instance_discoveries(key), oracle.discoveries()
    assert sorted(sd) == sorted(od)
    for name in od:
        assert sd[name].states() == od[name].states()
        assert sd[name].actions() == od[name].actions()
    if cartography:
        oc, rc = oracle.cartography(), r.cartography
        assert rc["action_hist"] == oc["action_hist"]
        assert rc["props"] == oc["props"]
        assert rc["fresh_inserts"] == oc["fresh_inserts"]
        assert rc["duplicate_hits"] == oc["duplicate_hits"]
        assert sum(rc["depth_hist"]) == r.unique


def _lifted_parity(bounds):
    from fixtures_sweep import BoundedCounterSys as JaxCounter

    spec = bounded_counter_spec(bounds)
    c = port_sweep(spec, telemetry=True, cartography=True, batch=32)
    assert len(c.cohorts) == 1 and c.cohorts[0].K == len(bounds)
    assert c.cohorts[0].unified and c.cohorts[0].lifted > 0
    assert c.engine_compiles == 1
    for b in bounds:
        r = c.results[f"bc-b{b}"]
        assert (r.unique, r.max_depth) == ((b + 1) ** 2, 2 * b)
        o = (JaxCounter(b).checker().telemetry(cartography=True)
             .spawn_tpu(sync=True, capacity=1 << 12, batch=32))
        _assert_instance_parity(c, f"bc-b{b}", o, cartography=True)
    events = [r["event"] for r in c.flight_recorder.records("sweep")]
    assert events.count("cohort_compile") == 1
    assert events.count("instance_done") == len(bounds)
    assert events[-1] == "summary"
    return c


def test_lifted_cohort_members_equal_jax_sequential_runs():
    _lifted_parity([1, 2, 3, 4])


@pytest.mark.slow
def test_lifted_cohort_eight_bounds_equal_jax_sequential_runs():
    _lifted_parity([1, 2, 3, 4, 5, 6, 7, 8])
