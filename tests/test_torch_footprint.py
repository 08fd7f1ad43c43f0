"""The footprint pass, the independence analysis and the ample-set selection
of the port (``stateright_tpu_torch/analysis/graph.py``, ``footprint.py``,
``independence.py``, ``ops/por.py``) against the JAX package, tolerance 0:

 - footprints: for eight twins (2pc-3, 2pc-7, ``WorkersSys(7)``,
   ``ToggleSys``, per-channel paxos-1, per-channel raft-3, the hand-written
   ``PaxosTensor`` at paxos-1, dining-3) every action's reads, writes,
   guard and accumulates, every property's reads, the decomposition, the
   guard conjuncts (sets, ``(leaf, lane)`` references, leaf count) and the
   findings equal JAX's ``extract_footprints``;
 - plans: the ``IndependenceReport`` summary and rule set, and the
   ``PorPlan``'s conflict matrix, visibility, enablers, leaf references
   and fallback reason equal JAX's, on the eight twins and on every model
   of the port's fleet (``_audit_models``);
 - ``ample_mask``: equal to JAX's ``ample_mask`` on every state of the
   per-channel paxos-1 space, of ``WorkersSys(7)``'s and of 2pc-3's (the
   JAX side runs its conjunct leaves through the test-side evaluator
   below), and ``candidate_novelty`` on stale ``sel`` lanes;
 - the ``--por`` flag and the ``independence`` verbs (a model's, with
   ``--per-channel``, and the fleet's).

The JAX package's own ``conjunct_eval_fn`` fails on this jax
(``jax.core.ClosedJaxpr``), so the JAX side of every comparison that
evaluates conjuncts goes through :func:`jax_conjunct_eval_fn`: the same
leaves (``_trace``, ``_leaf_vars_of``) run by ``jax.core.eval_jaxpr``.  It
is monkeypatched over ``stateright_tpu.analysis.footprint.
conjunct_eval_fn`` where the JAX engine runs (``test_torch_por.py``);
nothing in the JAX package changes.
"""

import functools
import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import stateright_tpu.analysis.footprint as jfp
from fixtures_por import ToggleSys as JaxToggle, WorkersSys as JaxWorkers
from stateright_tpu.analysis.independence import (
    por_plan as jax_por_plan, run_independence as jax_run_independence,
)
from stateright_tpu.models import dining as jdining, paxos as jpaxos
from stateright_tpu.models import raft as jraft
from stateright_tpu.models.two_phase_commit import TwoPhaseSys as JaxSys
from stateright_tpu.ops import por as jpor
from stateright_tpu_torch import convert
from stateright_tpu_torch.analysis import footprint as tfp
from stateright_tpu_torch.analysis.graph import capture, graph_of, op_name
from stateright_tpu_torch.analysis.independence import (
    por_plan, run_independence,
)
from stateright_tpu_torch.models import dining, paxos, raft
from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
from stateright_tpu_torch.ops import por as tpor
from stateright_tpu_torch.testing.por_fixtures import ToggleSys, WorkersSys

def jax_conjunct_eval_fn(tensor):
    """The JAX conjunct kernel without ``jax.core.ClosedJaxpr``: the traced
    step's guard leaves (the JAX package's ``_trace`` and
    ``_leaf_vars_of``) as outputs of the same jaxpr, run by
    ``jax.core.eval_jaxpr``.  ``fn(rows[B, W])`` gives the leaf arrays, or
    None on a drifted trace, as the JAX function does."""
    fp = jfp.extract_footprints(tensor)
    if fp is None or fp.conjuncts is None or fp.conjuncts.n_leaves == 0:
        return None
    expect, cache = fp.conjuncts.leaf_idx, {}

    def fn(rows):
        b = int(rows.shape[0])
        built = cache.get(b)
        if built is None:
            closed = jfp._trace(tensor.step_rows, (
                jax.ShapeDtypeStruct((b, tensor.width), jnp.uint64),))
            leaves, idx = jfp._leaf_vars_of(closed, tensor.max_actions)
            if idx != expect or not leaves:
                cache[b] = False
                return None
            sub = closed.jaxpr.replace(outvars=list(leaves))

            def built(r, sub=sub, consts=closed.consts):
                return jax.core.eval_jaxpr(sub, consts, r)

            cache[b] = built
        if built is False:
            return None
        return list(built(rows))

    return fn


def per_channel(m):
    m.per_channel_()
    return m


# name: (JAX model, port model)
TWINS = {
    "2pc3": (lambda: JaxSys(3), lambda: TwoPhaseSys(3)),
    "2pc7": (lambda: JaxSys(7), lambda: TwoPhaseSys(7)),
    "workers7": (lambda: JaxWorkers(7), lambda: WorkersSys(7)),
    "toggle": (JaxToggle, ToggleSys),
    "pc-paxos1": (lambda: per_channel(jpaxos.paxos_model(1)),
                  lambda: per_channel(paxos.paxos_model(1))),
    "pc-raft3": (lambda: per_channel(jraft.raft_model(3)),
                 lambda: per_channel(raft.raft_model(3))),
    "paxos-tensor1": (lambda: jpaxos.paxos_model(1),
                      lambda: paxos.paxos_model(1)),
    "dining3": (lambda: jdining.dining_model(3),
                lambda: dining.dining_model(3)),
}


# the card's POR leg: per-channel paxos-2 (W 83, A 82)
WIDE = {"pc-paxos2": (lambda: per_channel(jpaxos.paxos_model(2)),
                      lambda: per_channel(paxos.paxos_model(2)))}


def footprint_doc(fp):
    cj = fp.conjuncts
    return dict(
        width=fp.width, n_actions=fp.n_actions, decomposed=fp.decomposed,
        actions=[a.to_json() for a in fp.actions],
        props=[p.to_json() for p in fp.prop_reads],
        findings=[(f.rule_id, f.severity) for f in fp.findings],
        conjuncts=None if cj is None else dict(
            leaf_idx=cj.leaf_idx, n_leaves=cj.n_leaves,
            sets=[[s.to_json() for s in ss] for ss in cj.sets]),
    )


@functools.lru_cache(maxsize=None)
def twins(name):
    """One model pair per twin for the whole file: the footprints, plans
    and captured graphs are cached on the twins."""
    jm, tm = (f() for f in {**TWINS, **WIDE}[name])
    return jm, tm, jm._tensor_cached(), tm._tensor_cached()


@pytest.mark.parametrize("name", list(TWINS))
def test_footprints_equal_jax(name):
    _, _, jt, tt = twins(name)
    want = footprint_doc(jfp.extract_footprints(jt))
    got = footprint_doc(tfp.extract_footprints(tt))
    assert got == want
    # cached on the twin: the kernels of a twin cannot change
    assert tfp.extract_footprints(tt) is tfp.extract_footprints(tt)


def assert_same_plan(got, want):
    np.testing.assert_array_equal(got.conflict, want.conflict)
    np.testing.assert_array_equal(got.visible, want.visible)
    assert (got.usable, got.fallback_reason) == (want.usable,
                                                 want.fallback_reason)
    assert got.leaf_idx == want.leaf_idx
    assert got.n_leaves == want.n_leaves
    if want.enablers is None:
        assert got.enablers is None
    else:
        np.testing.assert_array_equal(got.enablers, want.enablers)


@pytest.mark.parametrize("name", list(TWINS))
def test_independence_and_plan_equal_jax(name):
    jm, tm, jt, tt = twins(name)
    jr = jax_run_independence(jt, list(jm.properties()))
    tr = run_independence(tt, list(tm.properties()))
    assert tr.summary() == jr.summary()
    assert sorted((f.rule_id, f.severity, f.location) for f in tr.findings) \
        == sorted((f.rule_id, f.severity, f.location) for f in jr.findings)
    np.testing.assert_array_equal(tr.conflict, jr.conflict)
    assert (tr.conflict == tr.conflict.T).all() and tr.conflict.diagonal().all()
    assert_same_plan(por_plan(tt, list(tm.properties())),
                     jax_por_plan(jt, list(jm.properties())))


def fleet_pairs():
    from stateright_tpu_torch.models import __all__ as names

    out = []
    for name in names:
        try:
            jmod = importlib.import_module(f"stateright_tpu.models.{name}")
        except ImportError:
            continue  # a model of the port alone (orl)
        out.append(name)
    return out


@pytest.mark.parametrize("name", fleet_pairs())
def test_fleet_independence_equals_jax(name):
    """Every model of the fleet audit's configurations: the same summary,
    findings and conflict matrix as the JAX package's."""
    from stateright_tpu.parallel.tensor_model import twin_or_none as jtwin
    from stateright_tpu_torch.parallel.tensor_model import twin_or_none

    tmod = importlib.import_module(f"stateright_tpu_torch.models.{name}")
    jmod = importlib.import_module(f"stateright_tpu.models.{name}")
    for (tl, tm), (jl, jm) in zip(tmod._audit_models([]),
                                  jmod._audit_models([])):
        assert tl == jl
        tt, jt = twin_or_none(tm), jtwin(jm)
        assert (tt is None) == (jt is None)
        if tt is None:
            continue
        tr = run_independence(tt, list(tm.properties()))
        jr = jax_run_independence(jt, list(jm.properties()))
        assert tr.summary() == jr.summary(), tl
        np.testing.assert_array_equal(tr.conflict, jr.conflict)


@functools.lru_cache(maxsize=None)
def all_states(name, batch=64) -> torch.Tensor:
    """Every reachable row of the twin ``name``'s port model: the queue of
    a complete run, ``[0, tail)``."""
    c = twins(name)[1].checker().spawn_gpu(device="cpu", batch=batch).join()
    tail = int(c._final_carry[convert.TAIL])
    return c._final_carry[convert.QROWS][:tail]


def ample_pair(name, rows, valid=None):
    """The port's and JAX's ample masks on ``rows`` of the twin ``name``
    (the step's own valid mask unless ``valid`` is given); the JAX one
    jitted."""
    jm, tm, jt, tt = twins(name)
    plan = por_plan(tt, list(tm.properties()))
    jplan = jax_por_plan(jt, list(jm.properties()))
    assert plan.usable and jplan.usable
    if valid is None:
        _, valid = tt.step_rows(rows)
    got = tpor.ample_mask(valid, rows, tpor.PorConstants(plan, "cpu"),
                          tfp.conjunct_eval_fn(tt))
    kernel = jax_conjunct_eval_fn(jt)
    want = jax.jit(lambda v, r: jpor.ample_mask(v, r, jplan, kernel))(
        jnp.asarray(valid.numpy()), jnp.asarray(rows.numpy().view(np.uint64)))
    return got.numpy(), np.asarray(want), valid.numpy()


@pytest.mark.parametrize("name", ["pc-paxos1", "workers7", "2pc3",
                                  "toggle"])
def test_ample_mask_equals_jax_on_every_state(name):
    got, want, valid = ample_pair(name, all_states(name))
    np.testing.assert_array_equal(got, want)
    assert not (got & ~valid).any()  # an ample set is enabled
    if name in ("pc-paxos1", "workers7"):
        assert (got != valid).any()  # and some row reduces


def test_ample_mask_equals_jax_on_random_enabled_sets():
    """Seeded random enabled sets over per-channel paxos-1 rows: the
    closure, the first-false conjunct pull and the first-minimum
    tie-break on inputs the step never gives."""
    rows = all_states("pc-paxos1")
    rng = np.random.default_rng(0)
    valid = torch.from_numpy(rng.random((rows.shape[0], 14)) < 0.4)
    got, want, _ = ample_pair("pc-paxos1", rows, valid)
    np.testing.assert_array_equal(got, want)


def test_candidate_novelty_equals_jax_with_stale_lanes():
    """``sel`` past ``n_new`` holds in-range repeats of live lanes: they
    add 0 and never clobber a novel lane."""
    rng = np.random.default_rng(1)
    for _ in range(5):
        m, k = 96, 40
        sel = rng.integers(0, m, size=k)
        n_new = int(rng.integers(0, k))
        sel[n_new:] = sel[rng.integers(0, max(n_new, 1), size=k - n_new)]
        want = np.asarray(jpor.candidate_novelty(
            m, jnp.asarray(sel, jnp.int32), jnp.int32(n_new)))
        got = tpor.candidate_novelty(m, torch.from_numpy(sel),
                                     torch.tensor(n_new)).numpy()
        np.testing.assert_array_equal(got, want)


def test_conjunct_kernel_leaves_equal_jax_leaves():
    """The port's conjunct kernel (the captured step, the leaf nodes as
    output, dead code eliminated) gives JAX's leaf arrays at a batch size
    of its own, and runs fewer operations than the step."""
    _, _, jt, tt = twins("pc-paxos1")
    rows = all_states("pc-paxos1")[:40]
    got = tfp.conjunct_eval_fn(tt)(rows)
    want = jax.jit(jax_conjunct_eval_fn(jt))(
        jnp.asarray(rows.numpy().view(np.uint64)))
    assert len(got) == len(want) == 16
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    gm = tfp.conjunct_eval_fn(tt).build(40, "cpu")
    step = graph_of(tt, "step_rows", 40)
    assert len(gm.graph.nodes) < len(step.nodes) // 2


def test_capture_functionalizes_in_place_operations():
    """``x |= y`` (``aten::__ior__``, which ``functionalize`` refuses) and
    an indexed write into a clone are captured as pure operations."""

    def f(rows):
        acc = torch.zeros(rows.shape[:-1], dtype=torch.bool)
        acc |= rows[..., 0] > 3
        out = rows.clone()
        out[..., 0] = out[..., 0] & 7
        return out, acc

    gm = capture(f, torch.arange(8).reshape(4, 2))
    names = {op_name(n) for n in gm.graph.nodes if n.op == "call_function"}
    assert "select_scatter" in names and "bitwise_or" in names
    assert not any(n.endswith("_") for n in names)
    x = torch.tensor([[9, 1], [2, 3], [15, 0], [4, 4]])
    for a, b in zip(gm(x), f(x)):
        assert torch.equal(a, b)


def test_cli_por_flag_and_independence_verbs(capsys):
    from stateright_tpu_torch.models import _cli, two_phase_commit

    assert two_phase_commit.main(["check-gpu", "3", "--por",
                                  "--device=cpu", "--batch=64"]) == 0
    assert "unique=288" in capsys.readouterr().out
    assert paxos.main(["independence", "1"]) == 0
    assert "JX305" in capsys.readouterr().out  # the packing's escape hatch
    assert paxos.main(["independence", "1", "--per-channel"]) == 0
    out = capsys.readouterr().out
    assert "14 action(s), 35 independent pair(s), 3 visible" in out
    assert "encoding=per-channel" in out and "JX305" not in out
    assert _cli.main(["independence", "two_phase_commit", "dining"]) == 0
    out = capsys.readouterr().out
    assert "17 action(s), 102 independent pair(s), 12 visible" in out
    assert "independence fleet: CLEAN" in out
