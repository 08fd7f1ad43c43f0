"""Partial-order reduction in the port's engine (``.por()``: the ample
round, the cycle proviso's second insert, the rollback, the boost) against
the JAX engine, tolerance 0.

The JAX engine runs with the test-side conjunct evaluator of
``test_torch_footprint.py`` monkeypatched over
``stateright_tpu.analysis.footprint.conjunct_eval_fn`` (the engine imports
it when it builds; the package's own fails on this jax).  Each port run
(``spawn_gpu(device="cpu")``) equals the JAX run (``spawn_tpu(sync=True)``)
at the same capacities in unique and state counts, growth events,
discoveries and their traces, table bytes, queue rows ``[0, tail)`` and
``por_status()``:

 - 2pc-3 (288 / 1,146, nothing reduced), ``WorkersSys(7)`` (15 / 15),
   ``ToggleSys`` (4 / 6, one proviso re-expansion), per-channel paxos-1
   (250 / 437: 19 rows reduced, 22 proviso, 19 candidates masked), and
   dining-3, whose ``eventually`` property makes ``.por()`` fall back;
 - ``.por().symmetry().prededup()`` on 2pc-3 (94 unique);
 - a 2pc-5 run resumed from a mid-run autosave generation (8,832), in
   both engines from the same snapshot.

Growth, the rollback and the surfaces are in ``test_torch_por_surfaces.py``.
"""


import numpy as np
import pytest

import stateright_tpu.analysis.footprint as jfp
from fixtures_por import ToggleSys as JaxToggle, WorkersSys as JaxWorkers
from stateright_tpu.models import dining as jdining, paxos as jpaxos
from stateright_tpu.models.two_phase_commit import TwoPhaseSys as JaxSys
from stateright_tpu_torch import checkpoint as ckpt
from stateright_tpu_torch.models import dining, paxos
from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
from stateright_tpu_torch.testing.por_fixtures import ToggleSys, WorkersSys
from test_torch_footprint import jax_conjunct_eval_fn, per_channel


@pytest.fixture(autouse=True)
def jax_evaluator(monkeypatch):
    monkeypatch.setattr(jfp, "conjunct_eval_fn", jax_conjunct_eval_fn)


# name: (JAX model, port model, builder flags, capacities, (unique, states))
RUNS = {
    "2pc3": (lambda: JaxSys(3), lambda: TwoPhaseSys(3), (),
             dict(capacity=1 << 12, batch=64), (288, 1_146)),
    "workers7": (lambda: JaxWorkers(7), lambda: WorkersSys(7), (),
                 dict(capacity=1 << 12, batch=64), (15, 15)),
    "toggle": (JaxToggle, ToggleSys, (), dict(capacity=1 << 12, batch=64),
               (4, 6)),
    "pc-paxos1": (lambda: per_channel(jpaxos.paxos_model(1)),
                  lambda: per_channel(paxos.paxos_model(1)), (),
                  dict(capacity=1 << 12, batch=64), (250, 437)),
    "dining3": (lambda: jdining.dining_model(3),
                lambda: dining.dining_model(3), (),
                dict(capacity=1 << 12, batch=64), (241, 514)),
    "2pc3-sym-prededup": (lambda: JaxSys(3), lambda: TwoPhaseSys(3),
                          ("symmetry", "prededup"),
                          dict(capacity=1 << 12, batch=64), (94, 368)),
}


def same_run(t, j):
    """Counts, growth events, table bytes, queue rows ``[0, tail)``, and
    the discoveries with their traces, action for action; a discovery of
    an ``always`` or ``sometimes`` property replays to a state where its
    condition holds as the property says (an ``eventually`` discovery is
    a counterexample path)."""
    from stateright_tpu_torch.core import Expectation

    assert (t.unique_state_count(), t.state_count(), t.max_depth()) == (
        j.unique_state_count(), j.state_count(), j.max_depth())
    assert t.growth_events == j.growth_events
    for a, b in zip(t._table_np(), j._table_np()):
        np.testing.assert_array_equal(a, np.asarray(b))
    js, ts = j.checkpoint(), t.final_snapshot()
    tail = int(ts["tail"])
    assert (int(ts["head"]), tail) == (int(js["head"]), int(js["tail"]))
    for k in ("q_rows", "q_fp", "q_ebits", "q_depth"):
        np.testing.assert_array_equal(np.asarray(ts[k])[:tail],
                                      np.asarray(js[k])[:tail], err_msg=k)
    jd = [int(x) for x in np.asarray(j._results["disc"])]
    assert [int(x) for x in t._results["disc"]] == jd
    tp, jp = t.discoveries(), j.discoveries()
    assert sorted(tp) == sorted(jp)
    m = t.model
    for name, path in tp.items():
        assert [repr(a) for a in path.actions()] == [
            repr(a) for a in jp[name].actions()]
        prop = m.property_by_name(name)
        if prop.expectation is not Expectation.EVENTUALLY:
            holds = prop.condition(m, path.final_state())
            assert holds == (prop.expectation is Expectation.SOMETIMES)


def por_pair(name, runs=None):
    jm, tm, flags, kw, _ = (runs or RUNS)[name]
    jb, tb = jm().checker().por(), tm().checker().por()
    for f in flags:
        jb, tb = getattr(jb, f)(), getattr(tb, f)()
    jkw = dict(kw)
    jkw["frontier_capacity"] = jkw.pop("batch")
    j = jb.spawn_tpu(sync=True, **jkw)
    t = tb.spawn_gpu(device="cpu", **kw).join()
    return j, t


@pytest.mark.parametrize("name", list(RUNS))
def test_por_engine_matches_jax_engine(name):
    j, t = por_pair(name)
    assert (t.unique_state_count(), t.state_count()) == RUNS[name][4]
    same_run(t, j)
    assert t.por_status() == j.por_status()
    st = t.por_status()
    if name == "dining3":
        assert not t._por and st["enabled"] is False
        assert "eventually" in st["fallback"]
        return
    assert st["enabled"] is True and st["fallback"] is None
    if name == "toggle":
        assert st["rows_full_proviso"] >= 1
    if name == "pc-paxos1":
        assert (st["rows_reduced"], st["rows_full_proviso"],
                st["candidates_masked"]) == (19, 22, 19)
        assert st["encoding"] == "per-channel"
    if name.startswith("2pc3"):
        assert st["rows_reduced"] == st["candidates_masked"] == 0


def test_por_resume_from_a_mid_run_generation_matches_jax(tmp_path):
    """A 2pc-5 ``.por()`` run autosaving at every sync; the middle
    generation resumed by both engines (the boost armed at the resume):
    8,832, with equal tables, queue rows and traces."""
    root = str(tmp_path / "gens")
    TwoPhaseSys(5).checker().por().autosave(
        root, every_secs=0.0, keep=1000).spawn_gpu(
            device="cpu", capacity=1 << 14, batch=64,
            steps_per_call=8).join()
    gens = ckpt.list_generations(root)
    assert len(gens) > 4
    mid = gens[len(gens) // 2]["path"]
    snap = dict(np.load(mid + "/snapshot.npz"))
    assert 0 < int(snap["unique"]) < 8_832
    t = TwoPhaseSys(5).checker().por().spawn_gpu(
        device="cpu", resume=dict(snap)).join()
    j = JaxSys(5).checker().por().spawn_tpu(sync=True, resume=dict(snap))
    assert t.unique_state_count() == j.unique_state_count() == 8_832
    same_run(t, j)
    assert t.por_status() == j.por_status()
