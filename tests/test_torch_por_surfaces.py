"""Partial-order reduction's boundaries and surfaces in the port, against
the JAX engine (with the test-side conjunct evaluator of
``test_torch_footprint.py``) and the JAX tests' contracts, tolerance 0:

 - per-channel paxos-1 with queue growth (the boost arms at every
   boundary), and with a candidate budget at which a proviso round
   overflows after its ample round committed, so the step's rollback
   writes the ample round's slots back to empty: tables, queue rows,
   traces and ``por_status()`` equal the JAX engine's, which keeps the
   pre-step table instead;
 - the cartography ``por`` block reconciled against the reduced totals
   (JAX ``tests/test_independence.py:419-437``), the memory ledger's
   analytic bytes equal to the live tensors', a JAX and a port report of
   one POR run diffing ``IDENTICAL``, ``.spill()`` rejected, the env knob
   and the builder.  (The ``--por`` flag and the ``independence`` verbs
   are in ``test_torch_footprint.py``.)
"""

import json

import pytest

import stateright_tpu.analysis.footprint as jfp
from fixtures_por import WorkersSys as JaxWorkers
from stateright_tpu.models import paxos as jpaxos
from stateright_tpu_torch.models import paxos
from stateright_tpu_torch.testing.por_fixtures import WorkersSys
from test_torch_footprint import jax_conjunct_eval_fn, per_channel
from test_torch_por import por_pair, same_run


@pytest.fixture(autouse=True)
def jax_evaluator(monkeypatch):
    monkeypatch.setattr(jfp, "conjunct_eval_fn", jax_conjunct_eval_fn)


# name: (JAX model, port model, builder flags, capacities, (unique, states))
RUNS = {
    # two queue growths: a boost at each boundary
    "pc-paxos1-grow": (lambda: per_channel(jpaxos.paxos_model(1)),
                       lambda: per_channel(paxos.paxos_model(1)), (),
                       dict(capacity=1 << 8, batch=16), (256, 452)),
    # a 24-candidate budget: one proviso round overflows after its ample
    # round committed a state
    "pc-paxos1-budget": (lambda: per_channel(jpaxos.paxos_model(1)),
                         lambda: per_channel(paxos.paxos_model(1)), (),
                         dict(capacity=1 << 12, batch=64, cand=24),
                         (250, 438)),
}


@pytest.mark.parametrize("name", list(RUNS))
def test_por_boundaries_match_jax_engine(name, monkeypatch):
    from stateright_tpu_torch.parallel import wavefront

    undone = []
    rollback = wavefront._Engine._rollback

    def counted(self, c, overflow, tgt, n_new):
        undone.append(int((overflow & (self.cand_lanes < n_new)).sum()))
        return rollback(self, c, overflow, tgt, n_new)

    monkeypatch.setattr(wavefront._Engine, "_rollback", counted)
    j, t = por_pair(name, RUNS)
    assert (t.unique_state_count(), t.state_count()) == RUNS[name][4]
    same_run(t, j)
    assert t.por_status() == j.por_status()
    assert len(t.growth_events) >= 2
    if name == "pc-paxos1-budget":
        assert sum(undone) >= 1  # the rollback wrote a slot back
    else:
        assert sum(undone) == 0


def test_por_cartography_block_reconciles():
    """The JAX test's contract (tests/test_independence.py:419-437): the
    histograms count what was generated, and the block is the status's
    tallies."""
    c = (WorkersSys(7).checker().por().telemetry(cartography=True)
         .spawn_gpu(device="cpu", capacity=1 << 13, batch=64).join())
    assert (c.unique_state_count(), c.state_count()) == (15, 15)
    cart = c.cartography()
    assert sum(cart["depth_hist"]) == c.unique_state_count()
    assert sum(cart["action_hist"]) == c.state_count() - 1
    por = cart["por"]
    assert set(por) == {"rows_reduced", "rows_full_proviso",
                        "candidates_masked"}
    assert por["rows_reduced"] > 0
    status = c.por_status()
    assert all(status[k] == v for k, v in por.items())


def test_por_memory_ledger_equals_live_buffers():
    c = (WorkersSys(7).checker().por().telemetry(memory=True)
         .spawn_gpu(device="cpu", capacity=1 << 6, batch=8).join())
    live = c.live_buffers()
    specs = c._memory_spec_fn()(c._memory_caps())
    want = {s.name: s.nbytes for s in specs}
    assert {k: int(v.nbytes) for k, v in live.items()} == want
    assert "por_boost" in want and "por_stats" in want


def test_jax_and_port_por_reports_diff_identical(tmp_path):
    from stateright_tpu_torch.telemetry.diff import (
        IDENTICAL, PERF_ONLY, diff_reports,
    )

    j, t = str(tmp_path / "j.json"), str(tmp_path / "t.json")
    JaxWorkers(7).checker().por().report(j).spawn_tpu(
        sync=True, capacity=1 << 10, frontier_capacity=64, steps_per_call=4)
    WorkersSys(7).checker().por().report(t).spawn_gpu(
        device="cpu", batch=64, capacity=1 << 10, steps_per_call=4).join()
    with open(j) as f:
        a = json.load(f)
    with open(t) as f:
        b = json.load(f)
    assert a["por"] == b["por"] and b["por"]["enabled"] is True
    assert a["config"]["flags"]["por"] is b["config"]["flags"]["por"] is True
    d = diff_reports(a, b)
    assert d["verdict"] in (IDENTICAL, PERF_ONLY), d
    assert d["violations"] == []
    assert set(d["config_delta"]) <= {"engine", "device", "git_rev"}
    md = (tmp_path / "t.md").read_text()
    assert "## Partial-order reduction" in md


def test_por_is_rejected_with_spill():
    with pytest.raises(NotImplementedError, match="partial-order"):
        WorkersSys(3).checker().por().spill().spawn_gpu(device="cpu")


def test_por_env_knob_and_builder_win(monkeypatch):
    monkeypatch.setenv("STATERIGHT_TPU_POR", "1")
    c = WorkersSys(4).checker().spawn_gpu(device="cpu", batch=16).join()
    assert c._por and c.unique_state_count() == 9
    off = WorkersSys(4).checker().por(False).spawn_gpu(device="cpu",
                                                      batch=16).join()
    assert not off._por and off.por_status() is None
    assert off.unique_state_count() == 81
