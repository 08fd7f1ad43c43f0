"""The port's host checkers (``spawn_bfs``, ``spawn_dfs``, the worker pool
and the visitors) against the JAX package's, tolerance 0: on 2pc-3,
2pc-5, paxos-1 and single-copy-2, one thread each (so both searches are
deterministic), the unique and state counts, the discovered properties
and every discovery path (its states' fingerprints and its actions) are
equal, plain and under ``symmetry()`` on the DFS (665 on 2pc-5, the
reference's pin).  Visitors see the same paths, more threads give the
same counts, and ``target_states``/``timeout`` stop the search as the JAX
checkers do."""

import pytest

from stateright_tpu.checker.visitor import PathRecorder as JaxPathRecorder
from stateright_tpu.checker.visitor import StateRecorder as JaxStateRecorder
from stateright_tpu.models.paxos import paxos_model as jax_paxos
from stateright_tpu.models.single_copy_register import (
    single_copy_model as jax_single_copy,
)
from stateright_tpu.models.two_phase_commit import TwoPhaseSys as JaxSys
from stateright_tpu_torch.checker import PathRecorder, StateRecorder
from stateright_tpu_torch.models.paxos import paxos_model
from stateright_tpu_torch.models.single_copy_register import single_copy_model
from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

MODELS = {
    "2pc-3": (lambda: TwoPhaseSys(3), lambda: JaxSys(3)),
    "2pc-5": (lambda: TwoPhaseSys(5), lambda: JaxSys(5)),
    "paxos-1": (lambda: paxos_model(1), lambda: jax_paxos(1)),
    "single-copy-2": (lambda: single_copy_model(2), lambda: jax_single_copy(2)),
}
# (unique, states) of the plain searches, the JAX pins
PLAIN = {"2pc-3": (288, 1_146), "2pc-5": (8_832, None), "paxos-1": (265, 482),
         "single-copy-2": (93, None)}


def spawn(builder, strategy):
    if strategy == "dfs-sym":
        return builder.symmetry().spawn_dfs().join()
    return getattr(builder, f"spawn_{strategy}")().join()


def path_key(model, path):
    """A path as its states' fingerprints and its actions' text: equal
    across the packages, whose state and action classes differ."""
    return ([model.fingerprint_state(s) for s in path.states()],
            [repr(a) for a in path.actions()])


@pytest.mark.parametrize("strategy", ["bfs", "dfs", "dfs-sym"])
@pytest.mark.parametrize("name", list(MODELS))
def test_host_checker_matches_jax(name, strategy):
    build, jbuild = MODELS[name]
    m, jm = build(), jbuild()
    t = spawn(m.checker(), strategy)
    j = spawn(jm.checker(), strategy)
    assert (t.unique_state_count(), t.state_count()) == (
        j.unique_state_count(), j.state_count())
    if strategy != "dfs-sym":
        unique, states = PLAIN[name]
        assert t.unique_state_count() == unique
        assert states is None or t.state_count() == states
    else:  # symmetry never adds classes
        assert t.unique_state_count() <= PLAIN[name][0]
    tp, jp = t.discoveries(), j.discoveries()
    assert sorted(tp) == sorted(jp) and tp
    for prop, path in tp.items():
        assert path_key(m, path) == path_key(jm, jp[prop])


def test_dfs_symmetry_gives_the_reference_pin_on_2pc5():
    c = TwoPhaseSys(5).checker().symmetry().spawn_dfs().join()
    assert (c.unique_state_count(), c.state_count()) == (665, 4_091)
    assert set(c.discoveries()) == {"abort agreement", "commit agreement"}
    c.assert_properties()


@pytest.mark.parametrize("strategy", ["bfs", "dfs"])
def test_visitors_see_the_jax_paths(strategy):
    m, jm = TwoPhaseSys(3), JaxSys(3)
    rec, jrec = PathRecorder(), JaxPathRecorder()
    srec, jsrec = StateRecorder(), JaxStateRecorder()
    spawn(m.checker().visitor(rec), strategy)
    spawn(jm.checker().visitor(jrec), strategy)
    assert len(rec.paths) == 288
    assert {tuple(path_key(m, p)[0]) for p in rec.paths} == {
        tuple(path_key(jm, p)[0]) for p in jrec.paths}
    spawn(m.checker().visitor(srec), strategy)
    spawn(jm.checker().visitor(jsrec), strategy)
    assert [m.fingerprint_state(s) for s in srec.states] == [
        jm.fingerprint_state(s) for s in jsrec.states]
    # a plain callable is wrapped
    seen = []
    spawn(m.checker().visitor(lambda _m, p: seen.append(len(p))), strategy)
    assert len(seen) == 288


@pytest.mark.parametrize("strategy", ["bfs", "dfs"])
def test_threads_give_the_same_counts(strategy):
    c = spawn(TwoPhaseSys(4).checker().threads(4), strategy)
    one = spawn(TwoPhaseSys(4).checker(), strategy)
    assert (c.unique_state_count(), c.state_count()) == (
        one.unique_state_count(), one.state_count())


@pytest.mark.parametrize("strategy", ["bfs", "dfs"])
def test_target_states_stops_like_jax(strategy):
    t = spawn(TwoPhaseSys(5).checker().target_states(2_000), strategy)
    j = spawn(JaxSys(5).checker().target_states(2_000), strategy)
    assert 2_000 <= t.unique_state_count() < 8_832
    assert (t.unique_state_count(), t.state_count()) == (
        j.unique_state_count(), j.state_count())


def test_timeout_cuts_the_search_short():
    c = TwoPhaseSys(7).checker().timeout(0.0).spawn_bfs().join()
    assert c.timed_out
    assert c.unique_state_count() < 296_448
    done = TwoPhaseSys(3).checker().spawn_bfs().join()
    assert not done.timed_out and done.is_done()


def test_report_prints_the_done_line(capsys):
    TwoPhaseSys(3).checker().spawn_bfs().report()
    out = capsys.readouterr().out
    assert "Done. states=1146, unique=288" in out
    assert 'Discovered "commit agreement" example' in out
