"""The port's process-parallel BFS (``checker/mp.py``) against the JAX
package's (``tests/test_mp.py``), tolerance 0: its bulk-synchronous rounds
are deterministic for a fixed worker count, and both packages hash states
alike, so unique and state counts, discoveries and visit orders are equal
run for run, plain, bounded and under symmetry.  Every run joins its
workers under a timeout (the checker's own), so none can hang the suite."""

import subprocess
import sys
from dataclasses import dataclass
from pathlib import Path

import pytest

from fixtures import LinearEquation as JaxLinearEquation
from stateright_tpu.checker.mp import spawn_mp_bfs as jax_spawn_mp_bfs
from stateright_tpu.checker.visitor import StateRecorder as JaxStateRecorder
from stateright_tpu.models.two_phase_commit import TwoPhaseSys as JaxSys
from stateright_tpu_torch.checker.mp import spawn_mp_bfs
from stateright_tpu_torch.checker.visitor import StateRecorder
from stateright_tpu_torch.core import Model, Property
from stateright_tpu_torch.fingerprint import stable_hash
from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

REPO = Path(__file__).resolve().parent.parent


@dataclass
class LinearEquation(Model):
    """``a*x + b*y = c (mod 256)`` by nondeterministic increments
    (``tests/fixtures.py``'s model, on the port's ``Model``)."""

    a: int
    b: int
    c: int

    def init_states(self):
        return [(0, 0)]

    def actions(self, state):
        return ["IncreaseX", "IncreaseY"]

    def next_state(self, state, action):
        x, y = state
        if action == "IncreaseX":
            return ((x + 1) % 256, y)
        return (x, (y + 1) % 256)

    def properties(self):
        return [
            Property.sometimes(
                "solvable",
                lambda m, s: (m.a * s[0] + m.b * s[1]) % 256 == m.c % 256,
            )
        ]


def same_run(c, j):
    assert (c.unique_state_count(), c.state_count()) == (
        j.unique_state_count(), j.state_count())
    assert sorted(c.discoveries()) == sorted(j.discoveries())
    for name, path in c.discoveries().items():
        assert [repr(a) for a in path.actions()] == [
            repr(a) for a in j.discoveries()[name].actions()]


def test_mp_pinned_counts_and_discovery_parity():
    c = spawn_mp_bfs(TwoPhaseSys(3), workers=3)
    assert c.unique_state_count() == 288  # examples/2pc.rs:128
    ref = TwoPhaseSys(3).checker().spawn_bfs().join()
    assert sorted(c.discoveries()) == sorted(ref.discoveries())
    assert c.state_count() == ref.state_count()
    same_run(c, jax_spawn_mp_bfs(JaxSys(3), workers=3))


def test_mp_paths_are_valid_and_reach_discovery():
    m = LinearEquation(2, 10, 14)
    c = spawn_mp_bfs(m, workers=2)
    ref = m.checker().spawn_bfs().join()
    # the early exit lands at round granularity: at most one wavefront
    # past the thread checker's mid-block stop
    assert c.unique_state_count() >= ref.unique_state_count()
    for name, path in c.discoveries().items():
        assert m.property_by_name(name).condition(m, path.final_state())
    same_run(c, jax_spawn_mp_bfs(JaxLinearEquation(2, 10, 14), workers=2))


def test_mp_target_states_stops_early():
    # 0x + 0y = 1 is unsolvable, so only the target stops the run short of
    # the full 65,536-state space
    c = spawn_mp_bfs(LinearEquation(0, 0, 1), workers=2, target_states=500)
    assert 500 <= c.unique_state_count() < 65_536
    j = jax_spawn_mp_bfs(JaxLinearEquation(0, 0, 1), workers=2,
                         target_states=500)
    assert c.unique_state_count() == j.unique_state_count()


class _Exploding(Model):
    def init_states(self):
        return [0]

    def actions(self, state):
        return [1]

    def next_state(self, state, action):
        if state >= 3:
            raise RuntimeError("model bug at depth 3")
        return state + action

    def properties(self):
        return [Property.always("fine", lambda m, s: True)]


def test_mp_worker_error_propagates():
    with pytest.raises(RuntimeError, match="model bug at depth 3"):
        spawn_mp_bfs(_Exploding(), workers=2)


def test_mp_visitor_observes_every_state_in_the_jax_order():
    """Workers record their per-round visit order and the parent replays
    it: the recorder sees the whole space, in the JAX checker's order."""
    rec, jrec = StateRecorder(), JaxStateRecorder()
    c = TwoPhaseSys(3).checker().visitor(rec).spawn_mp_bfs(processes=3).join()
    JaxSys(3).checker().visitor(jrec).spawn_mp_bfs(processes=3).join()
    assert c.unique_state_count() == 288
    assert len(rec.states) == len(jrec.states) == 288
    fp, jfp = TwoPhaseSys(3).fingerprint_state, JaxSys(3).fingerprint_state
    assert [fp(s) for s in rec.states] == [jfp(s) for s in jrec.states]


def test_mp_visitor_paths_are_deterministic():
    seqs = []
    for _ in range(2):
        rec = StateRecorder()
        TwoPhaseSys(3).checker().visitor(rec).spawn_mp_bfs(processes=2).join()
        seqs.append([stable_hash(s) for s in rec.states])
    assert seqs[0] == seqs[1]
    assert len(seqs[0]) == 288


# Reduced counts depend on the visit order (2pc's representative is not
# class-invariant), and the BSP schedule is deterministic for a fixed
# worker count: the JAX package's pins per worker count.
TPC5_SYM_BY_WORKERS = {1: 508, 2: 723, 4: 665}


@pytest.mark.parametrize("n", sorted(TPC5_SYM_BY_WORKERS))
def test_mp_symmetry_matches_the_jax_pins(n):
    c = TwoPhaseSys(5).checker().symmetry().spawn_mp_bfs(processes=n)
    assert c.unique_state_count() == TPC5_SYM_BY_WORKERS[n]
    assert sorted(c.discoveries()) == ["abort agreement", "commit agreement"]
    m = c.model
    for name, path in c.discoveries().items():
        # original-state traces: they re-execute with no class matching
        assert m.property_by_name(name).condition(m, path.final_state())


def test_mp_visitor_composes_with_symmetry():
    rec = StateRecorder()
    c = TwoPhaseSys(5).checker().symmetry().visitor(rec).spawn_mp_bfs(
        processes=2).join()
    assert c.unique_state_count() == len(rec.states) == TPC5_SYM_BY_WORKERS[2]


def test_mp_module_imports_no_torch():
    """Forked workers run host model code only: the module (and the
    checker layer under it) loads without torch."""
    code = ("import sys\n"
            "from stateright_tpu_torch.checker.mp import spawn_mp_bfs\n"
            "assert 'torch' not in sys.modules, 'torch loaded'\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
