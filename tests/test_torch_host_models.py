"""The port's host-only pieces against the JAX package's, tolerance 0:
``utils/`` (``VectorClock``, ``tests/test_vector_clock.py``; ``DenseNatMap``),
the quick-start examples (``tests/test_quickstart.py``) and the increment
models, which have no tensor form: the same fingerprints, counts,
discoveries and trace actions on the host checkers, and their ``check``,
``check-sym`` and ``check-auto`` verbs."""

import pytest

from stateright_tpu.fingerprint import fingerprint as jax_fingerprint
from stateright_tpu.models import quickstart as jax_quickstart
from stateright_tpu.models.increment import Increment as JaxIncrement
from stateright_tpu.models.increment_lock import IncrementLock as JaxIncLock
from stateright_tpu.utils import DenseNatMap as JaxDenseNatMap
from stateright_tpu.utils import VectorClock as JaxVectorClock
from stateright_tpu_torch.actor import Id
from stateright_tpu_torch.fingerprint import fingerprint
from stateright_tpu_torch.models import increment, increment_lock, quickstart
from stateright_tpu_torch.models.increment import Increment
from stateright_tpu_torch.models.increment_lock import IncrementLock
from stateright_tpu_torch.symmetry import RewritePlan
from stateright_tpu_torch.utils import DenseNatMap, VectorClock

# -- VectorClock (reference vector_clock.rs:110-273) --------------------------


def test_vector_clock_equates_and_hashes_ignoring_trailing_zeros():
    assert VectorClock() == VectorClock()
    assert VectorClock([0]) == VectorClock([])
    assert VectorClock([]) != VectorClock([1])
    assert hash(VectorClock([1])) == hash(VectorClock([1, 0]))
    assert fingerprint(VectorClock([1])) == fingerprint(VectorClock([1, 0]))
    assert fingerprint(VectorClock([])) != fingerprint(VectorClock([1]))
    for v in ([], [0, 0], [1], [1, 0], [3, 1, 2, 4]):
        assert fingerprint(VectorClock(v)) == jax_fingerprint(JaxVectorClock(v))


def test_vector_clock_increments_and_merges():
    assert VectorClock().incremented(2) == VectorClock([0, 0, 1])
    assert (VectorClock().incremented(2).incremented(0).incremented(2)
            == VectorClock([1, 0, 2]))
    assert VectorClock([1, 2, 3, 4]).merge_max(
        VectorClock([5, 6, 0])) == VectorClock([5, 6, 3, 4])
    assert VectorClock([1, 0, 2]).merge_max(
        VectorClock([3, 1, 0, 4])) == VectorClock([3, 1, 2, 4])


@pytest.mark.parametrize("a, b, expected", [
    ([], [], 0), ([], [0, 0], 0), ([1, 2, 0], [1, 2], 0),
    ([], [1], -1), ([1, 2, 3], [1, 3, 4], -1), ([1, 2, 3], [2, 3, 3], -1),
    ([1], [], 1), ([1, 2, 3], [1, 1, 2], 1), ([1, 2, 4], [0, 1, 3], 1),
    ([1, 2, 3], [1, 3, 2], None), ([1, 2, 3], [3, 2, 1], None),
    ([1, 2, 2], [2, 1, 2], None),
])
def test_vector_clock_orders_partially(a, b, expected):
    assert VectorClock(a).partial_cmp(VectorClock(b)) == expected
    assert JaxVectorClock(a).partial_cmp(JaxVectorClock(b)) == expected


def test_model_checker_detects_concurrency():
    c = quickstart.vector_clock_model().checker().spawn_bfs().join()
    j = jax_quickstart.vector_clock_model().checker().spawn_bfs().join()
    assert c.unique_state_count() == j.unique_state_count()
    final = c.discovery("concurrency detected").final_state()
    assert final.actor_states[2].saw_concurrent
    obs = final.actor_states[2].clock
    assert obs.get(0) == 1 and obs.get(1) == 1


# -- DenseNatMap (reference densenatmap.rs) -----------------------------------


def test_dense_nat_map_inserts_densely_and_rewrites():
    m = DenseNatMap()
    m.insert(Id(0), "a")
    m[Id(1)] = "b"
    m.insert(0, "c")
    assert m.values() == ["c", "b"] and m.get(5) is None and len(m) == 2
    with pytest.raises(IndexError, match="gap insert"):
        m.insert(3, "x")
    assert fingerprint(m) == jax_fingerprint(JaxDenseNatMap(["c", "b"]))
    swapped = DenseNatMap([Id(1), Id(0)]).rewrite(RewritePlan([1, 0]))
    assert swapped == DenseNatMap([Id(1), Id(0)])
    assert DenseNatMap(["x", "y"]).rewrite(RewritePlan([1, 0])) == DenseNatMap(
        ["y", "x"])


# -- the quick-start examples --------------------------------------------------


def test_puzzle_solved_shortest():
    path = quickstart.solve_puzzle()
    # the reference's pinned solution is 4 moves (lib.rs:96-116)
    assert path.actions() == ["down", "right", "down", "right"]
    assert path.final_state() == quickstart.GOAL
    assert path.actions() == jax_quickstart.solve_puzzle().actions()


def test_puzzle_assert_discovery():
    checker = quickstart.SlidingPuzzle().checker().spawn_bfs().join()
    checker.assert_discovery("solved", ["down", "right", "down", "right"])
    with pytest.raises(AssertionError, match="no init state admits"):
        checker.assert_discovery("solved", ["up", "up", "up"])
    with pytest.raises(AssertionError, match="does not satisfy"):
        checker.assert_discovery("solved", ["down"])


def test_clock_counterexample():
    trace = quickstart.clock_counterexample()
    assert len(trace.actions()) == 2
    assert tuple(trace.final_state().actor_states) == (2, 3)
    jtrace = jax_quickstart.clock_counterexample()
    assert [repr(a) for a in trace.actions()] == [
        repr(a) for a in jtrace.actions()]


def test_clock_dfs_agrees():
    bfs = quickstart.clock_model().checker().spawn_bfs().join()
    dfs = quickstart.clock_model().checker().spawn_dfs().join()
    assert "less than max" in bfs.discoveries()
    assert "less than max" in dfs.discoveries()


def test_fizzbuzz_model():
    c = quickstart.FizzBuzz(30).checker().spawn_bfs().join()
    assert c.unique_state_count() == 31  # prefixes of length 0..30
    c.assert_properties()


# -- the increment models ------------------------------------------------------

INCREMENT_MODELS = {
    "increment": (Increment, JaxIncrement),
    "increment_lock": (IncrementLock, JaxIncLock),
}


@pytest.mark.parametrize("strategy", ["bfs", "dfs", "dfs-sym"])
@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("name", sorted(INCREMENT_MODELS))
def test_increment_models_match_jax(name, n, strategy):
    port, jax = (cls(n) for cls in INCREMENT_MODELS[name])

    def run(m):
        b = m.checker()
        if strategy == "dfs-sym":
            return b.symmetry().spawn_dfs().join()
        return getattr(b, f"spawn_{strategy}")().join()

    t, j = run(port), run(jax)
    assert (t.unique_state_count(), t.state_count()) == (
        j.unique_state_count(), j.state_count())
    assert sorted(t.discoveries()) == sorted(j.discoveries())
    for prop, path in t.discoveries().items():
        assert path.actions() == j.discoveries()[prop].actions()
        t.assert_discovery(prop, path.actions())


def test_increment_pins():
    # the reference's docstring: 13 states at 2 threads, 8 under symmetry
    # (increment.rs:36-105); the race breaks "fin", the lock keeps it
    full = Increment(2).checker().spawn_bfs().join()
    assert full.unique_state_count() == 13
    assert "fin" in full.discoveries()
    sym = Increment(2).checker().symmetry().spawn_dfs().join()
    assert sym.unique_state_count() <= 8
    locked = IncrementLock(3).checker().spawn_bfs().join()
    locked.assert_properties()  # "fin" and "mutex" both hold


@pytest.mark.parametrize("verb", ["check", "check-sym", "check-auto"])
def test_increment_verbs(verb, capsys):
    assert increment.main([verb, "2"]) == 0
    out = capsys.readouterr().out
    assert "increment with 2 threads" in out and "Done." in out
    assert 'Discovered "fin" counterexample' in out
    assert increment_lock.main([verb, "2"]) == 0
    out = capsys.readouterr().out
    assert "Done." in out and "Discovered" not in out
    assert increment.main(["spawn"]) == 2  # a verb that waits (the UDP runtime)
    assert "usage" in capsys.readouterr().err
