"""The actor compiler's general fragment in the port — raft (timers,
factored pair properties, a factored ``within_boundary``) and dining
philosophers (an ``eventually`` property: the deadlock) — against the JAX
package, tolerance 0:

 - both compilers' tables and ``init_rows()``;
 - ``step_rows``/``property_masks`` on crawled levels (raft-3 4 levels,
   dining-3 every state), against the JAX twin and the object model;
 - the engine (``spawn_gpu(device="cpu")``) against
   ``spawn_tpu(sync=True)`` at the same capacities: counts, discoveries,
   traces, table bytes and queue rows (raft-3 5,725 / 15,607; dining-3 359
   with an always-true property, and the deadlock trace, which pins the
   ebits flush at terminal rows);
 - a too-tight compile bound fails the run as the JAX engine's does.
"""

import pytest
import torch

from stateright_tpu.actor import Network as JaxNetwork
from stateright_tpu.actor.device_props import forall_actors as jax_forall
from stateright_tpu.core import Expectation as JaxExpectation
from stateright_tpu.models.dining import dining_model as jax_dining
from stateright_tpu.models.raft import raft_model as jax_raft
from stateright_tpu.parallel.actor_compiler import (
    compile_actor_model as jax_compile,
)
from stateright_tpu_torch.actor import Network
from stateright_tpu_torch.actor.device_props import forall_actors
from stateright_tpu_torch.core import Expectation
from stateright_tpu_torch.models import dining as port_dining
from stateright_tpu_torch.models import raft as port_raft
from stateright_tpu_torch.models.dining import HAS_LEFT, dining_model
from stateright_tpu_torch.models.raft import LEADER, raft_model
from stateright_tpu_torch.parallel.actor_compiler import compile_actor_model
from test_torch_actor_compiler import assert_same_compile, engine_pair
from test_torch_paxos import as_rows, bfs_levels, check_twin_against_jax

RAFT3_UNIQUE, RAFT3_STATES = 5_725, 15_607
DINING3_FULL = 359


def no_early_exit(m, expectation, forall):
    """An always-true ALWAYS property is never discovered, so the
    all-properties-discovered early exit cannot fire."""
    m.property(expectation.ALWAYS, "no early exit",
               forall(lambda i, s: True))
    return m


@pytest.mark.parametrize("name", ["raft-3", "raft-2-ordered", "dining-3"])
def test_init_rows_and_code_tables_equal_jax(name):
    if name == "dining-3":
        m, jm = dining_model(3), jax_dining(3)
    elif name == "raft-3":
        m, jm = raft_model(3), jax_raft(3)
    else:
        m = raft_model(2, network=Network.new_ordered())
        jm = jax_raft(2, network=JaxNetwork.new_ordered())
    tm, jtm = m.tensor_model(), jm.tensor_model()
    assert_same_compile(tm, jtm)
    if name == "raft-3":
        assert tm._has_timers and (tm.width, tm.max_actions) == (17, 19)
    if name == "dining-3":
        assert not tm._has_timers and (tm.width, tm.max_actions) == (25, 24)


def test_raft3_step_rows_and_masks_match_jax_on_4_levels():
    """Timeout actions, timer bits set and cleared, and the pair property
    tables on the first 4 BFS levels."""
    m, jm = raft_model(3), jax_raft(3)
    states = [s for lvl in bfs_levels(m, 4) for s in lvl]
    valid, _ = check_twin_against_jax(
        m, jm, states, as_rows(m._tensor_cached(), states), True)
    tm = m._tensor_cached()
    timeouts = valid[:, tm.max_actions - tm.n_actors:]
    assert timeouts.any() and not timeouts.all()


def test_dining3_step_rows_and_masks_match_jax_on_every_state():
    m, jm = dining_model(3), jax_dining(3)
    states = [s for lvl in bfs_levels(m) for s in lvl]
    assert len(states) == DINING3_FULL
    valid, masks = check_twin_against_jax(
        m, jm, states, as_rows(m._tensor_cached(), states), True)
    terminal = ~valid.any(axis=1)
    assert terminal.any() and (terminal & ~masks[:, 0]).any()  # deadlocks


def test_raft3_engine_matches_jax_engine():
    """The complete raft-3 space, grown from a small table, and the
    leader-election path replayed."""
    t = engine_pair(raft_model(3), jax_raft(3), 1 << 12, 1 << 8)
    assert (t.unique_state_count(), t.state_count()) == (
        RAFT3_UNIQUE, RAFT3_STATES)
    assert t.growth_events
    assert sorted(t.discoveries()) == ["a leader is elected"]
    path = t.discovery("a leader is elected")
    last = path.actions()[-1]
    assert path.final_state().actor_states[int(last.dst)].role == LEADER


@pytest.mark.parametrize("net", ["ordered", "unordered_duplicating"])
def test_raft2_engine_matches_jax_across_network_semantics(net):
    """Timers compose with the ordered and the duplicating network."""
    t = engine_pair(raft_model(2, network=Network.from_name(net)),
                    jax_raft(2, network=JaxNetwork.from_name(net)),
                    1 << 12, 1 << 7)
    assert t.unique_state_count() > 0


def test_raft_lossy_engine_matches_jax_engine():
    m, jm = raft_model(2), jax_raft(2)
    m.lossy_network(True)
    jm.lossy_network(True)
    t = engine_pair(m, jm, 1 << 12, 1 << 7)
    assert m.tensor_model().max_actions == 2 * 16 + 2


def test_factored_within_boundary_matches_jax_engine():
    """Out-of-boundary successors are masked after ``step_rows`` (neither
    counted nor enqueued), as the JAX engine and the host checkers do."""
    m, jm = raft_model(3), jax_raft(3)
    m.within_boundary_(forall_actors(lambda i, s: s.term <= 1))
    jm.within_boundary_(jax_forall(lambda i, s: s.term <= 1))
    assert m._tensor_cached().has_boundary
    t = engine_pair(m, jm, 1 << 13, 1 << 8)
    assert 0 < t.unique_state_count() < RAFT3_UNIQUE


def test_dining3_full_space_matches_jax_engine():
    m = no_early_exit(dining_model(3), Expectation, forall_actors)
    jm = no_early_exit(jax_dining(3), JaxExpectation, jax_forall)
    t = engine_pair(m, jm, 1 << 12, 1 << 6)
    assert t.unique_state_count() == DINING3_FULL
    assert sorted(t.discoveries()) == ["everyone eats", "someone eats"]


def test_dining3_deadlock_trace_matches_jax_engine():
    """The ``eventually`` counterexample (flushed at a terminal row) ends
    in the circular wait: every philosopher holds their left fork."""
    t = engine_pair(dining_model(3), jax_dining(3), 1 << 12, 1 << 6)
    final = t.discovery("everyone eats").final_state()
    assert all(p.phase == HAS_LEFT for p in final.actor_states[:3])
    assert all(f.holder != -1 and f.pending for f in final.actor_states[3:])
    assert t.model.next_steps(final) == []


def test_too_tight_compile_bound_fails_the_run_like_jax():
    """A state_bound that cuts reachable states poisons rows; a popped
    poisoned row fails the run on both engines."""
    def tight(model, compile_fn):
        m = model(3)  # reaches term 2; bound it at 1
        tm = compile_fn(m, state_bound=lambda i, s: s.term <= 1,
                        env_bound=lambda e: e.msg[1] <= 1)
        m.tensor_model = lambda: tm
        return m

    with pytest.raises(RuntimeError, match="poisoned"):
        tight(jax_raft, jax_compile).checker().spawn_tpu(
            sync=True, capacity=1 << 14)
    with pytest.raises(RuntimeError, match="poisoned"):
        tight(raft_model, compile_actor_model).checker().spawn_gpu(
            device="cpu", capacity=1 << 14).join()


def test_check_gpu_verbs_raise_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the verbs would run")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_raft.main(["check-gpu", "3"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_dining.main(["check-gpu", "3"])
    assert port_dining.main(["check-gpu", "3", "4"]) == 2
    assert "usage" in capsys.readouterr().err
