"""The port's wavefront engine (``spawn_gpu`` on ``device="cpu"``)
against the JAX package's ``TpuChecker`` on the same capacities: counts,
discovery fingerprint traces, growth events, the final visited-table bytes
and queue rows ``[0, tail)`` must be equal (tolerance 0), including runs
small enough to force growth and candidate-budget replays.  The helpers
are ``test_torch_engine.py``'s."""

import numpy as np
import pytest

import jax  # noqa: F401  (both frameworks in one process, JAX on the CPU)
import torch

from fixtures_sweep import BoundedCounterSys as JaxCounterSys
from stateright_tpu.models.two_phase_commit import TwoPhaseSys as JaxSys
from test_torch_engine import CounterSys, assert_same_run, jax_run, port_run


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The port's runs here on one torch thread: their tensors are small,
    and under several test workers the default thread pool oversubscribes
    the host's cores many times over.  Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize(
    "n,kw,unique",
    [
        (3, {}, 288),
        (5, {}, 8832),
        # small enough to force queue and table growth mid-run
        (3, dict(capacity=1 << 6, batch=1 << 3), 288),
    ],
)
def test_counts_tables_and_traces_match_jax_engine(n, kw, unique):
    j = jax_run(n, **dict(kw))
    t = port_run(n, **kw)
    assert t.unique_state_count() == unique
    if n == 3:
        assert t.state_count() == 1146
    assert_same_run(j, t)
    assert t.growth_events == j.growth_events
    if kw:
        assert t.growth_events and t._cap >= 512
    assert set(t.discoveries()) == {"abort agreement", "commit agreement"}
    t.assert_properties()


def test_cand_full_replays_up_to_full_width_match_jax_engine():
    """A budget of 6 of a batch's 24 lanes doubles by CAND_FULL replays to
    12 and then to ``batch * arity``, where the port still compacts (CB ==
    M): counts, tables, traces, growth events and queue rows ``[0, tail)``
    equal the JAX engine's, which stops compacting there."""
    kw = dict(batch=8, cand=6)
    j = JaxCounterSys(5, 3).checker().spawn_tpu(sync=True, frontier_capacity=8,
                                                cand=6)
    t = CounterSys(5, 3).checker().spawn_gpu(device="cpu", **kw).join()
    assert t.unique_state_count() == 6 ** 3
    assert t._cand == 8 * 3
    assert [s for s, _ in t.growth_events].count(3) == 2  # CAND_FULL twice
    assert_same_run(j, t)
    assert t.growth_events == j.growth_events
    js, ts = j.checkpoint(), t.final_snapshot()
    tail = int(ts["tail"])
    assert int(js["tail"]) == tail and int(js["head"]) == int(ts["head"])
    for k in ("q_rows", "q_fp", "q_ebits", "q_depth"):
        np.testing.assert_array_equal(np.asarray(ts[k])[:tail],
                                      np.asarray(js[k])[:tail], err_msg=k)


def test_discovery_paths_replay_and_are_shortest():
    t = port_run(3)
    cpu = JaxSys(3).checker().spawn_bfs().join()
    for name in ("abort agreement", "commit agreement"):
        path = t.discovery(name)
        model = t.model
        assert model.property_by_name(name).condition(model, path.final_state())
        assert len(path) == len(cpu.discovery(name))


@pytest.mark.parametrize(
    "n,target",
    [(5, None), (5, 3000)],  # complete, and stopped with rows still queued
)
def test_queue_rows_match_jax_engine(n, target):
    """Queue rows ``[0, tail)`` (rows, fingerprints, ebits, depths) and the
    cursors equal the JAX engine's at the same capacities; rows past
    ``tail`` are scratch in both engines and are not compared."""
    bound = None if target is None else (lambda b: b.target_states(target))
    j = jax_run(n, bound).checkpoint()
    t = port_run(n, bound).final_snapshot()
    assert int(t["head"]) == int(j["head"]) and int(t["tail"]) == int(j["tail"])
    tail = int(t["tail"])
    assert tail > 0 and (target is None or tail > int(t["head"]))
    for k in ("q_rows", "q_fp", "q_ebits", "q_depth"):
        np.testing.assert_array_equal(np.asarray(t[k])[:tail],
                                      np.asarray(j[k])[:tail], err_msg=k)
