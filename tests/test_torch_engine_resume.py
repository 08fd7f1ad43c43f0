"""Snapshots and resumes of the port's wavefront engine on the CPU: runs
resumed across the two engines' snapshots (either package resumes the
other's) end with the uninterrupted JAX run's counts and table bytes; a
stopped run resumes; a snapshot round-trips exactly and is refused by
another model.  The helpers are ``test_torch_engine.py``'s."""

import numpy as np
import pytest

import jax  # noqa: F401  (both frameworks in one process, JAX on the CPU)
import torch

from stateright_tpu.models.two_phase_commit import TwoPhaseSys as JaxSys
from stateright_tpu_torch import convert
from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
from test_torch_engine import assert_same_run, jax_run, port_run


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The port's runs here on one torch thread: their tensors are small,
    and under several test workers the default thread pool oversubscribes
    the host's cores many times over.  Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_resume_from_jax_snapshot_finishes_the_space():
    j = jax_run(5, lambda b: b.target_states(1000))
    assert 1000 <= j.unique_state_count() < 8832
    snap = j.checkpoint()
    keep = {k: np.array(v, copy=True) for k, v in snap.items()
            if isinstance(v, np.ndarray)}
    t = TwoPhaseSys(5).checker().spawn_gpu(device="cpu", resume=snap).join()
    assert t.unique_state_count() == 8832
    # the caller's snapshot is never written through
    for k, v in keep.items():
        np.testing.assert_array_equal(snap[k], v)
    assert_same_run(jax_run(5), t)


def test_jax_engine_resumes_from_port_snapshot():
    t = port_run(5, lambda b: b.target_states(1000))
    assert 1000 <= t.unique_state_count() < 8832
    j = JaxSys(5).checker().spawn_tpu(sync=True, resume=t.final_snapshot())
    assert j.unique_state_count() == 8832


def test_timeout_stops_and_snapshot_resumes():
    t = port_run(5, lambda b: b.timeout(0.0), steps_per_call=1, batch=1 << 6)
    assert t.unique_state_count() < 8832
    r = TwoPhaseSys(5).checker().spawn_gpu(
        device="cpu", steps_per_call=1, batch=1 << 6, resume=t.final_snapshot()
    ).join()
    assert r.unique_state_count() == 8832


def test_snapshot_round_trip_is_exact():
    t = port_run(3, lambda b: b.target_states(100))
    snap = t.final_snapshot()
    carry = convert.carry_from_snapshot(snap, "cpu")
    again = convert.carry_to_snapshot(carry, snap["cap"], snap["qcap"],
                                      snap["batch"], snap["cand"])
    for k in convert.SNAPSHOT_KEYS:
        assert np.asarray(again[k]).dtype == np.asarray(snap[k]).dtype, k
        np.testing.assert_array_equal(again[k], snap[k])


def test_resume_rejects_another_models_snapshot():
    snap = port_run(3, lambda b: b.target_states(100)).final_snapshot()
    with pytest.raises(ValueError, match="different model"):
        TwoPhaseSys(4).checker().spawn_gpu(device="cpu", resume=snap)
