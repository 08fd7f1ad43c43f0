"""The port's ``spawn_auto()`` against the JAX package's
(``tests/test_spawn_auto.py``), tolerance 0: the same engine choice, counts
and discoveries, and, where both escalate to their device engines, the
same table bytes.  The port escalates with ``device="cpu"`` here (the
plain PyTorch path); without it, and without a card, escalation raises as
``spawn_gpu`` does and never keeps the host probe's partial result."""

import os

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (both frameworks in one process, JAX on the CPU)

from stateright_tpu.checker.bfs import BfsChecker as JaxBfs
from stateright_tpu.checker.mp import MpBfsChecker as JaxMp
from stateright_tpu.models.two_phase_commit import TwoPhaseSys as JaxSys
from stateright_tpu.parallel.wavefront import TpuChecker
from stateright_tpu_torch.checker.bfs import BfsChecker
from stateright_tpu_torch.checker.dfs import DfsChecker
from stateright_tpu_torch.checker.mp import MpBfsChecker
from stateright_tpu_torch.core import Model, Property
from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
from stateright_tpu_torch.parallel.actor_compiler import CompileError
from stateright_tpu_torch.parallel.wavefront import GpuChecker

AGREEMENT = {"abort agreement", "commit agreement"}


def test_small_space_finishes_on_the_host_probe():
    """A space the probe exhausts is answered by the probe itself: the
    device is never touched."""
    c = TwoPhaseSys(3).checker().spawn_auto()
    j = JaxSys(3).checker().spawn_auto()
    assert isinstance(c, BfsChecker) and isinstance(j, JaxBfs)
    assert c.is_done() and not c.timed_out
    assert (c.unique_state_count(), c.state_count()) == (
        j.unique_state_count(), j.state_count()) == (288, 1146)
    assert set(c.discoveries()) == set(j.discoveries()) == AGREEMENT


def test_large_space_escalates_to_the_device_engine():
    """A probe that times out escalates to the device engine, which
    finishes with the JAX engine's counts and table bytes."""
    c = TwoPhaseSys(5).checker().spawn_auto(
        probe_secs=0.01, device="cpu", capacity=1 << 17, batch=64).join()
    j = JaxSys(5).checker().spawn_auto(probe_secs=0.01, sync=True,
                                      capacity=1 << 17, batch=64)
    assert isinstance(c, GpuChecker) and isinstance(j, TpuChecker)
    assert (c.unique_state_count(), c.state_count()) == (
        j.unique_state_count(), j.state_count()) == (8832, 58146)
    assert set(c.discoveries()) == set(j.discoveries()) == AGREEMENT
    for a, b in zip(c._table_np(), j._table_np()):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_escalation_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the escalation would run")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TwoPhaseSys(5).checker().spawn_auto(probe_secs=0.01)


class Toggle(Model):
    def init_states(self):
        return [0]

    def actions(self, state):
        return ["flip"]

    def next_state(self, state, action):
        return 1 - state

    def properties(self):
        return [Property.sometimes("one", lambda m, s: s == 1)]


def test_no_tensor_twin_checks_on_the_host():
    c = Toggle().checker().spawn_auto()
    assert isinstance(c, BfsChecker)
    assert c.unique_state_count() == 2
    assert set(c.discoveries()) == {"one"}


class FaultyTwin(Toggle):
    """A model whose twin fails to build, with ``error`` (its fingerprints
    stay structural, as a model that declares no twin has them)."""

    def __init__(self, error):
        self.error = error

    def tensor_model(self):
        raise self.error


@pytest.mark.parametrize("error,host", [
    (CompileError("outside the compiled fragment"), True),
    (NotImplementedError("no twin"), True),
    (ValueError("unsupported configuration"), True),
    (TypeError("a fault in the twin's own code"), False),
])
def test_twin_build_failure_falls_back_only_when_it_means_no_twin(error,
                                                                  host):
    """The documented "no twin" errors check on the host; any other error
    is a fault in the twin and reaches the caller."""
    if host:
        c = FaultyTwin(error).checker().spawn_auto()
        assert isinstance(c, BfsChecker) and c.unique_state_count() == 2
    else:
        with pytest.raises(TypeError, match="twin's own code"):
            FaultyTwin(error).checker().spawn_auto()


def test_visitor_small_space_finishes_on_the_thread_probe():
    seen, jseen = [], []
    c = TwoPhaseSys(3).checker().visitor(
        lambda model, path: seen.append(path.final_state())).spawn_auto()
    j = JaxSys(3).checker().visitor(
        lambda model, path: jseen.append(path.final_state())).spawn_auto()
    assert isinstance(c, BfsChecker) and isinstance(j, JaxBfs)
    c.join()
    j.join()
    assert len(seen) == len(jseen) == 288


def test_visitor_large_space_escalates_to_mp(monkeypatch):
    """With a visitor the heavier engine is the process-parallel BFS
    (visits replayed after the merge), never a device engine."""
    monkeypatch.setattr(os, "cpu_count", lambda: 2)
    seen, jseen = [], []
    c = TwoPhaseSys(4).checker().visitor(
        lambda model, path: seen.append(len(path))).spawn_auto(
            probe_secs=0.001)
    j = JaxSys(4).checker().visitor(
        lambda model, path: jseen.append(len(path))).spawn_auto(
            probe_secs=0.001)
    assert isinstance(c, MpBfsChecker) and isinstance(j, JaxMp)
    assert c.unique_state_count() == j.unique_state_count() == len(seen)
    assert seen == jseen == sorted(seen)  # a BFS level order, replayed


def test_symmetry_probe_uses_dfs():
    c = TwoPhaseSys(5).checker().symmetry().spawn_auto(probe_secs=30.0)
    assert isinstance(c, DfsChecker)
    assert c.unique_state_count() == 665  # examples/2pc.rs:138


def test_tiny_user_timeout_stays_on_the_host():
    c = TwoPhaseSys(3).checker().timeout(0.5).spawn_auto(probe_secs=2.0)
    assert isinstance(c, BfsChecker)
    c.join()
    assert c.unique_state_count() == 288


def test_check_auto_cli_verb(capsys):
    """``check-auto`` (and ``check``, the host BFS) on the models that wire
    them, arguments included."""
    from stateright_tpu_torch.models import (
        single_copy_register,
        two_phase_commit,
        write_once_register,
    )

    assert two_phase_commit.main(["check-auto", "3"]) == 0
    out = capsys.readouterr().out
    assert "auto engine selection" in out
    assert "unique=288" in out

    assert single_copy_register.main(["check-auto", "2", "ordered"]) == 0
    assert "Done." in capsys.readouterr().out

    assert write_once_register.main(["check-auto", "2", "1"]) == 0
    assert "unique=71" in capsys.readouterr().out

    assert two_phase_commit.main(["check", "3"]) == 0
    out = capsys.readouterr().out
    assert "(host BFS)" in out and "unique=288" in out


def test_timed_out_flag_distinguishes_deadline_from_completion():
    done = TwoPhaseSys(3).checker().spawn_bfs().join()
    assert not done.timed_out
    capped = TwoPhaseSys(5).checker().target_states(100).spawn_bfs().join()
    assert not capped.timed_out
    cut = TwoPhaseSys(6).checker().timeout(0.01).spawn_bfs().join()
    assert cut.timed_out
    assert cut.unique_state_count() < 30_000
