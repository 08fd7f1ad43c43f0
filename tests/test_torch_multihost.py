"""The port's sharded engine under several controllers (JAX
``tests/test_multihost.py``): two ``gloo`` processes on the CPU, 4 shards
each, run one 8-shard engine (``tests/torch_multihost_worker.py``); both
ranks land 2pc-3's 288, rebuild valid discovery paths from the
all-gathered table and grow in lockstep, and their tables, growth events
and cartography, and a POR run's tallies and tables (the owners' novelty
sent back by the reverse exchange), equal one controller's runs.
Then the fences: growth is not fenced when the controller count says
several, and an error in the run thread surfaces at ``join()``."""

import json
import os
import socket
import subprocess
import sys

import pytest

from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
from stateright_tpu_torch.parallel import sharded
from stateright_tpu_torch.testing.por_fixtures import ToggleSys
from test_torch_sharded import one_thread  # noqa: F401


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_sharded_engine_multi_controller_2pc3():
    import hashlib

    worker = os.path.join(os.path.dirname(__file__),
                          "torch_multihost_worker.py")
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, worker, str(r), "2",
                               str(port)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    one = TwoPhaseSys(3).checker().cartography().spawn_gpu(
        devices=8, device="cpu", sync=True, capacity=1 << 7,
        frontier_capacity=1 << 5)
    tfp, tpl = one._table_np()
    por = ToggleSys().checker().por().spawn_gpu(devices=4, device="cpu",
                                                sync=True)
    pfp, ppl = por._table_np()
    want = {"growth_events": [list(g) for g in one.growth_events],
            "table": hashlib.sha256(tfp.tobytes() + tpl.tobytes()).hexdigest(),
            "cartography": json.loads(json.dumps(one.cartography())),
            "por": [por.unique_state_count(), por.state_count(),
                    por.por_status(),
                    hashlib.sha256(pfp.tobytes() + ppl.tobytes()).hexdigest()]}
    assert want["por"][:2] == [4, 6]
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
        for tag in ("worker-ok", "growth-ok", "fences-ok", "isolated"):
            assert f"torch-multihost-{tag} r{r}" in out, out[-2000:]
        line = next(ln for ln in out.splitlines()
                    if ln.startswith("torch-multihost-result "))
        got = json.loads(line.split(" ", 1)[1])
        assert got.pop("rank") == r
        assert got == want


def test_lockstep_growth_not_fenced_under_multi_controller(monkeypatch):
    """With the controller count saying two, a run forced to grow still
    completes (growth's trigger is a replicated status), while the
    controls that would desynchronize the ranks are refused."""
    monkeypatch.setattr(sharded, "controllers", lambda: 2)
    c = TwoPhaseSys(4).checker().spawn_gpu(
        devices=8, device="cpu", sync=True, capacity=1 << 8,
        frontier_capacity=1 << 5)
    assert c.unique_state_count() == 1568
    assert len(c.growth_events) >= 1
    uniq = [u for _, u in c.growth_events]
    assert uniq == sorted(uniq)
    with pytest.raises(NotImplementedError, match="single-controller"):
        c.checkpoint()
    with pytest.raises(NotImplementedError, match="single-controller"):
        c.stop()


def test_autosave_is_disarmed_under_multi_controller(monkeypatch, tmp_path,
                                                     capsys):
    monkeypatch.setattr(sharded, "controllers", lambda: 2)
    c = TwoPhaseSys(3).checker().autosave(str(tmp_path), every_secs=0.0)
    c = c.spawn_gpu(devices=4, device="cpu", sync=True)
    assert c.unique_state_count() == 288 and c._autosave is None
    assert "DISARMED" in capsys.readouterr().err
    assert not list(tmp_path.glob("*.npz"))


def test_async_run_thread_error_surfaces_at_join(monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("boom in run thread")

    monkeypatch.setattr(sharded, "_ShardedEngine", boom)
    c = TwoPhaseSys(3).checker().spawn_gpu(
        sync=False, devices=8, device="cpu", capacity=1 << 13,
        frontier_capacity=1 << 9)
    with pytest.raises(RuntimeError, match="boom in run thread"):
        c.join()
