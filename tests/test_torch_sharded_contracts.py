"""The standing contracts of ``tests/test_torch_engine.py``, extended to
the sharded engine (``spawn_gpu(devices=N)``, ``parallel/sharded.py``):
no block reads a device value on the host, flags off dispatch exactly the
pinned operations (the same at 2 and 8 shards: the shards are stacked),
and a sharded run, alone and under a process group, loads neither ``jax``
nor ``stateright_tpu``.  The engine file's probes and op counter are
reused; the runs here take one torch thread (``one_thread``)."""

import pytest

from stateright_tpu_torch.models.paxos import paxos_model
from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
from stateright_tpu_torch.parallel import sharded
from stateright_tpu_torch.testing.por_fixtures import ToggleSys
from test_torch_engine import OpCount, SyncProbe, assert_isolated, inert_plan
from test_torch_sharded import one_thread  # noqa: F401

# the probed runs: unique states; "-growth" at capacities that force every
# growth the step raises, under .prededup() (the per-shard window), "-sym"
# under .symmetry() (the generation-order plan) and .cartography() (the
# replicated load and route counters), "-por" under .por() on the toggle
# fixture (the take-back, the reverse route, one proviso re-expansion)
SYNC_FREE = {"2pc-growth": 288, "2pc-sym": 100, "paxos": 265,
             "toggle-por": 4}


@pytest.mark.parametrize("name", list(SYNC_FREE))
def test_sharded_blocks_dispatch_no_host_read(name, monkeypatch):
    """Every sharded block under ``test_torch_engine.py``'s probe: the
    route (the sort by owner, the send scatter into the scratch-row
    buffer), the owners' batched sort and shared plan, the per-shard
    counts and frontier, the replicated reductions, the take-back and the
    reverse route read nothing on the host; the host reads one packed
    stats tensor per block, outside it."""
    blocks = []
    run = sharded._ShardedEngine.run

    def probed(self, carry):
        probe = SyncProbe()
        with probe:
            out = run(self, carry)
        blocks.append(probe.hits)
        return out

    monkeypatch.setattr(sharded._ShardedEngine, "run", probed)
    kw = dict(steps_per_call=2)
    if name == "2pc-growth":
        b = TwoPhaseSys(3).checker().prededup()
        kw.update(devices=8, capacity=1 << 8, frontier_capacity=1 << 5)
    elif name == "2pc-sym":
        b = TwoPhaseSys(3).checker().symmetry().cartography()
        kw.update(devices=4)
    elif name == "paxos":
        b, kw["devices"] = paxos_model(1).checker(), 4
    else:
        b = ToggleSys().checker().por()
        kw.update(devices=2, steps_per_call=1)
    c = b.spawn_gpu(device="cpu", sync=True, **kw)
    assert c.unique_state_count() == SYNC_FREE[name]
    assert bool(c.growth_events) == (name == "2pc-growth")
    assert len(blocks) > 2
    assert blocks == [[]] * len(blocks)


# dispatched operations per sharded step, flags off: the same at every
# shard count
FLAGS_OFF_OPS = {"2pc": {508}, "paxos": {1469, 1471}}


@pytest.mark.parametrize("name,devices,explicit", [
    ("2pc", 2, False), ("2pc", 8, True), ("2pc", 4, "por"),
    ("paxos", 4, "armed")])
def test_sharded_step_flags_off_dispatch_the_same_operations(
        name, devices, explicit, monkeypatch, tmp_path):
    """With ``prededup``, ``mxu`` and ``por`` off (unset, or turned off
    against their env knobs) and with the fault seams and autosave armed,
    every sharded step dispatches exactly the pinned operations, at 2 and
    8 shards alike."""
    steps = []
    step = sharded._ShardedEngine.step

    def counted(self, c):
        probe = OpCount()
        with probe:
            out = step(self, c)
        steps.append(probe.ops)
        return out

    monkeypatch.setattr(sharded._ShardedEngine, "step", counted)
    b = (TwoPhaseSys(3) if name == "2pc" else paxos_model(1)).checker()
    if explicit is True:
        monkeypatch.setenv("STATERIGHT_TPU_PREDEDUP", "1")
        monkeypatch.setenv("STATERIGHT_TPU_MXU", "1")
        b = b.prededup(False).mxu(False)
    elif explicit == "por":
        monkeypatch.setenv("STATERIGHT_TPU_POR", "1")
        b = b.por(False)
    elif explicit == "armed":
        b = b.autosave(str(tmp_path), every_secs=0.0)
        monkeypatch.setattr("stateright_tpu_torch.testing.faults._ACTIVE",
                            inert_plan())
    c = b.spawn_gpu(devices=devices, device="cpu", sync=True,
                    steps_per_call=4)
    assert not c._prededup and not c._por
    assert (c._heartbeat is not None) == (explicit == "armed")
    assert steps
    assert {sum(ops.values()) for ops in steps} <= FLAGS_OFF_OPS[name]


# the import-isolation test's sharded case: a run over stacked shards with
# growth and cartography, then the same engine under a process group (one
# gloo rank: the collectives' path)
ISOLATION_CASES = {
    "sharded": (
        "import socket\n"
        "import torch.distributed as dist\n"
        "from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys\n"
        "c = TwoPhaseSys(3).checker().cartography().spawn_gpu(\n"
        "    devices=4, device='cpu', sync=True, capacity=1 << 8,\n"
        "    frontier_capacity=1 << 5)\n"
        "assert c.unique_state_count() == 288 and c.growth_events\n"
        "assert sum(c.cartography()['shard_load']) == 288\n"
        "s = socket.socket(); s.bind(('localhost', 0))\n"
        "port = s.getsockname()[1]; s.close()\n"
        "dist.init_process_group('gloo', init_method=f'tcp://localhost:{port}',\n"
        "                        world_size=1, rank=0)\n"
        "g = TwoPhaseSys(3).checker().spawn_gpu(devices=4, device='cpu',\n"
        "                                       sync=True)\n"
        "assert g._xch.dist is not None and g.unique_state_count() == 288\n"
        "dist.destroy_process_group()\n"
    ),
}


@pytest.mark.parametrize("family", list(ISOLATION_CASES))
def test_port_run_loads_neither_jax_nor_the_reference(family):
    assert_isolated(ISOLATION_CASES[family])
