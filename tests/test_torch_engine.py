"""The port's wavefront engine (``spawn_gpu`` on ``device="cpu"``, the plain
PyTorch path) against the JAX package's ``TpuChecker`` on the same
capacities: counts, discovery fingerprint traces and the final
visited-table bytes must be equal (tolerance 0), including a run small
enough to force growth and runs resumed across the two engines'
snapshots."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax  # noqa: F401  (both frameworks in one process, JAX on the CPU)
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from fixtures_sweep import BoundedCounterSys as JaxCounterSys
from stateright_tpu.models.two_phase_commit import TwoPhaseSys as JaxSys
from stateright_tpu_torch import convert
from stateright_tpu_torch.core import Model, Property
from stateright_tpu_torch.models.two_phase_commit import (
    TwoPhaseSys,
    TwoPhaseTensor,
)
from stateright_tpu_torch.parallel.tensor_model import (
    BitPacker,
    TensorBackedModel,
    TensorModel,
)

REPO = Path(__file__).resolve().parent.parent


def jax_run(n, builder=None, **kw):
    b = JaxSys(n).checker() if builder is None else builder(JaxSys(n).checker())
    if "batch" in kw:
        kw["frontier_capacity"] = kw.pop("batch")
    return b.spawn_tpu(sync=True, **kw)


def port_run(n, builder=None, **kw):
    b = TwoPhaseSys(n).checker()
    if builder is not None:
        b = builder(b)
    return b.spawn_gpu(device="cpu", **kw).join()


def assert_same_run(j, t):
    assert t.unique_state_count() == j.unique_state_count()
    assert t.state_count() == j.state_count()
    assert t.max_depth() == j.max_depth()
    jt, tt = j._table_np(), t._table_np()
    np.testing.assert_array_equal(tt[0], np.asarray(jt[0]))
    np.testing.assert_array_equal(tt[1], np.asarray(jt[1]))
    jd = [int(x) for x in np.asarray(j._results["disc"])]
    td = [int(x) for x in t._results["disc"]]
    assert td == jd
    for fp in td:
        if fp:
            assert t._trace(fp) == j._trace(fp)


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


class CounterTensor(TensorModel):
    """The port's twin of ``tests/fixtures_sweep.py``'s bounded counters:
    the same row layout, actions and property masks.  Almost every action
    is enabled, so a batch's valid candidates can pass half its lanes."""

    def __init__(self, model):
        self.model, self.n, self.bound = model, model.n, model.bound
        self.pk = BitPacker([(f"c{i}", 6) for i in range(self.n)])
        self.width, self.max_actions = self.pk.width, self.n

    def init_rows(self) -> np.ndarray:
        return np.asarray([self.encode_state(s)
                           for s in self.model.init_states()], np.uint64)

    def encode_state(self, state) -> tuple:
        return self.pk.pack(**{f"c{i}": v for i, v in enumerate(state)})

    def decode_state(self, row):
        d = self.pk.unpack(row)
        return tuple(d[f"c{i}"] for i in range(self.n))

    def step_rows(self, rows):
        succ, valid = [], []
        for i in range(self.n):
            v = self.pk.get(rows, f"c{i}")
            ok = v < self.bound
            succ.append(self.pk.set(rows, f"c{i}", torch.where(ok, v + 1, v)))
            valid.append(ok)
        return torch.stack(succ, dim=-2), torch.stack(valid, dim=-1)

    def property_masks(self, rows):
        vals = torch.stack([self.pk.get(rows, f"c{i}") for i in range(self.n)],
                           dim=-1)
        maxed = (vals >= self.bound).any(dim=-1)
        over = (vals > 63).any(dim=-1)
        return torch.stack([~over, maxed], dim=-1)


class CounterSys(TensorBackedModel, Model):
    def __init__(self, bound: int, counters: int):
        self.bound, self.n = bound, counters

    def properties(self):
        return [
            Property.always("in range",
                            lambda m, s: all(v <= m.bound for v in s)),
            Property.sometimes("some counter maxed",
                               lambda m, s: any(v >= m.bound for v in s)),
        ]

    def init_states(self):
        return [(0,) * self.n]

    def actions(self, state):
        return [i for i in range(self.n) if state[i] < self.bound]

    def next_state(self, state, action):
        out = list(state)
        out[action] += 1
        return tuple(out)

    def tensor_model(self):
        return CounterTensor(self)


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


# One case per model family, each in a subprocess of its own: with the
# suite on six xdist workers, one subprocess with all eight runs in it,
# on as many intra-op threads as the machine has cores, took more than
# its 300 s limit (34 s alone).  Each case runs on one thread, so six of
# them load six cores, not 48 threads on 8.
ISOLATION_CASES = {
    "2pc": (
        "from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys\n"
        "c = TwoPhaseSys(3).checker().spawn_gpu(device='cpu').join()\n"
        "assert c.unique_state_count() == 288, c.unique_state_count()\n"
    ),
    "paxos": (
        "from stateright_tpu_torch.models.paxos import paxos_model\n"
        "p = paxos_model(1).checker().spawn_gpu(device='cpu').join()\n"
        "assert p.unique_state_count() == 265, p.unique_state_count()\n"
        "assert set(p.discoveries()) == {'value chosen'}\n"
    ),
    "single-copy": (
        "from stateright_tpu_torch.models.single_copy_register import "
        "single_copy_model\n"
        "s = single_copy_model(2).checker().spawn_gpu(device='cpu').join()\n"
        "assert s.unique_state_count() == 93, s.unique_state_count()\n"
        "s2 = single_copy_model(2, 1, put_count=2).checker().spawn_gpu(\n"
        "    device='cpu').join()\n"
        "assert s2.unique_state_count() == 369, s2.unique_state_count()\n"
    ),
    "raft": (
        "from stateright_tpu_torch.models.raft import raft_model\n"
        "r = raft_model(3).checker().spawn_gpu(device='cpu').join()\n"
        "assert r.unique_state_count() == 5725, r.unique_state_count()\n"
    ),
    "write-once": (
        "from stateright_tpu_torch.models.write_once_register import "
        "wo_register_model\n"
        "w = wo_register_model(2).checker().spawn_gpu(device='cpu').join()\n"
        "assert w.unique_state_count() == 71, w.unique_state_count()\n"
    ),
    "per-channel": (
        "from stateright_tpu_torch.models.paxos import paxos_model\n"
        "pc = paxos_model(1)\n"
        "pc.per_channel_()\n"
        "assert pc.tensor_model().network_encoding == 'per-channel'\n"
        "pc = pc.checker().spawn_gpu(device='cpu').join()\n"
        "assert pc.unique_state_count() == 265, pc.unique_state_count()\n"
    ),
    "symmetry": (
        "from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys\n"
        "from stateright_tpu_torch.models.raft import raft_model\n"
        "g = TwoPhaseSys(5).checker().symmetry().spawn_gpu(device='cpu')\n"
        "assert g.join().unique_state_count() == 508, g.unique_state_count()\n"
        "assert set(g.discoveries()) == {'abort agreement', "
        "'commit agreement'}\n"
        "d = TwoPhaseSys(5).checker().symmetry().spawn_dfs().join()\n"
        "assert d.unique_state_count() == 665, d.unique_state_count()\n"
        "b = TwoPhaseSys(3).checker().spawn_bfs().join()\n"
        "assert b.unique_state_count() == 288, b.unique_state_count()\n"
        "r = raft_model(3).checker().symmetry().spawn_gpu(device='cpu')\n"
        "assert r.join().unique_state_count() == 2926, r.unique_state_count()\n"
        "assert set(r.discoveries()) == {'a leader is elected'}\n"
    ),
    # the step flags (prededup; mxu, accepted without effect) on the
    # hand-written and the compiled twins, under symmetry too
    "step-flags": (
        "from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys\n"
        "from stateright_tpu_torch.models.paxos import paxos_model\n"
        "from stateright_tpu_torch.models.single_copy_register import "
        "single_copy_model\n"
        "t = TwoPhaseSys(3).checker().prededup().mxu().spawn_gpu(\n"
        "    device='cpu', batch=64).join()\n"
        "assert t.unique_state_count() == 288, t.unique_state_count()\n"
        "p = paxos_model(1).checker().prededup().mxu().spawn_gpu(\n"
        "    device='cpu', batch=64).join()\n"
        "assert p.unique_state_count() == 265, p.unique_state_count()\n"
        "assert set(p.discoveries()) == {'value chosen'}\n"
        "s = single_copy_model(2).checker().mxu().spawn_gpu(\n"
        "    device='cpu', batch=64).join()\n"
        "assert s.unique_state_count() == 93, s.unique_state_count()\n"
        "y = TwoPhaseSys(5).checker().symmetry().prededup().spawn_gpu(\n"
        "    device='cpu', batch=64).join()\n"
        "assert y.unique_state_count() == 508, y.unique_state_count()\n"
    ),
    "checkpoint-auto-orl": (
        "import tempfile\n"
        "from stateright_tpu_torch import checkpoint\n"
        "from stateright_tpu_torch.models.orl import orl_model\n"
        "from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys\n"
        "d = tempfile.mkdtemp()\n"
        "c = TwoPhaseSys(3).checker().autosave(d, every_secs=0.0).spawn_gpu(\n"
        "    device='cpu', batch=32, steps_per_call=2).join()\n"
        "snap = c.checkpoint()\n"
        "mid = checkpoint.list_generations(d)[0]['path']\n"
        "r = TwoPhaseSys(3).checker().spawn_gpu(device='cpu', resume=dict(\n"
        "    __import__('numpy').load(mid + '/snapshot.npz'))).join()\n"
        "assert r.unique_state_count() == int(snap['unique']) == 288\n"
        "a = TwoPhaseSys(4).checker().spawn_auto(probe_secs=0.001,\n"
        "                                        device='cpu').join()\n"
        "assert type(a).__name__ == 'GpuChecker', type(a)\n"
        "assert a.unique_state_count() == 1568, a.unique_state_count()\n"
        "o = orl_model().checker().spawn_gpu(device='cpu').join()\n"
        "assert o.unique_state_count() == 148, o.unique_state_count()\n"
    ),
}


@pytest.mark.parametrize("family", list(ISOLATION_CASES))
def test_port_run_loads_neither_jax_nor_the_reference(family):
    code = (
        "import sys\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        + ISOLATION_CASES[family]
        + "bad = [m for m in sys.modules\n"
        "       if m == 'jax' or m.startswith(('jax.', 'stateright_tpu.'))\n"
        "       or m == 'stateright_tpu']\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    # alone each case takes 3-15 s on one thread
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_port_sources_never_import_jax_or_the_reference():
    files = sorted((REPO / "stateright_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        for line in f.read_text().splitlines():
            s = line.strip()
            for bad in ("import jax", "from jax", "import stateright_tpu\n",
                        "from stateright_tpu ", "from stateright_tpu.",
                        "import stateright_tpu."):
                assert not (s + "\n").startswith(bad), (f, line)


def test_spawn_gpu_without_a_device_raises_when_no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TwoPhaseSys(3).checker().spawn_gpu()


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


class SyncProbe(TorchDispatchMode):
    """Counts the dispatched operations that read a tensor on the host:
    on a CUDA tensor each is a device-to-host copy and a stream sync."""

    HOST_READS = (
        torch.ops.aten._local_scalar_dense.default,
        torch.ops.aten.is_nonzero.default,
        torch.ops.aten.nonzero.default,
        torch.ops.aten.masked_select.default,
    )

    def __init__(self):
        super().__init__()
        self.hits: list = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.HOST_READS:
            self.hits.append(str(func))
        return func(*args, **(kwargs or {}))


def sync_free_model(name):
    from stateright_tpu_torch.models.paxos import paxos_model
    from stateright_tpu_torch.models.paxos_tensor import PaxosTensor
    from stateright_tpu_torch.models.raft import raft_model
    from stateright_tpu_torch.parallel.actor_compiler import (
        CompiledActorTensor,
    )

    if name.startswith("2pc"):
        return TwoPhaseSys(3), TwoPhaseTensor
    if name == "raft-sym":
        return raft_model(3), CompiledActorTensor
    m = paxos_model(1)
    if name == "per-channel":
        m.per_channel_()
        return m, CompiledActorTensor
    return m, PaxosTensor


# unique states of each probed run; "-sym" runs under .symmetry(),
# "-flags" under .prededup().mxu()
SYNC_FREE_UNIQUE = {"2pc": 288, "paxos": 265, "per-channel": 265,
                    "2pc-sym": 94, "raft-sym": 2926, "2pc-flags": 288,
                    "paxos-flags": 265}


@pytest.mark.parametrize("name", list(SYNC_FREE_UNIQUE))
def test_engine_blocks_dispatch_no_host_read(name, monkeypatch):
    """Every block of ``steps_per_call`` steps, post-stop no-ops included,
    runs under a ``TorchDispatchMode`` probe: no operation that reads a
    tensor on the host (``aten._local_scalar_dense`` and kin) is
    dispatched, for 2pc, ``PaxosTensor`` and a per-channel compiled twin,
    under symmetry for 2pc (``representative_rows``) and raft (the
    compiler's mechanical symmetry), and with ``.prededup().mxu()`` for 2pc
    and ``PaxosTensor`` (``window_unique``).  The
    host reads one packed stats tensor per block, outside the block."""
    from stateright_tpu_torch.parallel import wavefront

    blocks = []
    run = wavefront._Engine.run

    def probed(self, carry):
        probe = SyncProbe()
        with probe:
            out = run(self, carry)
        blocks.append(probe.hits)
        return out

    monkeypatch.setattr(wavefront._Engine, "run", probed)
    m, twin = sync_free_model(name)
    assert isinstance(m.tensor_model(), twin)
    b = m.checker()
    if name.endswith("-sym"):
        b = b.symmetry()
    if name.endswith("-flags"):
        b = b.prededup().mxu()
    c = b.spawn_gpu(device="cpu", steps_per_call=4).join()
    assert c._prededup == name.endswith("-flags")
    assert c.unique_state_count() == SYNC_FREE_UNIQUE[name]
    assert len(blocks) > 2
    assert blocks == [[]] * len(blocks)


class OpCount(TorchDispatchMode):
    """Counts every dispatched operation by name."""

    def __init__(self):
        super().__init__()
        self.ops: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func)] = self.ops.get(str(func), 0) + 1
        return func(*args, **(kwargs or {}))


# dispatched operations per step with the pre-dedup off, the twins' packed
# words built by the coalesced writer (a paxos twin's two counts differ by
# six ``aten.view`` calls, which a step makes or not as its intermediates'
# layouts fall)
FLAGS_OFF_OPS_PER_STEP = {"2pc": {455}, "paxos": {1405, 1411},
                          "per-channel": {1702, 1742}, "2pc-sym": {501}}


@pytest.mark.parametrize("name", list(FLAGS_OFF_OPS_PER_STEP))
@pytest.mark.parametrize("explicit", [False, True])
def test_step_flags_off_dispatch_the_same_operations(name, explicit,
                                                    monkeypatch):
    """With ``prededup`` off, unset or turned off explicitly against its
    env knob (and ``mxu``, which has no effect, likewise), every step
    dispatches exactly the pinned operations: no pre-dedup, and no clone of
    the block per field write."""
    from stateright_tpu_torch.parallel import wavefront

    steps = []
    step = wavefront._Engine.step

    def counted(self, c):
        probe = OpCount()
        with probe:
            out = step(self, c)
        steps.append(probe.ops)
        return out

    monkeypatch.setattr(wavefront._Engine, "step", counted)
    m, _ = sync_free_model(name)
    b = m.checker()
    if name.endswith("-sym"):
        b = b.symmetry()
    if explicit:
        monkeypatch.setenv("STATERIGHT_TPU_PREDEDUP", "1")
        monkeypatch.setenv("STATERIGHT_TPU_MXU", "1")
        b = b.prededup(False).mxu(False)
    c = b.spawn_gpu(device="cpu", batch=64, steps_per_call=4).join()
    assert not c._prededup
    assert steps
    assert {sum(ops.values()) for ops in steps} <= FLAGS_OFF_OPS_PER_STEP[name]
    assert all("aten.clone.default" not in ops for ops in steps)
