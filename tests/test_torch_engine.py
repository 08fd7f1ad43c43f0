"""The port's wavefront engine (``spawn_gpu`` on ``device="cpu"``, the plain
PyTorch path): the helpers that hold a port run to the JAX package's
``TpuChecker`` on the same capacities (counts, discovery fingerprint traces
and the final visited-table bytes equal, tolerance 0), and the standing
contracts: no import of JAX or the reference, no host read inside a block,
the pinned operations of a step with the flags off.  The JAX-parity runs
are in ``test_torch_engine_parity.py`` and the snapshot/resume runs in
``test_torch_engine_resume.py``, so that the test workers spread them."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax  # noqa: F401  (both frameworks in one process, JAX on the CPU)
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from stateright_tpu.models.two_phase_commit import TwoPhaseSys as JaxSys
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


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The port's runs here on one torch thread: their tensors are small,
    and under several test workers the default thread pool oversubscribes
    the host's cores many times over.  Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


# One case per model family, each in a subprocess of its own: with the
# suite on six xdist workers, one subprocess with all eight runs in it,
# on as many intra-op threads as the machine has cores, took more than
# its 300 s limit (34 s alone).  Each case runs on one thread, so six of
# them load six cores, not 48 threads on 8.  The cases run in
# ``test_torch_engine_isolation.py`` (the model families) and
# ``test_torch_engine_isolation_flags.py`` (the flags and services), so
# that the test workers spread them.
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
    # checked mode: a clean run, and the out-of-range twin's error
    "checked": (
        "sys.path.insert(0, 'tests')\n"
        "from test_torch_oob_twin import OOBModel\n"
        "from stateright_tpu_torch.analysis import CheckedExecutionError\n"
        "from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys\n"
        "c = TwoPhaseSys(3).checker().checked().spawn_gpu(\n"
        "    device='cpu', batch=64).join()\n"
        "assert c.unique_state_count() == 288, c.unique_state_count()\n"
        "try:\n"
        "    OOBModel().checker().skip_audit().checked().spawn_gpu(\n"
        "        device='cpu', batch=8).join()\n"
        "    raise SystemExit('no error')\n"
        "except CheckedExecutionError as e:\n"
        "    assert e.state == 4, e\n"
    ),
    # the spill tier, evicting under a budget
    "spill": (
        "import os\n"
        "from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys\n"
        "from stateright_tpu_torch.parallel.wavefront import memory_spec_fn\n"
        "from stateright_tpu_torch.telemetry.memory import total_bytes\n"
        "tm = TwoPhaseSys(5).tensor_model()\n"
        "f = memory_spec_fn(tm, 3, cuda=False,\n"
        "                   spill=(1 << 14, 4 * 128 * tm.max_actions))\n"
        "tot = lambda cap: total_bytes(f(dict(cap=cap, qcap=4096, batch=128,\n"
        "                                     cand=4096)))\n"
        "os.environ['STATERIGHT_TPU_DEVICE_BYTES'] = str(\n"
        "    tot(1 << 13) + tot(1 << 14) - 1)\n"
        "c = TwoPhaseSys(5).checker().spill().spawn_gpu(\n"
        "    device='cpu', capacity=1 << 12, batch=128, queue_capacity=4096,\n"
        "    spill_bloom_bits=1 << 14, steps_per_call=8).join()\n"
        "assert c.unique_state_count() == 8832, c.unique_state_count()\n"
        "assert c.spill_status()['evictions'] >= 1\n"
    ),
    # partial-order reduction: the footprint pass on the captured graph,
    # the plan, the engine's ample and proviso rounds, the fallback
    "por": (
        "from stateright_tpu_torch.models.paxos import paxos_model\n"
        "from stateright_tpu_torch.models.dining import dining_model\n"
        "from stateright_tpu_torch.testing.por_fixtures import WorkersSys\n"
        "w = WorkersSys(7).checker().por().spawn_gpu(device='cpu',\n"
        "                                            batch=64).join()\n"
        "assert (w.unique_state_count(), w.state_count()) == (15, 15)\n"
        "pc = paxos_model(1)\n"
        "pc.per_channel_()\n"
        "pc = pc.checker().por().prededup().spawn_gpu(device='cpu',\n"
        "                                             batch=64).join()\n"
        "assert pc.unique_state_count() == 250, pc.unique_state_count()\n"
        "assert pc.por_status()['rows_full_proviso'] == 22\n"
        "d = dining_model(3).checker().por().spawn_gpu(device='cpu',\n"
        "                                              batch=64).join()\n"
        "assert d.por_status()['enabled'] is False\n"
    ),
    # the supervisor (a supervised run killed by a plan and resumed), the
    # heartbeat and status, and the audit (the builder's, the preflight's
    # and the fleet's)
    "supervise-audit": (
        "import tempfile\n"
        "from stateright_tpu_torch.checkpoint import read_progress\n"
        "from stateright_tpu_torch.models._cli import fleet_audit\n"
        "from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys\n"
        "from stateright_tpu_torch.supervisor import supervise\n"
        "from stateright_tpu_torch.testing.faults import Fault, FaultPlan\n"
        "d = tempfile.mkdtemp()\n"
        "with FaultPlan([Fault(site='host_sync', action='kill', at=3)]):\n"
        "    r = supervise(TwoPhaseSys(3).checker().telemetry(),\n"
        "                  autosave_dir=d, every_secs=0.0,\n"
        "                  sleep=lambda s: None, device='cpu', batch=32,\n"
        "                  steps_per_call=2)\n"
        "assert r.restarts == 1 and r.unique_state_count() == 288\n"
        "assert read_progress(d)['verdict'] == 'done'\n"
        "assert TwoPhaseSys(3).checker().audit().ok\n"
        "assert fleet_audit(['two_phase_commit', 'paxos', 'quickstart'],\n"
        "                   stream=open(d + '/audit.txt', 'w')) == 0\n"
    ),
    # sweeps: a seed-only family (member 0's kernels) and a lifted cohort
    # (the unified graph under vmap), the CLI verb's spawn path
    "sweep": (
        "from stateright_tpu_torch.models.two_phase_commit import (\n"
        "    TwoPhaseSys, sweep_family)\n"
        "from stateright_tpu_torch.testing.sweep_fixtures import (\n"
        "    bounded_counter_spec)\n"
        "c = TwoPhaseSys(3).checker().sweep(sweep_family(2)).spawn_gpu(\n"
        "    device='cpu', capacity=1 << 12, batch=64).join()\n"
        "assert c.unique_state_count() == 576, c.unique_state_count()\n"
        "spec = bounded_counter_spec([1, 2, 3])\n"
        "s = spec.instances[0].model.checker().sweep(spec).spawn_gpu(\n"
        "    device='cpu', capacity=1 << 12, batch=32).join()\n"
        "assert s.cohorts[0].lifted > 0\n"
        "assert [r.unique for r in s.results.values()] == [4, 9, 16]\n"
    ),
    # the Explorer over a GPU run with the metrics bus (every endpoint
    # polled) and over the host BFS, and the fleet: a packed cohort, a
    # supervised singleton preempted and resumed, the runs verb
    "explorer": (
        "import json, urllib.request\n"
        "from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys\n"
        "s = TwoPhaseSys(3).checker().telemetry(metrics=True).serve(\n"
        "    'localhost:0', strategy='gpu', block=False, device='cpu',\n"
        "    batch=64, steps_per_call=4)\n"
        "s.checker.join()\n"
        "for p in ('/.status', '/.metrics', '/metrics', '/.states/'):\n"
        "    urllib.request.urlopen(f'http://{s.addr}{p}').read()\n"
        "st = json.loads(urllib.request.urlopen(\n"
        "    f'http://{s.addr}/.status').read())\n"
        "assert st['unique_state_count'] == 288\n"
        "s.shutdown()\n"
        "h = TwoPhaseSys(3).checker().serve('localhost:0', block=False)\n"
        "h.checker.join()\n"
        "h.shutdown()\n"
    ),
    "fleet": (
        "import io, tempfile\n"
        "from stateright_tpu_torch.models._cli import fleet_runs\n"
        "from stateright_tpu_torch.fleet import (FleetSpec, Job,\n"
        "    PreemptionPlan, run_fleet)\n"
        "from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys\n"
        "d = tempfile.mkdtemp()\n"
        "def job(key, n, packable):\n"
        "    return Job(key=key, packable=packable, batch=64,\n"
        "               build=lambda: TwoPhaseSys(n).checker().runs(d))\n"
        "r = run_fleet(FleetSpec([job('a', 3, True), job('b', 3, True),\n"
        "                         job('v', 4, False)], slots=2,\n"
        "                        campaign_id='c'),\n"
        "              root=d + '/pool', stream=None, device='cpu',\n"
        "              preemption=PreemptionPlan({'v': 2}))\n"
        "assert r.completed == 3 and r['v'].unique == 1568, r.to_json()\n"
        "assert fleet_runs([d], stream=io.StringIO()) == 0\n"
    ),
    # the mesh engine on 4 pieces, with cartography and its stats
    "mesh": (
        "from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys\n"
        "c = TwoPhaseSys(3).checker().mesh(devices=4).cartography().spawn_gpu(\n"
        "    device='cpu', batch=64).join()\n"
        "assert c.unique_state_count() == 288, c.unique_state_count()\n"
        "assert sum(c.mesh_stats()['shard_load']) == 288\n"
        "assert c.final_snapshot()['engine'] == 'mesh'\n"
    ),
    # the UDP runtime: a register server's put and get on localhost
    "spawn": (
        "import json, socket\n"
        "from stateright_tpu_torch.actor import Id, spawn\n"
        "from stateright_tpu_torch.models.single_copy_register import (\n"
        "    SingleCopyServer)\n"
        "s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)\n"
        "s.bind(('127.0.0.1', 0)); s.settimeout(5.0)\n"
        "p = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)\n"
        "p.bind(('127.0.0.1', 0)); port = p.getsockname()[1]; p.close()\n"
        "h = spawn([(Id.from_addr('127.0.0.1', port), SingleCopyServer())])\n"
        "s.sendto(json.dumps(['put', 1, 'X']).encode(), ('127.0.0.1', port))\n"
        "assert json.loads(s.recvfrom(65536)[0]) == ['put_ok', 1]\n"
        "h[0].stop(); h[0].join(2.0); s.close()\n"
    ),
    # the native module: built, the consistency search, the baseline
    "native": (
        "from stateright_tpu_torch.native import load\n"
        "from stateright_tpu_torch.native.baseline import compiled_cpu_bfs\n"
        "from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys\n"
        "from stateright_tpu_torch.semantics import (LinearizabilityTester,\n"
        "    Register)\n"
        "from stateright_tpu_torch.semantics.register import READ, write\n"
        "assert load() is not None\n"
        "t = LinearizabilityTester(Register('0')).on_invoke(0, write('A'))\n"
        "t = t.on_return(0, ('write_ok',)).on_invoke(1, READ)\n"
        "assert t.on_return(1, ('read_ok', 'A'))._native_verdict() is True\n"
        "r = compiled_cpu_bfs(TwoPhaseSys(3), batch=64)\n"
        "assert (r['unique'], r['states']) == (288, 1146), r\n"
    ),
    # engine prewarm with a compile cache directory: the growth rung comes
    # from the prewarm thread
    "prewarm": (
        "import tempfile\n"
        "from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys\n"
        "c = TwoPhaseSys(3).checker().prewarm().compile_cache(\n"
        "    tempfile.mkdtemp()).telemetry().spawn_gpu(\n"
        "    device='cpu', capacity=1 << 10, batch=8, steps_per_call=1,\n"
        "    queue_capacity=1 << 12).join()\n"
        "assert c.unique_state_count() == 288, c.unique_state_count()\n"
        "ev = c.flight_recorder.records('compile')\n"
        "assert [e['source'] for e in ev] == ['fresh', 'prewarm'], ev\n"
    ),
    # telemetry: the recorder, cartography, the memory ledger, the report
    # and the run registry on the GPU engine and the host BFS
    "telemetry": (
        "import json, tempfile\n"
        "from stateright_tpu_torch.models.paxos import paxos_model\n"
        "from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys\n"
        "d = tempfile.mkdtemp()\n"
        "c = TwoPhaseSys(3).checker().report(d + '/r.json').runs(d).spawn_gpu(\n"
        "    device='cpu', batch=32, queue_capacity=64, steps_per_call=4)\n"
        "c = c.join()\n"
        "cart = c.cartography()\n"
        "assert sum(cart['depth_hist']) == 288, cart\n"
        "assert json.load(open(d + '/r.json'))['totals']['unique'] == 288\n"
        "assert c.memory()['total_bytes'] > 0\n"
        "assert c.flight_recorder.records('growth')\n"
        "p = paxos_model(1).checker().cartography().spawn_gpu(\n"
        "    device='cpu', batch=64).join()\n"
        "assert p.cartography()['fresh_inserts'] == 265\n"
        "b = TwoPhaseSys(3).checker().telemetry().spawn_bfs().join()\n"
        "assert b.flight_recorder.summary()['unique'] == 288\n"
    ),
}


def assert_isolated(case: str) -> None:
    """Run ``case`` in a subprocess on one thread: it passes, and neither
    ``jax`` nor ``stateright_tpu`` is loaded after it."""
    code = (
        "import sys\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        + case
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

    if name == "2pc-spill":
        return TwoPhaseSys(5), TwoPhaseTensor
    if name.startswith("2pc"):
        return TwoPhaseSys(3), TwoPhaseTensor
    if name == "raft-sym":
        return raft_model(3), CompiledActorTensor
    m = paxos_model(1)
    if name.startswith("per-channel"):
        m.per_channel_()
        return m, CompiledActorTensor
    return m, PaxosTensor


# unique states of each probed run; "-sym" runs under .symmetry(),
# "-flags" under .prededup().mxu(), "-cart" under .cartography() (its
# counters and the queue-derived depth histogram ride the block),
# "-checked" under .checked() (the guard's flags), "-spill" under .spill()
# with a device budget that evicts (the Bloom test and the pending append),
# "-armed" with a fault plan installed that never fires and autosave and
# the heartbeat at every sync, "-por" under .por() (the ample mask, its
# conjunct kernel, the proviso round and the rollback), "-served" with the
# metrics bus under a polled Explorer, "-prewarm" under .prewarm() with
# growth (the blocks after it run an engine the prewarm thread built)
SYNC_FREE_UNIQUE = {"2pc": 288, "paxos": 265, "per-channel": 265,
                    "per-channel-por": 250,
                    "2pc-sym": 94, "raft-sym": 2926, "2pc-flags": 288,
                    "paxos-flags": 265, "2pc-cart": 288, "paxos-cart": 265,
                    "2pc-checked": 288, "2pc-spill": 8832, "2pc-armed": 288,
                    "paxos-armed": 265, "2pc-served": 288,
                    "2pc-prewarm": 288}


def inert_plan():
    """A fault plan on every site that never fires: the seams run armed."""
    from stateright_tpu_torch.testing.faults import SITES, Fault, FaultPlan

    return FaultPlan([Fault(site=s, action="kill", at=10 ** 9)
                      for s in SITES])


def spill_budget(model, batch: int, bits: int) -> int:
    """A device budget under which a 2pc-5 run evicts at the 2^13 rung."""
    from stateright_tpu_torch.parallel.wavefront import memory_spec_fn
    from stateright_tpu_torch.telemetry.memory import total_bytes

    tm = model.tensor_model()
    spec = memory_spec_fn(tm, len(model.properties()), cuda=False,
                          spill=(bits, 4 * batch * tm.max_actions))

    def tot(cap):
        return total_bytes(spec(dict(cap=cap, qcap=4096, batch=batch,
                                     cand=4096)))

    return tot(1 << 13) + tot(1 << 14) - 1


@pytest.mark.parametrize("name", list(SYNC_FREE_UNIQUE))
def test_engine_blocks_dispatch_no_host_read(name, monkeypatch, tmp_path):
    """Every block of ``steps_per_call`` steps, post-stop no-ops included,
    runs under a ``TorchDispatchMode`` probe: no operation that reads a
    tensor on the host (``aten._local_scalar_dense`` and kin) is
    dispatched, for 2pc, ``PaxosTensor`` and a per-channel compiled twin,
    under symmetry for 2pc (``representative_rows``) and raft (the
    compiler's mechanical symmetry), and with ``.prededup().mxu()`` for 2pc
    and ``PaxosTensor`` (``window_unique``), and with ``.cartography()``
    for both (the counters, and the depth histogram's bounded search once
    a block), and with the fault seams armed by a plan that never fires
    and autosave and the heartbeat at every sync, and under ``.prewarm()``
    across a growth.  The host reads one packed stats tensor per block,
    outside the block."""
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
    if name.endswith("-cart"):
        b = b.cartography()
    if name.endswith("-checked"):
        b = b.checked()
    if name.endswith("-por"):
        b = b.por()
    kw = {}
    if name.endswith("-armed"):
        b = b.autosave(str(tmp_path), every_secs=0.0)
        monkeypatch.setattr("stateright_tpu_torch.testing.faults._ACTIVE",
                            inert_plan())
    if name.endswith("-spill"):
        b = b.spill()
        monkeypatch.setenv("STATERIGHT_TPU_DEVICE_BYTES",
                           str(spill_budget(m, 128, 1 << 14)))
        monkeypatch.setenv("STATERIGHT_TPU_CAPACITY_GUARD", "off")
        kw = dict(capacity=1 << 12, batch=128, queue_capacity=4096,
                  spill_bloom_bits=1 << 14)
    if name.endswith("-prewarm"):
        # growth, whose rungs the prewarm thread builds
        b = b.prewarm().telemetry()
        kw = dict(capacity=1 << 10, batch=8, queue_capacity=1 << 12)
    if name.endswith("-served"):
        c = served_and_polled(b.telemetry(metrics=True), steps_per_call=4)
    else:
        c = b.spawn_gpu(device="cpu", steps_per_call=4, **kw).join()
    assert (c.cartography() is not None) == name.endswith("-cart")
    assert c._prededup == name.endswith("-flags")
    assert c._checked == name.endswith("-checked")
    assert c._por == name.endswith("-por")
    assert (c._heartbeat is not None) == name.endswith("-armed")
    if c._prewarm:
        ev = c.flight_recorder.records("compile")
        assert c.growth_events and ev[-1]["source"] == "prewarm", ev
    if c._spill:
        # blocks ran after an eviction, with deferred candidates appended
        sp = c.spill_status()
        assert sp["evictions"] >= 1 and sp["deferred"] > 0
    assert c.unique_state_count() == SYNC_FREE_UNIQUE[name]
    assert len(blocks) > 2
    assert blocks == [[]] * len(blocks)


@pytest.mark.parametrize("name", ["seed-2pc", "lifted-cart"])
def test_sweep_blocks_dispatch_no_host_read(name, monkeypatch):
    """The sweep engine's blocks under the same probe: per-instance first
    hits, ``done_of``, the counters' ``index_add``, the namespace mode and
    the tag column, and a lifted cohort's ``vmap`` over the unified graph
    (with cartography's per-instance counters), read nothing on the host;
    the host reads one packed stats tensor per block, outside it."""
    from stateright_tpu_torch.models.two_phase_commit import sweep_family
    from stateright_tpu_torch.sweep import engine
    from stateright_tpu_torch.testing.sweep_fixtures import (
        bounded_counter_spec,
    )

    blocks = []
    run = engine._SweepEngine.run

    def probed(self, carry):
        probe = SyncProbe()
        with probe:
            out = run(self, carry)
        blocks.append(probe.hits)
        return out

    monkeypatch.setattr(engine._SweepEngine, "run", probed)
    if name == "seed-2pc":
        spec, kw, want = sweep_family(3), dict(batch=32), [288] * 3
        b = spec.instances[0].model.checker()
    else:
        spec, kw = bounded_counter_spec([2, 3, 4]), dict(batch=8)
        want = [9, 16, 25]
        b = spec.instances[0].model.checker().cartography()
    c = b.sweep(spec).spawn_gpu(device="cpu", steps_per_call=4, **kw).join()
    assert [r.unique for r in c.results.values()] == want
    assert len(blocks) > 2
    assert blocks == [[]] * len(blocks)


def served_and_polled(builder, **spawn_kw):
    """``builder``'s GPU run on the CPU under the Explorer, with a client
    polling ``/.status``, ``/.metrics`` and ``/metrics`` until it is done;
    returns the joined checker."""
    import urllib.request

    from stateright_tpu_torch.explorer import serve

    server = serve(builder, "localhost:0", block=False, strategy="gpu",
                   device="cpu", **spawn_kw)
    try:
        while True:
            done = server.checker.is_done()
            for path in ("/.status", "/.metrics", "/metrics"):
                urllib.request.urlopen(f"http://{server.addr}{path}").read()
            if done:
                return server.checker.join()
    finally:
        server.shutdown()


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
@pytest.mark.parametrize("explicit", [False, True, "checked", "spill",
                                      "armed", "por", "served", "mesh1",
                                      "prewarm"])
def test_step_flags_off_dispatch_the_same_operations(name, explicit,
                                                    monkeypatch, tmp_path):
    """With ``prededup`` off, unset or turned off explicitly against its
    env knob (and ``mxu``, which has no effect, likewise), on a one-piece
    mesh (``.mesh(devices=1)``, "mesh1"), and with
    ``checked(False)`` and ``spill(False)`` (the latter against its env
    knob), and with a fault plan installed that never fires and autosave
    and the heartbeat armed at every sync ("armed"), every step dispatches
    exactly the pinned operations: no pre-dedup, no guard, no Bloom test,
    no fault check, and no clone of the block per field write.  "served"
    runs with the metrics bus attached under the Explorer, whose every
    endpoint a client polls until the run is done: publication and live
    discoveries read only what the block's one stats read gave.
    "prewarm" runs with the prewarm thread up (``tests/
    test_torch_prewarm.py`` compares a run that grows onto prewarmed
    engines with the cold run, step for step)."""
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
    if explicit is True:
        monkeypatch.setenv("STATERIGHT_TPU_PREDEDUP", "1")
        monkeypatch.setenv("STATERIGHT_TPU_MXU", "1")
        b = b.prededup(False).mxu(False)
    elif explicit == "checked":
        b = b.checked(False)
    elif explicit == "spill":
        monkeypatch.setenv("STATERIGHT_TPU_SPILL", "1")
        b = b.spill(False)
    elif explicit == "por":
        monkeypatch.setenv("STATERIGHT_TPU_POR", "1")
        b = b.por(False)
    elif explicit == "armed":
        b = b.autosave(str(tmp_path), every_secs=0.0)
        monkeypatch.setattr("stateright_tpu_torch.testing.faults._ACTIVE",
                            inert_plan())
    elif explicit == "mesh1":
        # a one-piece mesh is the single-device program: the same step
        b = b.mesh(devices=1)
    elif explicit == "prewarm":
        b = b.prewarm()
    if explicit == "served":
        c = served_and_polled(b.telemetry(metrics=True), batch=64,
                              steps_per_call=4)
        assert c.flight_recorder.metrics_bus is not None
    else:
        c = b.spawn_gpu(device="cpu", batch=64, steps_per_call=4).join()
    assert not c._prededup and not c._checked and not c._spill
    assert not c._por and c.por_status() is None
    assert (c._heartbeat is not None) == (explicit == "armed")
    assert (c._engine_tag == "mesh") == (explicit == "mesh1")
    assert c._prewarm == (explicit == "prewarm")
    assert steps
    assert {sum(ops.values()) for ops in steps} <= FLAGS_OFF_OPS_PER_STEP[name]
    assert all("aten.clone.default" not in ops for ops in steps)


def test_por_fallback_dispatches_the_same_operations(monkeypatch):
    """A ``.por()`` run that falls back to full expansion (dining: an
    ``eventually`` property) dispatches, step for step, exactly the
    operations of the run without the flag, and reports the fallback."""
    from stateright_tpu_torch.models.dining import dining_model
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
    # one model, so one twin: the first run's first step builds the
    # twin's lazy constants, and the two compared runs find them built
    m = dining_model(3)
    runs = []
    for por in (False, False, True):
        steps.clear()
        b = m.checker()
        c = (b.por() if por else b).spawn_gpu(device="cpu", batch=64,
                                              steps_per_call=4).join()
        runs.append((c, list(steps)))
    _, (off, off_steps), (fb, fb_steps) = runs
    assert not fb._por
    st = fb.por_status()
    assert st["enabled"] is False and "eventually" in st["fallback"]
    assert off.por_status() is None
    assert (fb.unique_state_count(), fb.state_count()) == (
        off.unique_state_count(), off.state_count())
    assert fb_steps == off_steps

