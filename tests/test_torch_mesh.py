"""The port's mesh engine (``CheckerBuilder.mesh()``, ``parallel/mesh.py``
and ``parallel/partition.py``) on the plain PyTorch path, against the JAX
package's ``TpuChecker`` and ``MeshTpuChecker`` (the 8 virtual CPU
devices of ``tests/conftest.py``) and the port's own ``GpuChecker``,
tolerance 0: counts, verdicts, discovery traces, the final table bytes,
queue rows ``[0, tail)`` and snapshots, at 2, 4 and 8 pieces; then every
pin of ``tests/test_mesh.py`` on the port (kill and resume across both
packages, growth that comes back in pieces, ``mesh_stats``, the builder,
the env knob, the refusals, the rule guards), the step flags under the
mesh, and the no-host-read probe on a mesh block."""

import numpy as np
import pytest
import torch

from stateright_tpu.models import paxos as jpaxos
from stateright_tpu.models.two_phase_commit import TwoPhaseSys as JaxSys
from stateright_tpu.parallel.mesh import MeshTpuChecker
from stateright_tpu_torch.models import paxos
from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
from stateright_tpu_torch.ops.insert_commit import (
    QueueAppend, insert_commit_plain, insert_commit_window,
    insert_commit_window_plain,
)
from stateright_tpu_torch.parallel.mesh import MeshGpuChecker, Pieces
from stateright_tpu_torch.parallel.partition import (
    ENV_MESH, MESH_AXES, PIECES, WAVEFRONT_CARRY_RULES, build_mesh,
    match_partition_rules, replicated, resolve_mesh_flag,
    wavefront_carry_names,
)
from stateright_tpu_torch.parallel.wavefront import GpuChecker

TPC3_UNIQUE, TPC3_TOTAL = 288, 1146
PAXOS1_UNIQUE, PAXOS1_TOTAL = 265, 482
KW = dict(capacity=1 << 12, batch=256)
QUEUE_KEYS = ("q_rows", "q_fp", "q_ebits", "q_depth")
SNAP_KEYS = ("table_fp", "table_parent", "head", "tail", "unique", "scount",
             "disc", "maxdepth", "status", "cap", "qcap", "batch", "cand")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The port's runs here on one torch thread (their tensors are small;
    under several test workers the default pool oversubscribes the
    cores).  Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_mesh(model, d=None, builder=None, **kw):
    b = model.checker().mesh(devices=d)
    if builder is not None:
        b = builder(b)
    kw.setdefault("sync", True)
    return b.spawn_gpu(device="cpu", **kw)


def port_solo(model, builder=None, **kw):
    b = model.checker() if builder is None else builder(model.checker())
    return b.spawn_gpu(device="cpu", sync=True, **kw)


def snapshot_of(c) -> dict:
    """A finished run's snapshot: the port's, or the JAX engine's."""
    return c.final_snapshot() if hasattr(c, "final_snapshot") else (
        c.checkpoint())


def assert_same_run(a, b):
    """Counts, the snapshot's tables, cursors and counters, queue rows
    ``[0, tail)``, and the discoveries with their traces."""
    assert (a.unique_state_count(), a.state_count(), a.max_depth()) == (
        b.unique_state_count(), b.state_count(), b.max_depth())
    sa, sb = snapshot_of(a), snapshot_of(b)
    for k in SNAP_KEYS:
        np.testing.assert_array_equal(np.asarray(sa[k]), np.asarray(sb[k]),
                                      err_msg=k)
    tail = int(sa["tail"])
    for k in QUEUE_KEYS:
        np.testing.assert_array_equal(np.asarray(sa[k])[:tail],
                                      np.asarray(sb[k])[:tail], err_msg=k)
    da = [int(x) for x in np.asarray(a._results["disc"])]
    assert da == [int(x) for x in np.asarray(b._results["disc"])]
    for fp in da:
        if fp:
            assert a._trace(fp) == b._trace(fp)


def assert_in_pieces(c, d: int):
    """The finished run's table and queue are ``d`` pieces each."""
    fin = c._final_carry
    for i in range(6):
        assert isinstance(fin[i], Pieces) and len(fin[i].parts) == d, i


@pytest.fixture(scope="module")
def jax_2pc3():
    """JAX's single-device and mesh engines on 2pc-3 (8 devices)."""
    solo = JaxSys(3).checker().spawn_tpu(sync=True, **KW)
    mesh = JaxSys(3).checker().mesh().spawn_tpu(sync=True, **KW)
    assert isinstance(mesh, MeshTpuChecker) and mesh.n_devices == 8
    return solo, mesh


@pytest.mark.parametrize("d", [2, 4, 8])
def test_mesh_2pc3_matches_both_jax_engines_and_the_port(d, jax_2pc3):
    jsolo, jmesh = jax_2pc3
    m = port_mesh(TwoPhaseSys(3), d, **KW)
    assert isinstance(m, MeshGpuChecker) and m.n_devices == d
    assert_in_pieces(m, d)
    assert (m.unique_state_count(), m.state_count()) == (TPC3_UNIQUE,
                                                         TPC3_TOTAL)
    assert_same_run(m, jsolo)
    assert_same_run(m, jmesh)
    assert_same_run(m, port_solo(TwoPhaseSys(3), **KW))
    m.assert_properties()


def test_mesh_paxos1_matches_jax_and_the_port():
    j = jpaxos.paxos_model(1).checker().spawn_tpu(sync=True,
                                                  capacity=1 << 12, batch=64)
    model = paxos.paxos_model(1)
    m = port_mesh(model, 4, capacity=1 << 12, batch=64)
    assert (m.unique_state_count(), m.state_count()) == (PAXOS1_UNIQUE,
                                                         PAXOS1_TOTAL)
    assert_in_pieces(m, 4)
    assert_same_run(m, j)
    assert_same_run(m, port_solo(model, capacity=1 << 12, batch=64))
    m.assert_properties()


def test_mesh_per_channel_static_routing():
    """The per-channel layout (JAX's first queued unlock on the mesh):
    counts and traces equal the single-device run on the same encoding."""
    model = _pc_paxos1()
    m = port_mesh(model, 8, capacity=1 << 12, batch=64)
    assert (m.unique_state_count(), m.state_count()) == (PAXOS1_UNIQUE,
                                                         PAXOS1_TOTAL)
    assert_in_pieces(m, 8)
    assert_same_run(m, port_solo(model, capacity=1 << 12, batch=64))


def test_mesh_kill_resume_both_ways_and_the_cross_engine_refusal():
    """A stopped mesh run's snapshot says ``engine == "mesh"``; the port's
    and JAX's mesh engines each finish the other's with the uninterrupted
    run's totals and tables; the plain engines of both packages refuse
    it."""
    ref = port_solo(TwoPhaseSys(4), capacity=1 << 12, batch=64)
    c = TwoPhaseSys(4).checker().mesh(devices=4).spawn_gpu(
        device="cpu", capacity=1 << 12, batch=64, steps_per_call=2)
    snap = c.checkpoint()
    c.stop()
    c.join()
    assert snap["engine"] == "mesh"
    assert int(snap["unique"]) < 1568
    r = port_mesh(TwoPhaseSys(4), 4, resume=snap)
    assert_same_run(r, ref)
    j = JaxSys(4).checker().mesh().spawn_tpu(sync=True, resume=snap)
    assert (j.unique_state_count(), j.state_count()) == (
        ref.unique_state_count(), ref.state_count())
    np.testing.assert_array_equal(np.asarray(j._table_np()[0]),
                                  ref._table_np()[0])
    # JAX's mesh snapshot finishes in the port's mesh engine
    jpart = JaxSys(4).checker().mesh().target_states(500).spawn_tpu(
        sync=True, capacity=1 << 12, batch=64)
    jsnap = jpart.checkpoint()
    assert str(jsnap["engine"]) == "mesh"
    assert_same_run(port_mesh(TwoPhaseSys(4), 8, resume=jsnap), ref)
    with pytest.raises(ValueError, match="engine"):
        TwoPhaseSys(4).checker().spawn_gpu(device="cpu", sync=True,
                                           resume=snap)
    with pytest.raises(ValueError, match="engine"):
        JaxSys(4).checker().spawn_tpu(sync=True, resume=snap)


def test_mesh_growth_keeps_the_work_and_comes_back_in_pieces():
    m = port_mesh(TwoPhaseSys(4), 8, capacity=1 << 9, batch=128)
    assert len(m.growth_events) >= 1
    ref = port_solo(TwoPhaseSys(4), capacity=1 << 12, batch=128)
    assert (m.unique_state_count(), m.state_count()) == (
        ref.unique_state_count(), ref.state_count())
    assert_in_pieces(m, 8)
    assert all(p == ["cpu"] * 8 for p in m.pieces().values())
    # the same growth as the single-device engine at the same capacities
    small = port_solo(TwoPhaseSys(4), capacity=1 << 9, batch=128)
    assert m.growth_events == small.growth_events
    assert_same_run(m, small)


def test_mesh_stats_well_formed_equal_to_jax_and_in_results(jax_2pc3):
    m = port_mesh(TwoPhaseSys(3), 8, **KW)
    stats = m.mesh_stats()
    assert stats["devices"] == 8
    assert stats["axes"] == {"host": 1, "chip": 8}
    assert len(stats["shard_load"]) == 8
    assert sum(stats["shard_load"]) == TPC3_UNIQUE
    imb = stats["imbalance"]
    assert imb["max"] >= imb["mean"] > 0 and imb["ratio"] >= 1.0
    route = np.asarray(stats["route_matrix"])
    assert route.shape == (8, 8)
    assert route.sum() == stats["routed_states"] == TPC3_UNIQUE - 1
    assert m._results["mesh"] == stats
    assert stats == jax_2pc3[1].mesh_stats()


def test_mesh_stats_ride_the_cartography_block():
    m = port_mesh(TwoPhaseSys(3), 8, lambda b: b.cartography(), **KW)
    cart = m._results["cartography"]
    assert cart["shard_load"] == m.mesh_stats()["shard_load"]
    assert cart["route_matrix"] == m.mesh_stats()["route_matrix"]
    assert "ratio" in cart["shard_imbalance"]
    assert sum(cart["depth_hist"]) == TPC3_UNIQUE
    solo = port_solo(TwoPhaseSys(3), lambda b: b.cartography(), **KW)
    assert cart["depth_hist"] == solo.cartography()["depth_hist"]
    assert m.flight_recorder is None or m.flight_recorder.records("mesh")


# -- engine selection -----------------------------------------------------------


def test_builder_and_env_knob_select_the_mesh_engine(monkeypatch):
    monkeypatch.delenv(ENV_MESH, raising=False)
    c = TwoPhaseSys(3).checker().mesh().spawn_gpu(device="cpu", sync=True,
                                                  batch=64)
    assert isinstance(c, MeshGpuChecker) and c.n_devices == 8
    c2 = TwoPhaseSys(3).checker().mesh(devices=2).spawn_gpu(
        device="cpu", sync=True, batch=64)
    assert c2.n_devices == 2 and c2.unique_state_count() == TPC3_UNIQUE
    c3 = TwoPhaseSys(3).checker().mesh(devices=["cpu"] * 3).spawn_gpu(
        sync=True, batch=64)
    assert c3.n_devices == 3 and c3.unique_state_count() == TPC3_UNIQUE
    monkeypatch.setenv(ENV_MESH, "1")
    c4 = TwoPhaseSys(3).checker().spawn_gpu(device="cpu", sync=True,
                                            batch=64)
    assert isinstance(c4, MeshGpuChecker)
    assert c4.unique_state_count() == TPC3_UNIQUE
    # the builder beats the knob
    c5 = TwoPhaseSys(3).checker().mesh(False).spawn_gpu(device="cpu",
                                                        sync=True, batch=64)
    assert type(c5) is GpuChecker


def test_env_knob_values_and_the_malformed_warning(monkeypatch, capsys):
    monkeypatch.setenv(ENV_MESH, "1")
    assert resolve_mesh_flag(None, None) == (True, None)
    monkeypatch.setenv(ENV_MESH, "4")
    assert resolve_mesh_flag(None, None) == (True, 4)
    monkeypatch.setenv(ENV_MESH, "0")
    assert resolve_mesh_flag(None, None) == (False, None)
    monkeypatch.setenv(ENV_MESH, "1")
    assert resolve_mesh_flag(False, None) == (False, None)
    monkeypatch.setenv(ENV_MESH, "0")
    assert resolve_mesh_flag(True, 2) == (True, 2)
    monkeypatch.setenv(ENV_MESH, "yes")
    assert resolve_mesh_flag(None, None) == (False, None)
    assert "malformed" in capsys.readouterr().err


def test_old_spelling_stays_the_sharded_engine(monkeypatch):
    import stateright_tpu_torch.parallel.sharded as sharded_mod

    calls = []

    class Sentinel:
        def __init__(self, options, **kw):
            calls.append(kw)
            raise RuntimeError("sentinel-constructed")

    monkeypatch.setattr(sharded_mod, "ShardedGpuChecker", Sentinel)
    monkeypatch.setenv(ENV_MESH, "1")
    with pytest.raises(RuntimeError, match="sentinel"):
        TwoPhaseSys(3).checker().spawn_gpu(device="cpu", sync=True,
                                           devices=2)
    assert calls and calls[0].get("n_devices") == 2


def test_refusals_sweep_spill_multi_rank_and_oversized(monkeypatch):
    from stateright_tpu_torch.models.two_phase_commit import sweep_family
    from stateright_tpu_torch.parallel import sharded

    with pytest.raises(NotImplementedError, match="sweep x mesh"):
        TwoPhaseSys(3).checker().sweep(sweep_family(2)).mesh().spawn_gpu(
            device="cpu", sync=True)
    with pytest.raises(NotImplementedError, match="spill mode"):
        TwoPhaseSys(3).checker().mesh().spill().spawn_gpu(device="cpu",
                                                          sync=True)
    monkeypatch.setattr(sharded, "controllers", lambda: 2)
    with pytest.raises(NotImplementedError, match="single-controller"):
        TwoPhaseSys(3).checker().mesh().spawn_gpu(device="cpu", sync=True)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_mesh()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="visible"):
        build_mesh(n_devices=99)


def test_engine_key_never_collides():
    solo = port_solo(TwoPhaseSys(3), batch=64)
    mesh = port_mesh(TwoPhaseSys(3), None, batch=64)
    k_solo = solo._engine_key(solo._cap, solo._qcap, solo._batch, solo._cand)
    k_mesh = mesh._engine_key(mesh._cap, mesh._qcap, mesh._batch, mesh._cand)
    assert k_mesh[:-1] == k_solo
    assert k_mesh[-1] == ("mesh",) + ("cpu",) * 8
    sub = port_mesh(TwoPhaseSys(3), 2, batch=64)
    k_sub = sub._engine_key(sub._cap, sub._qcap, sub._batch, sub._cand)
    assert k_sub[-1] == ("mesh", "cpu", "cpu")
    assert len({k_solo, k_mesh, k_sub}) == 3


# -- partition rules ------------------------------------------------------------


def test_match_partition_rules_guards():
    mesh = build_mesh(device="cpu")  # 1 x 8 pieces
    names = ("table_fp", "q_rows", "head", "odd_dim")
    shapes = ((1 << 12,), (640, 3), (), (13,))
    rules = WAVEFRONT_CARRY_RULES + ((r"odd_dim", PIECES),)
    s = match_partition_rules(rules, names, shapes, mesh)
    assert s[0].spec == (MESH_AXES,) and s[0].pieces
    assert s[1].spec == (MESH_AXES,) and s[1].pieces
    assert s[2].spec == () and not s[2].pieces
    # the divisibility guard keeps the dimension whole
    assert all(ax is None for ax in s[3].spec) and not s[3].pieces
    with pytest.raises(ValueError, match="no partition rule"):
        match_partition_rules(((r"^table_", PIECES),), ("stray",), ((8,),),
                              mesh)
    assert replicated(mesh).spec == () and not replicated(mesh).pieces


def test_wavefront_carry_names_flag_guards():
    base = wavefront_carry_names(13)
    assert base[0] == "table_fp" and base[12] == "status"
    with_err = wavefront_carry_names(16, checked=True)
    assert with_err[13] == "err" and with_err[14] == "cart_0"
    with pytest.raises(ValueError, match="carry has"):
        wavefront_carry_names(13, checked=True, por=True)


@pytest.mark.parametrize("batch", [64, 80])
def test_sizes_the_mesh_does_not_divide_stay_whole(batch):
    """Three pieces never divide a power-of-two table: it stays whole on
    the lead device, while the queue is in pieces exactly when three
    divide its rows; either way the run is the plain run."""
    m = port_mesh(TwoPhaseSys(3), 3, batch=batch)
    eng = m._last_engine
    pieces = m.pieces()
    assert pieces["table_fp"] == ["cpu"] and not eng.tpieces
    assert len(pieces["q_rows"]) == (3 if eng.qalloc % 3 == 0 else 1)
    assert eng.meshed == (eng.qalloc % 3 == 0)
    assert_same_run(m, port_solo(TwoPhaseSys(3), batch=batch))


# -- the step flags under the mesh ----------------------------------------------


def _pc_paxos1():
    m = paxos.paxos_model(1)
    m.per_channel_()
    return m


@pytest.mark.parametrize("case", ["2pc5-sym", "2pc4-sym-prededup",
                                  "paxos1-prededup", "pc-paxos1-por",
                                  "2pc3-checked"])
def test_step_flags_under_the_mesh_equal_the_plain_engine(case):
    flags = {"sym": lambda b: b.symmetry(),
             "prededup": lambda b: b.prededup(), "por": lambda b: b.por(),
             "checked": lambda b: b.checked()}
    name, *fl = case.split("-")
    if name == "pc":
        fl = fl[1:]

    def builder(b):
        for f in fl:
            b = flags[f](b)
        return b

    mk = {"2pc5": lambda: TwoPhaseSys(5), "2pc4": lambda: TwoPhaseSys(4),
          "2pc3": lambda: TwoPhaseSys(3),
          "paxos1": lambda: paxos.paxos_model(1), "pc": _pc_paxos1}[name]
    kw = dict(capacity=1 << 12, batch=64)
    model = mk()  # one model: both runs share its twin and its analyses
    m = port_mesh(model, 4, builder, **kw)
    p = port_solo(model, builder, **kw)
    assert_in_pieces(m, 4)
    assert_same_run(m, p)
    if "por" in fl:
        assert m.por_status() == p.por_status()
        assert m.unique_state_count() == 250
    if "prededup" in fl:
        assert m.prededup_removed() == p.prededup_removed() > 0
    if case == "2pc5-sym":
        assert m.unique_state_count() == 508


def test_mesh_blocks_dispatch_no_host_read(monkeypatch):
    """Every mesh block (pop from the queue pieces, the per-piece plans
    and commits, the merge and the window appends, cartography's depth
    gather) runs under the no-host-read probe."""
    from stateright_tpu_torch.parallel import wavefront
    from test_torch_engine import SyncProbe

    blocks = []
    run = wavefront._Engine.run

    def probed(self, carry):
        probe = SyncProbe()
        with probe:
            out = run(self, carry)
        blocks.append(probe.hits)
        return out

    monkeypatch.setattr(wavefront._Engine, "run", probed)
    for b in (TwoPhaseSys(3).checker().cartography(),
              _pc_paxos1().checker().por()):
        c = b.mesh(devices=4).spawn_gpu(device="cpu", sync=True, batch=64,
                                        steps_per_call=4)
        assert c._last_engine.meshed
    assert len(blocks) > 4
    assert blocks == [[]] * len(blocks)


# -- the window mode --------------------------------------------------------------


@pytest.mark.parametrize("d", [1, 2, 4])
def test_window_appends_equal_the_whole_queue_append(d):
    """The queue append of ``insert_commit`` into a queue held in ``d``
    row pieces, one window launch per piece, writes exactly the rows the
    whole-queue append writes, across piece boundaries."""
    g = torch.Generator().manual_seed(7)
    q, w, arity, b = 64, 3, 4, 16
    m = b * arity
    n_new = torch.tensor(37)
    tail = torch.tensor(20)
    sel = torch.randperm(m, generator=g)
    cfp = torch.randint(-2 ** 62, 2 ** 62, (m,), generator=g)
    rows = torch.randint(-2 ** 62, 2 ** 62, (m, w), generator=g)
    pe = torch.randint(0, 1 << 20, (b,), generator=g, dtype=torch.int32)
    pd = torch.randint(0, 50, (b,), generator=g, dtype=torch.int32)

    def fresh():
        return (torch.zeros(q, w, dtype=torch.int64),
                torch.full((q,), -1, dtype=torch.int64),
                torch.zeros(q, dtype=torch.int32),
                torch.zeros(q, dtype=torch.int32))

    tfp, tpl = torch.full((8,), -1), torch.zeros(8, dtype=torch.int64)
    want = fresh()
    full = QueueAppend(*want, tail, sel, rows, pe, pd, arity)
    insert_commit_plain(tfp, tpl, torch.zeros(m, dtype=torch.int64), cfp,
                        torch.zeros(m, dtype=torch.int64), n_new, full)
    got = [Pieces.split(t, ["cpu"] * d) for t in fresh()]
    for k in range(d):
        qa = QueueAppend(*(p.parts[k] for p in got), tail, sel, rows, pe, pd,
                         arity)
        insert_commit_window(qa, cfp, n_new, k * (q // d))
    for a, p in zip(want, got):
        torch.testing.assert_close(p.whole("cpu"), a, rtol=0, atol=0)
    # a plain call of one piece writes only its own window
    one = fresh()
    insert_commit_window_plain(QueueAppend(*one, tail, sel, rows, pe, pd,
                                           arity), cfp, n_new, 0)
    torch.testing.assert_close(one[1], want[1], rtol=0, atol=0)
