"""The sharded engine's flags against the JAX ``ShardedTpuChecker``,
tolerance 0 (``test_torch_sharded.py``'s comparison: the snapshot key for
key, growth events, discoveries and traces, cartography and the POR
tallies):

 - growth of every kind the step raises (table, frontier, candidate
   budget) under ``.cartography()``, with the per-shard load, the route
   matrix and the imbalance summary (2pc-3 over 4 shards);
 - ``.symmetry().prededup()`` (the generation-order plan, the per-shard
   window) over 2 shards;
 - ``.por()`` over 2 shards on ``ToggleSys`` (one proviso re-expansion).
   The JAX sharded POR crashes on this jax (``analysis/footprint.py:1102``)
   and the single-device tests' evaluator (``test_torch_footprint.py::
   jax_conjunct_eval_fn``) cannot run inside ``shard_map`` (its
   ``eval_jaxpr`` mixes varying and replicated operands), so it runs here
   on the host through ``jax.pure_callback``.

Then, on the port alone: the route's bucket overflow and send layout
against a numpy statement of JAX's ``route``; per-channel paxos-1 under
POR at the JAX run's numbers; the refusals (``.checked()``, ``.spill()``,
a sweep, ``timeout()`` under several controllers) with JAX's words; the
memory model against JAX's ``sharded_specs``; the cost model."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stateright_tpu.analysis.footprint as jfp
from fixtures_por import ToggleSys as JaxToggle
from stateright_tpu.models.two_phase_commit import TwoPhaseSys as JaxSys
from stateright_tpu.telemetry import memory as jmemory
from stateright_tpu_torch.models import paxos
from stateright_tpu_torch.models.two_phase_commit import (
    TwoPhaseSys,
    sweep_family,
)
from stateright_tpu_torch.parallel import sharded
from stateright_tpu_torch.telemetry import memory
from stateright_tpu_torch.testing.por_fixtures import ToggleSys
from test_torch_footprint import jax_conjunct_eval_fn, per_channel
from test_torch_sharded import (  # noqa: F401
    assert_same_sharded,
    jax_sharded,
    one_thread,
    port_sharded,
)


def host_conjunct_eval_fn(tensor):
    """``jax_conjunct_eval_fn`` run on the host from inside the sharded
    program: ``fn(rows)`` gives the same leaf arrays."""
    inner = jax_conjunct_eval_fn(tensor)
    if inner is None:
        return None

    def fn(rows):
        shapes = jax.eval_shape(inner, jax.ShapeDtypeStruct(rows.shape,
                                                            rows.dtype))
        if shapes is None:
            return None
        return list(jax.pure_callback(
            lambda r: [np.asarray(x) for x in inner(jnp.asarray(r))],
            shapes, rows))

    return fn


CASES = {
    # name: (JAX model, port model, builder, devices, capacities)
    "growth-cart": (lambda: JaxSys(3), lambda: TwoPhaseSys(3),
                    lambda b: b.cartography(), 4,
                    dict(capacity=1 << 8, frontier_capacity=1 << 5)),
    "sym-prededup": (lambda: JaxSys(4), lambda: TwoPhaseSys(4),
                     lambda b: b.symmetry().prededup(), 2, {}),
    "por-toggle": (JaxToggle, ToggleSys, lambda b: b.por(), 2, {}),
}


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_flags_match_jax_engine(name, monkeypatch):
    jm, tm, build, n, kw = CASES[name]
    monkeypatch.setattr(jfp, "conjunct_eval_fn", host_conjunct_eval_fn)
    j = jax_sharded(jm(), n, build, **kw)
    t = port_sharded(tm(), n, build, **kw)
    assert_same_sharded(j, t)
    if name == "growth-cart":
        assert {s for s, _ in t.growth_events} == {1, 2, 4}
        cart = t.cartography()
        assert sum(cart["depth_hist"]) == sum(cart["shard_load"]) == 288
        assert len(cart["route_matrix"]) == 4
        assert cart["shard_imbalance"]["ratio"] >= 1.0
        assert t.flight_recorder.records("growth")
    elif name == "sym-prededup":
        assert t.unique_state_count() == 267  # the JAX run's, at N = 2
    else:
        st = t.por_status()
        assert (st["rows_reduced"], st["rows_full_proviso"]) == (1, 1)


def test_per_channel_paxos1_por_at_the_jax_numbers():
    """Per-channel paxos-1 under POR over 4 shards: the JAX sharded run at
    these capacities (through the host evaluator) gives 245 / 429 with 17
    rows reduced, 20 proviso re-expansions and 17 candidates masked."""
    t = port_sharded(per_channel(paxos.paxos_model(1)), 4,
                     lambda b: b.por(), capacity=1 << 12,
                     frontier_capacity=1 << 8)
    assert (t.unique_state_count(), t.state_count()) == (245, 429)
    st = t.por_status()
    assert (st["rows_reduced"], st["rows_full_proviso"],
            st["candidates_masked"]) == (17, 20, 17)


def jax_route(cand, ndev, bc):
    """JAX ``route`` (sharded.py:235-275) for one source shard, in numpy:
    the ``[ndev, bc]`` send buffer of fingerprints and the overflow."""
    valid = cand != np.uint64(2 ** 64 - 1)
    owner = ((cand >> np.uint64(32)) % np.uint64(ndev)).astype(np.int64)
    key = np.where(valid, owner, ndev)
    order = np.argsort(key, kind="stable")
    so = key[order]
    starts = np.searchsorted(so, np.arange(ndev))
    rank = np.arange(cand.size) - starts[np.clip(so, 0, ndev - 1)]
    ok = (so < ndev) & (rank < bc)
    send = np.full((ndev + 1, bc), np.uint64(2 ** 64 - 1))
    d = np.where(ok, so, ndev)
    send[d, np.where(ok, rank, 0)] = cand[order]
    return send[:ndev], bool(((so < ndev) & (rank >= bc)).any())


@pytest.mark.parametrize("bc", [64, 8])
def test_route_matches_jax_route(bc):
    """Each source shard's send buffer and overflow flag, for candidates
    whose fingerprints have the top bit set (``lshr``, not ``>>``, picks
    the owner) and a bucket small enough to overflow; a dropped lane goes
    to the scratch row, never into a buffer."""
    ndev, lanes = 4, 96
    rng = np.random.default_rng(7)
    cand = rng.integers(0, 2 ** 64, size=(ndev, lanes), dtype=np.uint64)
    cand |= np.uint64(1 << 63)
    cand[:, ::5] = np.uint64(2 ** 64 - 1)
    eng = sharded._ShardedEngine.__new__(sharded._ShardedEngine)
    eng.ndev, eng.L, eng.bc, eng.m, eng.width = ndev, ndev, bc, lanes, 0
    eng.S, eng.device = ndev * ndev * bc, torch.device("cpu")
    eng.xch = sharded.Exchange(ndev)
    eng.lanes_m = torch.arange(lanes)
    eng.dest_ids = torch.arange(ndev).expand(ndev, ndev).contiguous()
    eng.src_off = torch.arange(ndev)[:, None] * bc
    t = torch.from_numpy(cand.view(np.int64))
    recv, sidx, bovf, _ = eng.route(t, t.reshape(-1, 1).expand(-1, 3))
    got = recv[..., 0].numpy().view(np.uint64).reshape(ndev, ndev, bc)
    flags = []
    for s in range(ndev):
        want, ovf = jax_route(cand[s], ndev, bc)
        flags.append(ovf)
        # the owner d's receive buffer holds source s's lanes at [d, s]
        np.testing.assert_array_equal(got[:, s], want)
    assert bool(bovf) == any(flags) == (bc == 8)
    # empty and dropped lanes alike
    assert int((sidx == eng.S).sum()) == cand.size - int(
        (got != np.uint64(2 ** 64 - 1)).sum())


def test_refusals_speak_jax_words(monkeypatch, tmp_path):
    m = TwoPhaseSys(3)
    with pytest.raises(NotImplementedError, match="checked mode"):
        m.checker().checked().spawn_gpu(devices=2, device="cpu")
    with pytest.raises(NotImplementedError, match="spill mode"):
        m.checker().spill().spawn_gpu(devices=2, device="cpu")
    with pytest.raises(NotImplementedError, match="single-device engine"):
        m.checker().sweep(sweep_family(2)).spawn_gpu(devices=2,
                                                     device="cpu")
    monkeypatch.setattr(sharded, "controllers", lambda: 2)
    with pytest.raises(NotImplementedError, match="timeout"):
        m.checker().timeout(60.0).spawn_gpu(devices=2, device="cpu")
    snap = port_sharded(TwoPhaseSys(3), 2).final_snapshot()
    with pytest.raises(NotImplementedError, match="resume="):
        m.checker().spawn_gpu(devices=2, device="cpu", resume=snap)


def test_no_card_and_no_device_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TwoPhaseSys(3).checker().spawn_gpu(devices=8)


@pytest.mark.parametrize("cart,por", [(False, False), (True, True)])
def test_memory_model_is_jax_sharded_specs(cart, por):
    """Names, shapes and dtypes of JAX's model, so a snapshot's
    ``footprint_bytes`` is the same in either package."""
    args = (9, 14, 2, 8, 1 << 10, 1 << 7)
    a = memory.sharded_specs(*args, cartography=cart, por=por)
    b = jmemory.sharded_specs(*args, cartography=cart, por=por)
    assert [(s.name, s.shape, np.dtype(s.dtype)) for s in a] == [
        (s.name, s.shape, np.dtype(s.dtype)) for s in b]


def test_memory_ledger_and_cost_model_on_the_sharded_engine():
    c = TwoPhaseSys(3).checker().telemetry(memory=True, roofline=True).spawn_gpu(
        devices=4, device="cpu", sync=True)
    assert c.memory()["total_bytes"] == int(
        c.final_snapshot()["footprint_bytes"])
    block = c.roofline(live=False)
    assert block["engine"] == "sharded" and block["devices"] == 4
    assert {"property", "expand", "hash", "route",
            "dedup-insert"} <= set(block["stages"])
    rec = c.flight_recorder
    assert rec.records("step") and all(
        r["engine"] == "sharded" and "busy" in r for r in rec.records("step"))
