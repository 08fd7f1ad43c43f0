"""Intra-window pre-dedup in the port (``CheckerBuilder.prededup()``,
``ops/buckets.window_unique``) against the JAX package, tolerance 0:
``window_unique`` on seeded numpy batches against the JAX function, and
engine runs with the flag on (``spawn_gpu(device="cpu")``, the plain
PyTorch path) against ``spawn_tpu(sync=True)`` with the flag on at the
same capacities: unique and state counts (duplicates included), growth
events, table bytes, queue rows ``[0, tail)``, discoveries and their
traces."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from fixtures_sweep import BoundedCounterSys as JaxCounterSys
from stateright_tpu.models.paxos import paxos_model as jax_paxos_model
from stateright_tpu.models.two_phase_commit import TwoPhaseSys as JaxSys
from stateright_tpu.ops import buckets as jb
from stateright_tpu_torch.models.paxos import paxos_model
from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
from stateright_tpu_torch.ops import buckets as tb
from test_torch_engine import CounterSys
from test_torch_symmetry import same_sym_run

EMPTY = np.uint64(0xFFFFFFFFFFFFFFFF)


def as_torch(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.uint64).view(np.int64))


def window_case(name, rng):
    if name == "duplicates":
        fps = rng.integers(1, 1 << 64, size=40, dtype=np.uint64)
        return fps[rng.integers(0, 40, size=512)]
    if name == "all-empty":
        return np.full(64, EMPTY, np.uint64)
    if name == "single-lane":
        return rng.integers(1, 1 << 64, size=1, dtype=np.uint64)
    if name == "single-empty-lane":
        return np.full(1, EMPTY, np.uint64)
    # EMPTY lanes mixed in, duplicates, and fingerprints on both sides of
    # the sign bit (unsigned order is not int64 order)
    fps = rng.integers(1, 1 << 64, size=300, dtype=np.uint64)
    fps[rng.random(300) < 0.3] = fps[rng.integers(0, 300, size=1)[0]]
    fps[::7] = np.uint64(1 << 63)
    fps[rng.random(300) < 0.25] = EMPTY
    return fps


@pytest.mark.parametrize("case", ["duplicates", "all-empty", "single-lane",
                                  "single-empty-lane", "mixed"])
@pytest.mark.parametrize("seed", [0, 1])
def test_window_unique_matches_jax(case, seed):
    fps = window_case(case, np.random.default_rng(seed))
    want = np.asarray(jb.window_unique(jnp.asarray(fps)))
    got = tb.window_unique(as_torch(fps)).numpy().view(np.uint64)
    np.testing.assert_array_equal(got, want)
    # the first occurrence of every fingerprint stays, all else is EMPTY
    seen, expect = set(), []
    for f in fps.tolist():
        expect.append(EMPTY if f in seen or f == EMPTY else np.uint64(f))
        seen.add(f)
    np.testing.assert_array_equal(got, np.asarray(expect, np.uint64))


def per_channel(m):
    m.per_channel_()
    return m


# name: (JAX model, port model, under symmetry, capacities, (unique, states))
RUNS = {
    "2pc5": (lambda: JaxSys(5), lambda: TwoPhaseSys(5), False,
             dict(capacity=1 << 14, batch=64), (8_832, 58_146)),
    "paxos1": (lambda: jax_paxos_model(1), lambda: paxos_model(1), False,
               dict(capacity=1 << 12, batch=64), (265, 482)),
    "per-channel-paxos1": (lambda: per_channel(jax_paxos_model(1)),
                           lambda: per_channel(paxos_model(1)), False,
                           dict(capacity=1 << 12, batch=64), (265, 482)),
    "2pc5-sym": (lambda: JaxSys(5), lambda: TwoPhaseSys(5), True,
                 dict(capacity=1 << 12, batch=64), (508, 3_174)),
}


def flagged_pair(spec, flags):
    """The JAX and the port engine on ``spec`` (a :data:`RUNS` entry) with
    the builder ``flags`` on."""
    jm, tm, sym, kw, _ = spec
    jb_, tb_ = jm().checker(), tm().checker()
    if sym:
        jb_, tb_ = jb_.symmetry(), tb_.symmetry()
    for f in flags:
        jb_, tb_ = getattr(jb_, f)(), getattr(tb_, f)()
    j = jb_.spawn_tpu(sync=True, capacity=kw["capacity"],
                      frontier_capacity=kw["batch"])
    t = tb_.spawn_gpu(device="cpu", **kw).join()
    return j, t


@pytest.mark.parametrize("name", list(RUNS))
def test_prededup_engine_matches_jax_engine(name):
    """The tables, queue rows, counts (duplicates included), growth events,
    discoveries and traces of a prededup run are the JAX prededup run's."""
    j, t = flagged_pair(RUNS[name], ("prededup",))
    assert t._prededup
    assert (t.unique_state_count(), t.state_count()) == RUNS[name][4]
    same_sym_run(t, j)


def test_prededup_state_count_keeps_duplicates():
    """The same run with and without the flag: the state count adds every
    generated state, and the tables and queue rows are equal at the same
    capacities."""
    on = TwoPhaseSys(4).checker().prededup().spawn_gpu(device="cpu", batch=64)
    off = TwoPhaseSys(4).checker().prededup(False).spawn_gpu(device="cpu",
                                                            batch=64)
    on, off = on.join(), off.join()
    assert not off._prededup
    assert (on.unique_state_count(), on.state_count()) == (
        off.unique_state_count(), off.state_count())
    a, b = on.final_snapshot(), off.final_snapshot()
    tail = int(a["tail"])
    assert tail == int(b["tail"]) > 0
    for k in ("table_fp", "table_parent"):
        np.testing.assert_array_equal(a[k], b[k])
    for k in ("q_rows", "q_fp", "q_ebits", "q_depth"):
        np.testing.assert_array_equal(a[k][:tail], b[k][:tail])


def test_prededup_candidate_budget_judges_unique_lanes():
    """Counters that commute regenerate each successor from several
    parents: at a budget of 6 lanes the prededup run overflows the budget
    no more often than the plain one, and matches the JAX prededup run's
    growth events, tables and queue."""
    kw = dict(batch=8, cand=6)
    j = JaxCounterSys(5, 3).checker().prededup().spawn_tpu(
        sync=True, frontier_capacity=8, cand=6)
    t = CounterSys(5, 3).checker().prededup().spawn_gpu(device="cpu", **kw)
    plain = CounterSys(5, 3).checker().spawn_gpu(device="cpu", **kw).join()
    t.join()
    assert t.unique_state_count() == plain.unique_state_count() == 6 ** 3
    assert t.state_count() == plain.state_count()
    full = [s for s, _ in t.growth_events].count(3)
    assert full <= [s for s, _ in plain.growth_events].count(3)
    same_sym_run(t, j)


def test_prededup_env_knob_and_explicit_off(monkeypatch):
    monkeypatch.setenv("STATERIGHT_TPU_PREDEDUP", "1")
    on = TwoPhaseSys(3).checker().spawn_gpu(device="cpu", batch=64)
    off = TwoPhaseSys(3).checker().prededup(False).spawn_gpu(device="cpu",
                                                            batch=64)
    assert on.join()._prededup and not off.join()._prededup
    assert on.unique_state_count() == off.unique_state_count() == 288
