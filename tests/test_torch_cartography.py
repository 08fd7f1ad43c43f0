"""Search cartography in the port (``ops/cartography.py`` and the GPU
engine's counters) against the JAX engine, tolerance 0:

 - the cartography block (depth, action and property tallies, fresh and
   duplicate counts), the growth records' ``(status, unique, cap)``
   sequence and the count-derived health timeline
   (``telemetry/health.phase_timeline``) equal the JAX engine's at the same
   capacities and ``steps_per_call``, for 2pc-3 with a queue that forces
   growth, dining-3, paxos-1 (``PaxosTensor``), a compiled twin
   (single-copy) and 2pc-5 under symmetry;
 - the reconciliation invariants hold across growth replays;
 - snapshots carry the depth bank (``cart_depth_base``) both ways: a run
   resumed from either engine's snapshot keeps ``sum(depth_hist) ==
   unique``;
 - with cartography on, a step adds only its few reductions.

Each JAX model is built once for the module, so each compiles once.
"""

import functools

import numpy as np
import pytest

from stateright_tpu.models.dining import dining_model as jax_dining
from stateright_tpu.models.paxos import paxos_model as jax_paxos
from stateright_tpu.models.single_copy_register import (
    single_copy_model as jax_single_copy,
)
from stateright_tpu.models.two_phase_commit import TwoPhaseSys as JaxSys
from stateright_tpu.telemetry.health import phase_timeline as jax_timeline
from stateright_tpu_torch.models.dining import dining_model
from stateright_tpu_torch.models.paxos import paxos_model
from stateright_tpu_torch.models.single_copy_register import single_copy_model
from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
from stateright_tpu_torch.ops import cartography as cart
from stateright_tpu_torch.telemetry.health import phase_timeline

# name -> (port model, JAX model, builder tweak, spawn kwargs)
CASES = {
    "2pc-3-growth": (lambda: TwoPhaseSys(3), lambda: JaxSys(3), None,
                     dict(batch=32, queue_capacity=64, capacity=1 << 12,
                          steps_per_call=4)),
    "dining-3": (lambda: dining_model(3), lambda: jax_dining(3), None,
                 dict(batch=64, capacity=1 << 12, steps_per_call=4)),
    "paxos-1": (lambda: paxos_model(1), lambda: jax_paxos(1), None,
                dict(batch=64, capacity=1 << 12, steps_per_call=8)),
    "single-copy-2": (lambda: single_copy_model(2), lambda: jax_single_copy(2),
                      None, dict(batch=32, capacity=1 << 10,
                                 steps_per_call=4)),
    "2pc-5-sym": (lambda: TwoPhaseSys(5), lambda: JaxSys(5),
                  lambda b: b.symmetry(),
                  dict(batch=64, capacity=1 << 10, steps_per_call=4)),
}


@functools.lru_cache(maxsize=None)
def jax_model(name):
    return CASES[name][1]()


@functools.lru_cache(maxsize=None)
def jax_run(name):
    _, _, tweak, kw = CASES[name]
    b = jax_model(name).checker().telemetry(cartography=True)
    if tweak is not None:
        b = tweak(b)
    kw = dict(kw)
    kw["frontier_capacity"] = kw.pop("batch")
    return b.spawn_tpu(sync=True, **kw)


def port_run(name, resume=None):
    make, _, tweak, kw = CASES[name]
    b = make().checker().telemetry(cartography=True)
    if tweak is not None:
        b = tweak(b)
    return b.spawn_gpu(device="cpu", resume=resume, **kw).join()


def growth_ladder(checker):
    return [(r["status"], r["unique"], r["cap"])
            for r in checker.flight_recorder.records("growth")]


def reconcile(c, n_init=1, early_exit=False):
    block = c.cartography()
    states, unique = c.state_count(), c.unique_state_count()
    assert sum(block["depth_hist"]) == unique == block["fresh_inserts"]
    assert block["duplicate_hits"] == states - unique
    assert sum(block["action_hist"]) == states - n_init
    for p in block["props"]:
        if early_exit:
            assert 0 < p["evaluated"] <= unique
        else:
            assert p["evaluated"] == unique
    return block


@pytest.mark.parametrize("name", list(CASES))
def test_cartography_growth_and_timeline_equal_jax(name):
    j, t = jax_run(name), port_run(name)
    assert t.unique_state_count() == j.unique_state_count()
    assert t.state_count() == j.state_count()
    assert t.cartography() == j.cartography()
    assert growth_ladder(t) == growth_ladder(j)
    assert (phase_timeline(t.flight_recorder.records("step"))
            == jax_timeline(j.flight_recorder.records("step")))
    # the growth-boundary cartography series, and its closing record
    series = t.flight_recorder.records("cartography")
    assert series[-1]["at"] == "final"
    assert len(series) == len(growth_ladder(t)) + 1
    for snap in series:
        assert sum(snap["depth_hist"]) == snap["fresh_inserts"]
    if name == "2pc-3-growth":
        assert growth_ladder(t), "qcap=64 must grow"
        block = reconcile(t)
        assert block["depth_hist"][0] == 1 and len(block["depth_hist"]) == 11
        assert block["props"][2]["condition_hits"] == 288
    if name == "dining-3":
        reconcile(t, early_exit=True)


def test_growth_replay_never_double_counts():
    """2pc-4 from a 64-lane candidate budget: each budget overflow replays
    its batch after the doubling, and the counters come out exact."""
    c = (TwoPhaseSys(4).checker().telemetry(cartography=True)
         .spawn_gpu(device="cpu", capacity=1 << 10, batch=64, cand=64,
                    steps_per_call=4).join())
    assert c.unique_state_count() == 1_568
    assert "cand_full" in {g["status"] for g in
                           c.flight_recorder.records("growth")}
    reconcile(c)


def test_snapshots_carry_the_depth_bank_both_ways():
    """A snapshot taken after growth carries ``cart_depth_base``; a run
    resumed from it, on either engine, from either engine's snapshot,
    keeps ``sum(depth_hist) == unique`` and the uninterrupted run's
    block."""
    name = "2pc-3-growth"
    full = port_run(name).cartography()
    # a stopped port run, mid-search after its first growth
    kw = dict(CASES[name][3])
    t = (TwoPhaseSys(3).checker().telemetry(cartography=True)
         .target_states(100).spawn_gpu(device="cpu", **kw).join())
    snap = t.checkpoint()
    assert int(np.asarray(snap["cart_depth_base"]).sum()) > 0
    assert int(snap["unique"]) < 288
    for resumed in (
        port_run(name, resume=snap),
        jax_model(name).checker().telemetry(cartography=True)
        .spawn_tpu(sync=True, resume=snap),
    ):
        assert resumed.unique_state_count() == 288
        assert resumed.cartography()["depth_hist"] == full["depth_hist"]
    # the JAX engine's snapshot resumes in the port
    jkw = dict(kw)
    jkw["frontier_capacity"] = jkw.pop("batch")
    js = (jax_model(name).checker().telemetry(cartography=True)
          .target_states(100).spawn_tpu(sync=True, **jkw).checkpoint())
    assert "cart_depth_base" in js
    r = port_run(name, resume=js)
    assert r.unique_state_count() == 288
    assert r.cartography()["depth_hist"] == full["depth_hist"]


def test_queue_depth_hist_is_the_jax_search():
    """The device histogram is the JAX package's bounded binary search,
    lane for lane, also on an unsorted queue past ``tail`` and where an
    append window straddles two levels; the exact one is a bincount."""
    import jax.numpy as jnp
    import torch

    from stateright_tpu.ops import cartography as jcart

    rng = np.random.default_rng(7)
    depth = np.sort(rng.integers(0, 140, 300)).astype(np.int32)
    depth[100:110] = depth[100:110][::-1]  # a straddling window
    depth[250:] = rng.integers(0, 9, 50)  # past tail: never read
    for tail in (0, 1, 57, 250, 300):
        ours = cart.queue_depth_hist(torch.from_numpy(depth),
                                     torch.tensor(tail))
        theirs = jcart.queue_depth_hist(jnp.asarray(depth.view(np.uint32)),
                                        jnp.int32(tail))
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
        exact = cart.queue_depth_hist_exact(torch.from_numpy(depth),
                                            torch.tensor(tail))
        np.testing.assert_array_equal(
            exact.numpy(), jcart.queue_depth_hist_np(depth, tail))


def test_cartography_adds_a_few_operations_a_step(monkeypatch):
    """On, a step adds its column sums and guarded adds, and no scatter;
    off, it adds nothing (pinned by ``test_torch_engine``)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from stateright_tpu_torch.parallel import wavefront

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func))
            return func(*args, **(kwargs or {}))

    per_step = {}
    step = wavefront._Engine.step

    def counted(self, c):
        probe = Count()
        with probe:
            out = step(self, c)
        per_step.setdefault(self.cart, []).append(probe.ops)
        return out

    monkeypatch.setattr(wavefront._Engine, "step", counted)
    for on in (False, True):
        TwoPhaseSys(3).checker().cartography(on).spawn_gpu(
            device="cpu", batch=64, steps_per_call=4).join()
    off = {len(ops) for ops in per_step[False]}
    on = {len(ops) for ops in per_step[True]}
    assert len(off) == len(on) == 1
    assert 0 < on.pop() - off.pop() <= 16
    assert not any("scatter" in op for ops in per_step[True] for op in ops)
