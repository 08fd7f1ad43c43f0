"""The coalesced ``FieldWriter`` in the port, and ``CheckerBuilder.mxu()``
as the port keeps it (accepted, without effect), against the JAX package,
tolerance 0:

 - the port's ``FieldWriter`` (the JAX coalesced mode, the port's only
   one) against both JAX modes on seeded write sequences, ``get`` after
   ``or_field`` included, and without a write into the ``expand()`` view
   it reads;
 - every twin's ``step_rows`` against the JAX twin's (eager writer) on
   every reachable row (2pc-3, the hand-written paxos-1, per-channel
   paxos-1, the compiled slot-multiset single-copy, raft-3 in both
   packings with its timers, and ORL with its drops);
 - engine runs with ``.mxu()`` and ``.prededup().mxu()`` against the JAX
   engine with the same flags: counts, growth, tables, queue rows
   ``[0, tail)``, discoveries and traces;
 - ``.mxu()``, any of its keywords and ``STATERIGHT_TPU_MXU=1`` leave every
   step's dispatched operations as they are;
 - the ``--mxu`` and ``--prededup`` flags of the GPU verbs.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from stateright_tpu.models.paxos import paxos_model as jax_paxos_model
from stateright_tpu.models.raft import raft_model as jax_raft_model
from stateright_tpu.models.single_copy_register import (
    single_copy_model as jax_single_copy_model,
)
from stateright_tpu.models.two_phase_commit import TwoPhaseSys as JaxSys
from stateright_tpu.parallel import tensor_model as jtm
from stateright_tpu_torch.checker.base import CheckerBuilder
from stateright_tpu_torch.models import two_phase_commit
from stateright_tpu_torch.models.orl import orl_model
from stateright_tpu_torch.models.paxos import paxos_model
from stateright_tpu_torch.models.raft import raft_model
from stateright_tpu_torch.models.single_copy_register import single_copy_model
from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
from stateright_tpu_torch.parallel import tensor_model as ttm
from test_orl_compile import _orl_model as jax_orl_model
from test_torch_engine import OpCount
from test_torch_gpu import assert_same_snapshot
from test_torch_prededup import RUNS, flagged_pair, per_channel
from test_torch_symmetry import same_sym_run

FIELDS = [("a", 3), ("b", 5), ("p", 1), ("c", 40), ("d", 30), ("e", 64),
          ("f", 7)]


def write_program(seed, n_ops=24):
    """A seeded list of writes: ``(op, field, value spec)``; values are
    uint64 arrays of shape ``[B, A]`` or ``[B, 1]`` (some past the field's
    width, so the masks matter) or Python ints."""
    rng = np.random.default_rng(seed)
    names = [n for n, _ in FIELDS]
    prog = []
    for _ in range(n_ops):
        r = rng.random()
        if r < 0.2:
            prog.append(("or", "p", rng.random((4, 3)) < 0.5))
        elif r < 0.35:
            prog.append(("set", names[rng.integers(len(names))],
                         int(rng.integers(0, 1 << 62))))
        else:
            shape = (4, 3) if rng.random() < 0.6 else (4, 1)
            prog.append(("set", names[rng.integers(len(names))],
                         rng.integers(0, 1 << 64, size=shape, dtype=np.uint64)))
    return prog


def as_t(v):
    if isinstance(v, np.ndarray) and v.dtype == np.uint64:
        return torch.from_numpy(v.view(np.int64).copy())
    if isinstance(v, np.ndarray):
        return torch.from_numpy(v.copy())
    return v


def as_j(v):
    return jnp.asarray(v) if isinstance(v, np.ndarray) else v


def u64(t) -> np.ndarray:
    return np.asarray(t.numpy()).view(np.uint64)


@pytest.mark.parametrize("seed", range(6))
def test_coalesced_field_writer_matches_jax(seed):
    """Writes in call order, ``get`` after each write (after ``or_field``
    too), then ``done``: the port's writer and both JAX writers (coalesced
    and eager) give the same block and the same field values, and the base
    view is left as it was."""
    rng = np.random.default_rng(100 + seed)
    jpk, tpk = jtm.BitPacker(FIELDS), ttm.BitPacker(FIELDS)
    rows = rng.integers(0, 1 << 64, size=(4, tpk.width), dtype=np.uint64)
    trows = torch.from_numpy(rows.view(np.int64).copy())
    tbase = trows[:, None, :].expand(4, 3, tpk.width)
    jbase = jnp.broadcast_to(jnp.asarray(rows)[:, None, :], (4, 3, tpk.width))
    jw = jtm.FieldWriter(jpk, jbase, coalesce=True)
    je = jtm.FieldWriter(jpk, jbase, coalesce=False)
    tw = ttm.FieldWriter(tpk, tbase)
    names = [n for n, _ in FIELDS]
    for op, name, v in write_program(seed):
        if op == "or":
            jw.or_field(name, as_j(v))
            je.or_field(name, as_j(v))
            tw.or_field(name, as_t(v))
        else:
            jw.set(name, as_j(v))
            je.set(name, as_j(v))
            tw.set(name, as_t(v))
        for probe in (name, names[rng.integers(len(names))]):
            want = np.broadcast_to(np.asarray(jw.get(probe)), (4, 3))
            np.testing.assert_array_equal(
                np.broadcast_to(np.asarray(je.get(probe)), (4, 3)), want)
            got = np.broadcast_to(u64(tw.get(probe)), (4, 3))
            np.testing.assert_array_equal(got, want, err_msg=probe)
    want = np.asarray(jw.done())
    np.testing.assert_array_equal(np.asarray(je.done()), want)
    np.testing.assert_array_equal(u64(tw.done()), want)
    np.testing.assert_array_equal(u64(trows), rows)  # the base is untouched


def reachable_rows(model, **kw):
    """Every reachable row of ``model``: the queue rows ``[0, tail)`` of a
    complete run that never grew (growth drops the consumed prefix)."""
    c = model.checker().spawn_gpu(device="cpu", batch=64, **kw).join()
    assert not c.growth_events
    snap = c.final_snapshot()
    tail = int(snap["tail"])
    assert tail == c.unique_state_count()
    return c.tensor, snap["q_rows"][:tail]


# name: (JAX model, port model, spawn_gpu arguments, the twin's packing
# where it has one)
TWINS = {
    "2pc3": (lambda: JaxSys(3), lambda: TwoPhaseSys(3), {}, None),
    "paxos1": (lambda: jax_paxos_model(1), lambda: paxos_model(1), {}, None),
    "per-channel-paxos1": (lambda: per_channel(jax_paxos_model(1)),
                           lambda: per_channel(paxos_model(1)), {},
                           "per-channel"),
    "single-copy-2-1": (lambda: jax_single_copy_model(2, 1),
                        lambda: single_copy_model(2, 1), {}, "slot-multiset"),
    "raft3": (lambda: jax_raft_model(3), lambda: raft_model(3),
              dict(capacity=1 << 15), "slot-multiset"),
    "per-channel-raft3": (lambda: per_channel(jax_raft_model(3)),
                          lambda: per_channel(raft_model(3)),
                          dict(capacity=1 << 15), "per-channel"),
    "orl": (jax_orl_model, orl_model, {}, "slot-multiset"),
}


@pytest.mark.parametrize("name", list(TWINS))
def test_coalesced_step_equals_eager_on_every_reachable_row(name):
    """The port's ``step_rows`` (its packed words built by the coalesced
    writer) against the JAX twin's ``step_rows`` (the eager writer) on
    every reachable row: the same validity, and the same successor where
    it is valid (an invalid lane's row is unspecified)."""
    jbuild, tbuild, kw, packing = TWINS[name]
    tm, rows = reachable_rows(tbuild(), **kw)
    jm = jbuild().tensor_model()
    if packing is not None:
        assert tm.network_encoding == jm.network_encoding == packing
    jm.step_rows(jnp.asarray(rows[:1]))  # a compiled twin's lazy constants
    jstep = jax.jit(jm.step_rows)
    for chunk in np.array_split(rows, -(-rows.shape[0] // 1024)):
        js, jv = (np.asarray(x) for x in jstep(jnp.asarray(chunk)))
        ts, tv = tm.step_rows(torch.from_numpy(chunk.view(np.int64).copy()))
        np.testing.assert_array_equal(tv.numpy(), jv)
        np.testing.assert_array_equal(u64(ts)[jv], js[jv])


# the compiled slot-multiset single-copy beside the prededup file's runs
MXU_RUNS = dict(RUNS, **{"single-copy-2-1": (
    lambda: jax_single_copy_model(2, 1), lambda: single_copy_model(2, 1),
    False, dict(capacity=1 << 12, batch=64), (93, 121))})


@pytest.mark.parametrize("flags", [("mxu",), ("prededup", "mxu")])
@pytest.mark.parametrize("name", list(MXU_RUNS))
def test_mxu_engine_matches_jax_engine(name, flags):
    """The port with the flags against the JAX engine with the same flags
    (there ``.mxu()`` arms the coalesced expand, the slim queue and the
    product probe): the same run."""
    j, t = flagged_pair(MXU_RUNS[name], flags)
    assert t._prededup == ("prededup" in flags)
    assert (t.unique_state_count(), t.state_count()) == MXU_RUNS[name][4]
    same_sym_run(t, j)


def step_ops(builder, monkeypatch) -> list:
    """The dispatched operations of each step of ``builder``'s run on the
    CPU, by name, and the run."""
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
    c = builder.spawn_gpu(device="cpu", batch=64).join()
    monkeypatch.undo()
    return steps, c


@pytest.mark.parametrize("mxu", [
    dict(), dict(enabled=False), dict(coalesce=False),
    dict(slim_queue=False, probe=False), "env"])
def test_mxu_is_accepted_and_changes_nothing(mxu, monkeypatch):
    """``.mxu()`` with any of its keywords, and ``STATERIGHT_TPU_MXU=1``,
    leave every step's dispatched operations and the run as they are
    without it: the coalesced writer is the port's only one."""
    base, plain = step_ops(TwoPhaseSys(3).checker(), monkeypatch)
    if mxu == "env":
        monkeypatch.setenv("STATERIGHT_TPU_MXU", "1")
        b = TwoPhaseSys(3).checker()
    else:
        b = TwoPhaseSys(3).checker().mxu(**mxu)
    steps, c = step_ops(b, monkeypatch)
    assert steps == base
    assert (c.unique_state_count(), c.state_count()) == (288, 1146)
    assert c.discovery_fps() == plain.discovery_fps()
    assert_same_snapshot(c.final_snapshot(), plain.final_snapshot())


def test_gpu_verbs_take_the_step_flags(monkeypatch, capsys):
    """``check-gpu``/``check-sym-gpu`` take ``--prededup`` (and ``--mxu``,
    accepted without effect) and arm the pre-dedup (run here on the
    CPU); a host verb refuses them."""
    seen = []
    real = CheckerBuilder.spawn_gpu

    def on_cpu(self, **kw):
        seen.append((self.prededup_mode, self.symmetry_fn is not None))
        return real(self, device="cpu", batch=64)

    monkeypatch.setattr(CheckerBuilder, "spawn_gpu", on_cpu)
    assert two_phase_commit.main(["check-gpu", "3", "--mxu",
                                  "--prededup"]) == 0
    assert two_phase_commit.main(["check-sym-gpu", "--prededup", "3"]) == 0
    assert two_phase_commit.main(["check-gpu", "3", "--mxu"]) == 0
    assert two_phase_commit.main(["check-gpu", "3"]) == 0
    out = capsys.readouterr().out
    assert out.count("unique=288,") == 3 and "unique=94," in out
    assert seen == [(True, False), (True, True), (None, False),
                    (None, False)]
    assert two_phase_commit.main(["check", "3", "--mxu"]) == 2
