"""Checked execution mode in the port (``stateright_tpu_torch/analysis/
sanitizer.py``) against the JAX package's (``stateright_tpu/analysis/
sanitizer.py``, checkify), tolerance 0: the clean 2pc-3 run's counts,
discoveries and table bytes; the out-of-range twin's failing row; the
guard's flag per aten operation (a negative index, an index past the end,
a zero divisor, a NaN), with the clamped result and no host read; and the
flag's composition with cartography, symmetry, prededup and spill.  The
recorded difference: unchecked, the port's out-of-range gather raises
``IndexError`` on the CPU where the JAX package clamps and finishes at 5
states."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax.numpy as jnp

from stateright_tpu import Model as JaxModel
from stateright_tpu import Property as JaxProperty
from stateright_tpu.analysis import CheckedExecutionError as JaxCheckedError
from stateright_tpu.models.two_phase_commit import TwoPhaseSys as JaxSys
from stateright_tpu.parallel.tensor_model import BitPacker as JaxPacker
from stateright_tpu.parallel.tensor_model import (
    TensorBackedModel as JaxBacked,
)
from stateright_tpu.parallel.tensor_model import TensorModel as JaxTensor
from stateright_tpu_torch.analysis import (
    CheckedExecutionError,
    CheckedGuard,
    checked_kernels,
    localize_checked_failure,
)
from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
from test_torch_oob_twin import Counter, OOBModel

KW = dict(batch=64, capacity=1 << 12)


# -- the out-of-range gather twin (JAX tests/test_sanitizer.py:64-80) ----------


class JaxOOBTwin(JaxTensor):
    """A 3-bit count indexes a 4-entry table: 4..7 escape it."""

    width, max_actions = 1, 1
    pk = JaxPacker([("count", 3)])

    def __init__(self, model):
        self.model = model

    def init_rows(self):
        return np.zeros((1, 1), np.uint64)

    def encode_state(self, s):
        return (int(s),)

    def decode_state(self, row):
        return int(row[0])

    def property_masks(self, rows):
        return jnp.ones((rows.shape[0], 1), bool)

    def step_rows(self, rows):
        c = self.pk.get(rows, "count").astype(jnp.int32)
        nxt = jnp.asarray([1, 2, 3, 4], jnp.uint64)[c]
        return rows.at[..., 0].set(nxt)[:, None, :], (c < 7)[:, None]


class JaxOOBModel(Counter, JaxBacked, JaxModel):
    def tensor_model(self):
        return JaxOOBTwin(self)

    def properties(self):
        return [JaxProperty.always("ok", lambda m, s: True)]


# -- the engine ------------------------------------------------------------------


def test_checked_2pc3_equals_jax_checked_run():
    """288 unique and two discoveries, the JAX ``.checked()`` run's counts,
    discovery paths and table bytes at the same capacities."""
    j = JaxSys(3).checker().checked().spawn_tpu(sync=True, **KW)
    c = TwoPhaseSys(3).checker().checked().spawn_gpu(device="cpu",
                                                      **KW).join()
    assert c.unique_state_count() == j.unique_state_count() == 288
    assert c.state_count() == j.state_count()
    assert len(c.discoveries()) == len(j.discoveries()) == 2
    for name, path in c.discoveries().items():
        assert ([repr(s) for s in path.states()]
                == [repr(s) for s in j.discoveries()[name].states()])
    js, ts = j.checkpoint(), c.final_snapshot()
    for k in ("table_fp", "table_parent"):
        np.testing.assert_array_equal(np.asarray(ts[k]), np.asarray(js[k]))


def test_checked_oob_twin_names_the_jax_row():
    """The out-of-range twin raises with JAX's ``row_index``, state 4 and
    "out-of-bounds" (JAX tests/test_sanitizer.py:357-371)."""
    with pytest.raises(JaxCheckedError) as jexc:
        JaxOOBModel().checker().skip_audit().checked().spawn_tpu(
            sync=True, batch=8, capacity=1 << 10)
    with pytest.raises(CheckedExecutionError) as exc:
        OOBModel().checker().skip_audit().checked().spawn_gpu(
            device="cpu", batch=8, capacity=1 << 10).join()
    e, je = exc.value, jexc.value
    assert e.row_index == je.row_index is not None
    assert e.state == je.state == 4
    assert "out-of-bounds" in str(e) and "out-of-bounds" in str(je)
    assert "index 4 is out of bounds for axis 0 with size 4" in str(e)
    assert int(e.row[0]) == int(je.row[0]) == 4


def test_unchecked_oob_twin_raises_index_error_on_the_cpu():
    """The recorded difference from the JAX package: without
    ``.checked()`` the port adds no clamp, so the twin's out-of-range
    gather raises torch's ``IndexError`` (JAX clamps and ends silently at
    5 of 8 states).  Both runs skip the preflight, which refuses the twin
    (JX201) in both packages."""
    j = JaxOOBModel().checker().skip_audit().spawn_tpu(
        sync=True, batch=8, capacity=1 << 10)
    assert j.unique_state_count() == 5
    c = OOBModel().checker().skip_audit().spawn_gpu(device="cpu", batch=8,
                                                    capacity=1 << 10)
    with pytest.raises(IndexError, match="out of bounds"):
        c.join()


def reconcile(c, n_init=1):
    cart = c.cartography()
    assert sum(cart["depth_hist"]) == c.unique_state_count()
    assert cart["fresh_inserts"] == c.unique_state_count()
    assert sum(cart["action_hist"]) == c.state_count() - n_init
    assert cart["duplicate_hits"] == c.state_count() - c.unique_state_count()


@pytest.mark.parametrize("flag", ["cartography", "symmetry", "prededup",
                                  "spill"])
def test_checked_composes_with_the_other_flags(flag):
    """The checked word rides the carry beside the other flags' state:
    counts equal the JAX package's run with the same flags, and under
    cartography the counters reconcile (JAX tests/test_cartography.py:
    153-161)."""
    n = 5 if flag == "symmetry" else 3
    jb, pb = JaxSys(n).checker().checked(), TwoPhaseSys(n).checker().checked()
    kw = dict(KW)
    if flag == "spill":
        kw["spill_bloom_bits"] = 1 << 14
    jb, pb = getattr(jb, flag)(), getattr(pb, flag)()
    j = jb.spawn_tpu(sync=True, **kw)
    c = pb.spawn_gpu(device="cpu", **kw).join()
    assert c.unique_state_count() == j.unique_state_count()
    assert c.state_count() == j.state_count()
    assert sorted(c.discoveries()) == sorted(j.discoveries())
    if flag == "cartography":
        reconcile(c)


def _twin_model(name):
    from stateright_tpu_torch.models.paxos import paxos_model
    from stateright_tpu_torch.models.single_copy_register import (
        single_copy_model,
    )

    if name == "single-copy-2":
        return single_copy_model(2)
    m = paxos_model(1)
    if name == "per-channel-paxos-1":
        m.per_channel_()
    return m


@pytest.mark.parametrize("name", ["paxos-1", "per-channel-paxos-1",
                                  "single-copy-2"])
def test_checked_twins_raise_no_false_flag(name):
    """``PaxosTensor``'s gathers, the compiled twins' (slot-multiset and
    per-channel) and their history codecs' run under the guard with no
    flag: the checked run equals the unchecked one, table bytes and queue
    rows included."""
    kw = dict(device="cpu", batch=64)
    c = _twin_model(name).checker().checked().spawn_gpu(**kw).join()
    u = _twin_model(name).checker().spawn_gpu(**kw).join()
    assert c.unique_state_count() == u.unique_state_count()
    assert c.unique_state_count() == {"single-copy-2": 93}.get(name, 265)
    assert c.state_count() == u.state_count()
    cs, us = c.final_snapshot(), u.final_snapshot()
    tail = int(us["tail"])
    for k in ("table_fp", "table_parent"):
        np.testing.assert_array_equal(cs[k], us[k])
    for k in ("q_rows", "q_fp", "q_ebits", "q_depth"):
        np.testing.assert_array_equal(cs[k][:tail], us[k][:tail])


# -- the guard, operation by operation ---------------------------------------------


class HostReads(TorchDispatchMode):
    """The operations that read a tensor on the host."""

    READS = (torch.ops.aten._local_scalar_dense.default,
             torch.ops.aten.is_nonzero.default,
             torch.ops.aten.nonzero.default,
             torch.ops.aten.masked_select.default)

    def __init__(self):
        super().__init__()
        self.hits: list = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.READS:
            self.hits.append(str(func))
        return func(*args, **(kwargs or {}))


X = torch.arange(10, 14)


def _put(i):
    return X.clone().index_put_((torch.tensor([i]),), torch.tensor(9))


def _scatter(i):
    return X.clone().scatter_(0, torch.tensor([i]), torch.tensor([9]))


# op -> (call on an index, the index rule's lower bound): torch's valid
# range for the operation, which the guard flags outside of and clamps
# into (``index``, ``index_put`` and ``take`` count a negative index from
# the end, as a jnp subscript does; the others reject it)
INDEX_CASES = {
    "index": (lambda i: X[torch.tensor([i])], -4),
    "index_select": (lambda i: X.index_select(0, torch.tensor([i])), 0),
    "gather": (lambda i: X.gather(0, torch.tensor([i])), 0),
    "take": (lambda i: torch.take(X, torch.tensor([i])), -4),
    "index_put": (_put, -4),
    "scatter": (_scatter, 0),
}


def _plain(op, i):
    """What the operation computes at the clamped index."""
    return INDEX_CASES[op][0](i)


@pytest.mark.parametrize("where", ["negative", "past_the_end"])
@pytest.mark.parametrize("op", list(INDEX_CASES))
def test_guard_flags_and_clamps_each_index_op(op, where):
    fn, lo = INDEX_CASES[op]
    probe, guard = HostReads(), CheckedGuard(torch.zeros((), dtype=torch.bool))
    # -1 is in range where negatives count from the end; -5 never is
    bad = {"negative": -5 if lo < 0 else -1, "past_the_end": 4}[where]
    with probe:
        with guard:
            out = fn(bad)
        assert probe.hits == [], "the guard read a flag on the host"
    assert bool(guard.err)
    clamped = min(max(bad, lo), 3)
    torch.testing.assert_close(out, _plain(op, clamped), rtol=0, atol=0)
    # an index in range raises nothing and computes the plain result
    ok = CheckedGuard(torch.zeros((), dtype=torch.bool))
    with ok:
        out = fn(-1 if lo < 0 else 3)
    assert not bool(ok.err)
    torch.testing.assert_close(out, _plain(op, -1 if lo < 0 else 3),
                               rtol=0, atol=0)


@pytest.mark.parametrize("op", ["floor_divide", "remainder", "fmod", "div"])
def test_guard_flags_a_zero_divisor_and_divides_by_one(op):
    d = torch.tensor([1, 0, 2, 3])
    guard = CheckedGuard(torch.zeros((), dtype=torch.bool))
    fns = {"floor_divide": torch.floor_divide, "remainder": torch.remainder,
           "fmod": torch.fmod,
           "div": lambda a, b: torch.div(a, b, rounding_mode="trunc")}
    probe = HostReads()
    with probe:
        with guard:
            out = fns[op](X, d)
    assert probe.hits == [] and bool(guard.err)
    torch.testing.assert_close(out, fns[op](X, torch.tensor([1, 1, 2, 3])),
                               rtol=0, atol=0)


def test_guard_flags_a_nan_and_ignores_boolean_masks():
    guard = CheckedGuard(torch.zeros((), dtype=torch.bool))
    with guard:
        torch.sqrt(torch.tensor([-1.0, 4.0]))
    assert bool(guard.err)
    clean = CheckedGuard(torch.zeros((), dtype=torch.bool))
    with clean:
        out = X[torch.tensor([True, False, True, False])]
        torch.sqrt(torch.tensor([1.0, 4.0]))
    assert not bool(clean.err)
    assert out.tolist() == [10, 12]


def test_checked_kernels_and_the_row_replay():
    """``checked_kernels`` ORs the flag into the carried word; the replay
    names the failing row, and raises the block-level error when no row
    reproduces the failure."""
    twin = OOBModel().tensor_model()
    kernels = checked_kernels(twin)
    rows = torch.tensor([[3], [4]], dtype=torch.int64)
    err, (masks, succ, valid) = kernels(rows, torch.zeros((), dtype=torch.bool))
    assert bool(err) and succ[:, 0, 0].tolist() == [4, 4]
    err, _ = kernels(rows[:1], torch.zeros((), dtype=torch.bool))
    assert not bool(err)
    with pytest.raises(CheckedExecutionError) as exc:
        localize_checked_failure(twin, np.asarray([[2], [5]], np.uint64))
    assert exc.value.row_index == 1 and exc.value.state == 5
    with pytest.raises(CheckedExecutionError, match="did not reproduce"):
        localize_checked_failure(twin, np.asarray([[1]], np.uint64))


def test_checked_flag_on_the_gpu_verbs(capsys):
    """``--checked`` and ``--spill`` on ``check-gpu``/``check-sym-gpu``
    (JAX ``_cli.py::pop_checked``, ``pop_perf``)."""
    from stateright_tpu_torch.models import two_phase_commit
    from stateright_tpu_torch.models._cli import STEP_FLAGS, pop_step_flags

    flags, rest = pop_step_flags(["3", "--checked", "--spill"])
    assert flags == ["--checked", "--spill"] and rest == ["3"]
    assert STEP_FLAGS["--checked"] == "checked"
    assert STEP_FLAGS["--spill"] == "spill"
    for verb, unique in (("check-gpu", 288), ("check-sym-gpu", 94)):
        assert two_phase_commit.main([verb, "3", "--checked", "--spill",
                                      "--device=cpu", "--batch=64"]) == 0
        assert f"unique={unique}," in capsys.readouterr().out
