"""The block loop of the port's engine (``ops/block_loop.py``) on the CPU,
against the JAX package's ``lax.while_loop`` and its ``cond``
(``stateright_tpu/parallel/wavefront.py:701-710``, ``:748-751``):

 - ``_Engine.go_of`` and ``block_cond_plain`` equal JAX's ``cond`` (taken
   from the JAX engine's ``run_fn``) on the same carries, converted with
   ``convert.py``, before every step of 2pc-3/5 runs with growth, a
   discovery stop, a target stop and a checked failure;
 - a step whose ``go`` is false leaves every carry entry bit-identical,
   under every flag of the single-device engine (the graph block skips
   such steps, so this is what makes it equal to the eager loop), and the
   capture's warm step leaves the carry as it was;
 - the closed-loop step (the static carry, the copy-back of the replaced
   entries, no step after the stop), run eagerly, gives the JAX engine's
   counts, tables and queue rows at tolerance 0.

The graph itself runs only on the card (``tests/test_torch_gpu.py``)."""

import numpy as np
import pytest

import jax  # noqa: F401  (both frameworks in one process, JAX on the CPU)
import jax.numpy as jnp
import torch

from stateright_tpu.models.two_phase_commit import TwoPhaseSys as JaxSys
from stateright_tpu.parallel.wavefront import _build_engine as jax_engine
from stateright_tpu_torch import convert
from stateright_tpu_torch.models.paxos import paxos_model
from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
from stateright_tpu_torch.ops.block_loop import (
    CondInputs,
    _adopt,
    _copy_back,
    block_cond,
    block_cond_plain,
    block_go,
)
from stateright_tpu_torch.parallel import wavefront
from stateright_tpu_torch.testing.block_legs import abort_only
from test_torch_checked import JaxOOBModel
from test_torch_engine import assert_same_run, jax_run
from test_torch_oob_twin import OOBModel


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The port's runs here on one torch thread: their tensors are small,
    and under several test workers the default thread pool oversubscribes
    the host's cores many times over.  Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


KW = dict(device="cpu", batch=64, steps_per_call=4)


# name: (port builder, JAX model, spawn_gpu arguments, how the run stops)
COND_RUNS = {
    "2pc3-growth": (lambda: TwoPhaseSys(3).checker(), lambda: JaxSys(3),
                    dict(capacity=1 << 6, batch=8), "empty"),
    "2pc5": (lambda: TwoPhaseSys(5).checker(), lambda: JaxSys(5), {},
             "empty"),
    "2pc5-discovery": (lambda: abort_only(TwoPhaseSys(5)).checker()
                       .skip_audit(),
                       lambda: abort_only(JaxSys(5)), {}, "discovery"),
    "2pc5-target": (lambda: TwoPhaseSys(5).checker().target_states(2000),
                    lambda: JaxSys(5), {}, "target"),
    "oob-checked": (lambda: OOBModel().checker().skip_audit().checked(),
                    lambda: JaxOOBModel(), dict(batch=8), "checked"),
}


def jax_cond(eng, jax_model):
    """The JAX engine's ``cond`` at ``eng``'s capacities, steps, target and
    checked flag (the closure ``run_fn`` loops on)."""
    props = jax_model.properties()
    _, run_fn = jax_engine(jax_model.tensor_model(), props, eng.cap,
                           eng.qcap, eng.batch, eng.steps, eng.target,
                           cand=eng.eff_cand, checked=eng.checked)
    f = run_fn.__wrapped__
    return dict(zip(f.__code__.co_freevars, f.__closure__))["cond"] \
        .cell_contents


def cond_view(c: list, checked: bool) -> list:
    """What ``cond`` reads of the carry ``c``, copied: the scalars and the
    discoveries, the table and queue left as empty tensors of their
    dtypes, and the checked word."""
    out = [t.clone() if t.dim() <= 1 and i >= 6 else t.new_empty(0)
           for i, t in enumerate(c[:wavefront.BASE])]
    if checked:
        out.append(c[wavefront.BASE].clone())
    return out


def to_jax(view: list, checked: bool) -> tuple:
    """A recorded view as the JAX engine's carry (``convert.py``)."""
    out = [jnp.asarray(a) for a in convert.carry_to_arrays(
        view[:wavefront.BASE])]
    if checked:
        out.append(jnp.asarray(bool(view[wavefront.BASE])))
    return tuple(out)


@pytest.mark.parametrize("name", sorted(COND_RUNS))
def test_go_and_the_plain_cond_equal_jax_cond(name, monkeypatch):
    """Before every step of the run (each block boundary among them),
    ``go_of`` equals JAX's ``cond`` at ``k = 0``, and ``block_cond_plain``
    (and the wrapper, which takes it on the CPU) equals ``cond`` at every
    ``k`` from 0 to ``steps``; the run ends the way it is meant to."""
    build, jax_model, kw, stop = COND_RUNS[name]
    seen = []
    step = wavefront._Engine.step

    def recording(self, c):
        seen.append((self, cond_view(c, self.checked)))
        return step(self, c)

    monkeypatch.setattr(wavefront._Engine, "step", recording)
    try:
        c = build().spawn_gpu(**dict(KW, **kw)).join()
    except Exception as e:  # the checked run raises at its failing block
        assert stop == "checked", e
        assert type(e).__name__ == "CheckedExecutionError"
        c = None
    if stop == "empty":
        assert (len(c.growth_events) > 0) == name.endswith("growth")
    conds, stops = {}, 0
    jm = jax_model()
    for eng, view in seen:
        if eng.key not in conds:
            conds[eng.key] = jax_cond(eng, jm)
        cond = conds[eng.key]
        go = eng.go_of(view)
        jc = to_jax(view, eng.checked)
        assert bool(go) == bool(cond((jnp.int32(0), jc)))
        stops += not bool(go)
        for k in range(eng.steps + 1):
            kt = torch.tensor([k], dtype=torch.int64)
            want = bool(cond((jnp.int32(k), jc)))
            got, k1 = block_cond_plain(eng.cond_inputs(view), kt, eng.steps)
            assert bool(got) == want and int(k1) == k + want
            got, k1 = block_cond(eng.cond_inputs(view), kt, eng.steps)
            assert bool(got) == want and int(k1) == k + want
    # post-stop steps of the eager loop: the stop itself was seen
    assert stops >= 1
    if stop == "discovery":
        # a stop by the discovery term alone: an OK status, a queue left
        assert all(fp != 0 for fp in c.discovery_fps().values())
        assert any(bool((v[wavefront.DISC] != 0).all())
                   and int(v[wavefront.TAIL]) > int(v[wavefront.HEAD])
                   and int(v[wavefront.STATUS]) == 0 for _, v in seen)
    if stop == "target":
        assert 2000 <= c.unique_state_count() < 8832


def per_channel_paxos1():
    m = paxos_model(1)
    m.per_channel_()
    return m


# flag: (builder, spawn_gpu arguments, engine capacities (cap, qcap, cand))
FLAG_RUNS = {
    "plain": (lambda: TwoPhaseSys(3).checker(), {}, (1 << 8, 1 << 7, 64)),
    "symmetry": (lambda: TwoPhaseSys(4).checker().symmetry(), {},
                 (1 << 8, 1 << 7, 64)),
    "prededup": (lambda: TwoPhaseSys(3).checker().prededup(), {},
                 (1 << 8, 1 << 7, 64)),
    "cartography": (lambda: TwoPhaseSys(3).checker().cartography(), {},
                    (1 << 8, 1 << 7, 64)),
    "checked": (lambda: TwoPhaseSys(3).checker().checked(), {},
                (1 << 8, 1 << 7, 64)),
    "spill": (lambda: TwoPhaseSys(3).checker().spill(),
              dict(spill_bloom_bits=1 << 12), (1 << 10, 1 << 9, 256)),
    "por": (lambda: per_channel_paxos1().checker().por(), {},
            (1 << 10, 1 << 9, 256)),
}


def flag_engine(flag: str):
    """A CPU engine of ``flag``'s run at small capacities and its init
    carry; under ``.spill()`` the Bloom words are all ones, so every
    candidate defers and the pending buffers fill."""
    build, kw, (cap, qcap, cand) = FLAG_RUNS[flag]
    c = build().spawn_gpu(**dict(KW, **kw)).join()
    eng = c._engine(cap, qcap, 64, cand)
    carry, _ = eng.init()
    if eng.spill:
        sp = eng.layout.spill_start + wavefront._SP_BLOOM
        carry[sp] = torch.full_like(carry[sp], -1)
    return eng, carry


def assert_same_carry(got: list, want: list, what: str) -> None:
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and torch.equal(a, b), (what, i)


@pytest.mark.parametrize("flag", sorted(FLAG_RUNS))
def test_a_stopped_step_leaves_the_carry_bit_identical(flag):
    """Steps run until ``go`` turns false (a growth, spill-sync or empty
    stop); then each further step, and the warm step at every earlier
    carry, leaves every carry entry, in-place buffers included, exactly as
    it was."""
    eng, c = flag_engine(flag)
    warmed = 0
    for _ in range(400):
        if not bool(eng.go_of(c)):
            break
        before = [t.clone() for t in c]
        eng.warm(c)
        assert_same_carry(c, before, "warm")
        warmed += 1
        c = eng.step(c)
    assert not bool(eng.go_of(c)) and warmed >= 1
    for n in range(2):
        before = [t.clone() for t in c]
        c = eng.step(c)
        assert_same_carry(c, before, f"stopped step {n}")
    if flag == "spill":
        sp = eng.layout.spill_start
        assert int(c[sp + wavefront._SP_PCOUNT]) > 0


def closed_loop(self, carry):
    """The block graph's semantics run eagerly: the carry adopted as the
    static carry, then while the plain cond holds, one step whose replaced
    entries are copied back into the static tensors."""
    static = _adopt(carry)
    k = torch.zeros(1, dtype=torch.int64)
    while True:
        go, k = block_cond_plain(self.cond_inputs(static), k, self.steps)
        if not bool(go):
            break
        _copy_back(static, self.step(list(static)))
    return static, torch.cat([self._stats(static), k])


@pytest.mark.parametrize("n,kw", [
    (3, dict(capacity=1 << 6, batch=8)),
    (4, {}),
    (5, dict(steps_per_call=16)),
], ids=["2pc3-growth", "2pc4", "2pc5"])
def test_closed_loop_step_equals_the_jax_engine(n, kw, monkeypatch):
    """The closed-loop block, run eagerly on the CPU through the host loop,
    gives the JAX engine's counts, discoveries, traces, table bytes and
    queue rows (tolerance 0), and executes fewer steps than it issues."""
    monkeypatch.setattr(wavefront._Engine, "run", closed_loop)
    t = TwoPhaseSys(n).checker().spawn_gpu(
        device="cpu", **dict(dict(batch=64, steps_per_call=4), **kw)).join()
    jkw = dict(kw)
    jkw.setdefault("batch", 64)
    jkw.setdefault("steps_per_call", 4)
    j = jax_run(n, **jkw)
    assert_same_run(j, t)
    ts, js = t.final_snapshot(), j.checkpoint()
    tail = int(ts["tail"])
    assert tail == int(np.asarray(js["tail"]))
    for key in ("q_rows", "q_fp", "q_ebits", "q_depth"):
        np.testing.assert_array_equal(np.asarray(ts[key])[:tail],
                                      np.asarray(js[key])[:tail],
                                      err_msg=key)
    assert 0 < t.steps_executed <= t.steps_run


def test_the_eager_loop_counts_the_steps_that_did_work():
    """``steps_executed`` is the eager loop's count of steps whose ``go``
    was true, and ``steps_run`` stays blocks times ``steps_per_call``."""
    counted = []
    step = wavefront._Engine.step

    def counting(self, c):
        counted.append(bool(self.go_of(c)))
        return step(self, c)

    wavefront._Engine.step = counting
    try:
        c = TwoPhaseSys(4).checker().spawn_gpu(device="cpu", batch=64,
                                               steps_per_call=8).join()
    finally:
        wavefront._Engine.step = step
    assert c.steps_executed == sum(counted) > 0
    assert c.steps_run == len(counted) and c.steps_run % 8 == 0
    assert c.steps_executed < c.steps_run


def test_copy_back_and_adopt_keep_one_tensor_per_entry():
    """``_adopt`` clones an entry sharing storage with an earlier one;
    ``_copy_back`` copies the replaced entries only, reading the step's
    value even when an output aliases a static tensor."""
    a = torch.arange(3)
    static = _adopt([a, a, torch.zeros((), dtype=torch.int64)])
    assert static[0] is a and static[1] is not a
    assert torch.equal(static[1], a)
    out = [static[0], static[0] + 10, static[0][0].clone()]
    # entry 1 becomes 10..12; entry 0 is kept; 2 takes the old static[0][0]
    moved = _copy_back(static, out)
    assert moved == [1, 2]
    assert static[1].tolist() == [10, 11, 12] and int(static[2]) == 0
    swap = [static[1], static[0], static[2]]
    assert _copy_back(static, swap) == [0, 1]
    assert static[0].tolist() == [10, 11, 12]
    assert static[1].tolist() == [0, 1, 2]
    with pytest.raises(RuntimeError, match="changed carry entry"):
        _copy_back(static, [static[0], static[1], torch.zeros(2)])


def test_block_go_without_properties_or_target():
    """``block_go``'s terms one at a time (no property: never all
    discovered; a target; the checked word)."""
    s = lambda v: torch.tensor(v, dtype=torch.int64)  # noqa: E731
    x = CondInputs(s(0), s(3), s(1), s(0), None, None, None)
    assert bool(block_go(x))
    assert not bool(block_go(x._replace(status=s(2))))
    assert not bool(block_go(x._replace(tail=s(0))))
    assert not bool(block_go(x._replace(target=1)))
    assert bool(block_go(x._replace(target=2)))
    assert not bool(block_go(x._replace(err=torch.tensor(True))))
    assert not bool(block_go(x._replace(disc=s([5, 6]))))
    assert bool(block_go(x._replace(disc=s([5, 0]))))
