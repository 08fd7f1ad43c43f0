"""The entry-point keywords the port's service layer needs, against the JAX
package (tolerance 0):

 - ``compile_actor_model(n_slots=)``: a slot-multiset twin at 32 slots
   gives the JAX twin's width and arity, and the engine the JAX engine's
   counts and table bytes at the same capacities; per-channel refuses the
   knob with JAX's ``CompileError``;
 - ``compile_actor_model(max_history_states=)``: the history codec's cap,
   which both codecs enforce with the same error at the same size;
 - ``spawn_gpu(sync=True)`` and the sweep engine's ``sync=True``: the run
   is done on return, on the caller's thread, with the threaded run's
   tables.
"""

import threading

import numpy as np
import pytest

from stateright_tpu.models.paxos import paxos_model as jax_paxos
from stateright_tpu.models.single_copy_register import (
    single_copy_model as jax_single_copy,
)
from stateright_tpu.parallel.actor_compiler import (
    CompileError as JaxCompileError,
)
from stateright_tpu.parallel.actor_compiler import (
    compile_actor_model as jax_compile,
)
from stateright_tpu_torch.models.paxos import paxos_model
from stateright_tpu_torch.models.single_copy_register import single_copy_model
from stateright_tpu_torch.models.two_phase_commit import (
    TwoPhaseSys,
    sweep_family,
)
from stateright_tpu_torch.parallel.actor_compiler import (
    CompileError,
    compile_actor_model,
)
from test_torch_engine import assert_same_run


def with_twin(model, **compile_kw):
    """``model`` whose twin is compiled with ``compile_kw``."""
    compile_fn = (jax_compile if type(model).__module__.startswith(
        "stateright_tpu.") else compile_actor_model)
    twin = compile_fn(model, **compile_kw)
    model.tensor_model = lambda: twin
    return model, twin


def test_n_slots_sets_the_slot_multiset_width_as_jax():
    jm, jt = with_twin(jax_single_copy(2, 1), n_slots=32)
    pm, pt = with_twin(single_copy_model(2, 1), n_slots=32)
    assert pt.n_slots == jt.n_slots == 32
    assert (pt.width, pt.max_actions) == (jt.width, jt.max_actions)
    default = compile_actor_model(single_copy_model(2, 1))
    assert default.n_slots == max(16, 4 * default.n_actors) != 32
    np.testing.assert_array_equal(np.asarray(pt.init_rows()),
                                  np.asarray(jt.init_rows()))
    j = jm.checker().spawn_tpu(sync=True, capacity=1 << 12,
                               frontier_capacity=64)
    t = pm.checker().spawn_gpu(device="cpu", capacity=1 << 12,
                               batch=64).join()
    assert t.unique_state_count() == 93
    assert_same_run(j, t)


def test_n_slots_is_refused_under_per_channel_as_jax():
    with pytest.raises(JaxCompileError, match="slot-multiset knob") as je:
        jax_compile(jax_paxos(1, 3).per_channel_(), n_slots=32)
    with pytest.raises(CompileError, match="slot-multiset knob") as pe:
        compile_actor_model(paxos_model(1, 3).per_channel_(), n_slots=32)
    assert str(pe.value) == str(je.value)


@pytest.mark.parametrize("cap", [4, 2_000_000])
def test_max_history_states_caps_the_codec_as_jax(cap):
    jt = jax_compile(jax_single_copy(2, 1), max_history_states=cap)
    pt = compile_actor_model(single_copy_model(2, 1), max_history_states=cap)
    assert pt.hist._max_states == jt.hist._max_states == cap
    outcomes = []
    for twin in (jt, pt):
        try:
            twin.hist.ensure_table()
            outcomes.append(("ok", np.asarray(twin.hist.table_keys).tolist(),
                             np.asarray(twin.hist.table_ok).tolist()))
        except RuntimeError as e:
            outcomes.append(("raised", str(e)))
    assert outcomes[0] == outcomes[1]
    assert outcomes[0][0] == ("raised" if cap == 4 else "ok")


def test_spawn_gpu_sync_runs_on_the_callers_thread(monkeypatch):
    from stateright_tpu_torch.parallel.wavefront import GpuChecker

    seen = []
    run = GpuChecker._run

    def spy(self):
        seen.append(threading.current_thread())
        return run(self)

    monkeypatch.setattr(GpuChecker, "_run", spy)
    s = TwoPhaseSys(4).checker().spawn_gpu(device="cpu", batch=64, sync=True)
    monkeypatch.undo()
    assert s.is_done() and s._thread is None
    assert seen == [threading.current_thread()]
    t = TwoPhaseSys(4).checker().spawn_gpu(device="cpu", batch=64).join()
    assert s.unique_state_count() == t.unique_state_count() == 1568
    assert s.state_count() == t.state_count()
    for a, b in zip(s._table_np(), t._table_np()):
        np.testing.assert_array_equal(a, b)
    assert s.discovery_fps() == t.discovery_fps()
    assert s.join() is s  # joining a finished sync run is a no-op


def test_sync_run_raises_at_the_spawn(monkeypatch):
    from stateright_tpu_torch.parallel.wavefront import GpuChecker

    def boom(self):
        raise RuntimeError("the engine failed")

    monkeypatch.setattr(GpuChecker, "_run", boom)
    with pytest.raises(RuntimeError, match="the engine failed"):
        TwoPhaseSys(3).checker().spawn_gpu(device="cpu", batch=64, sync=True)


def test_sweep_sync_runs_on_the_callers_thread():
    spec = sweep_family(2)
    s = TwoPhaseSys(3).checker().sweep(spec).spawn_gpu(
        device="cpu", capacity=1 << 12, batch=64, sync=True)
    assert s.is_done() and s._thread is None
    t = TwoPhaseSys(3).checker().sweep(spec).spawn_gpu(
        device="cpu", capacity=1 << 12, batch=64).join()
    assert [r.unique for r in s.results.values()] == [288, 288]
    a, b = s.final_snapshot(), t.final_snapshot()
    for k in ("table_fp", "table_parent", "q_tag"):
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
