"""The write-once register in the port (``models/write_once_register.py``,
the ``put_fail`` envelope kind and the ``wfail`` history field) against
the JAX package, tolerance 0:

 - the write-once spec;
 - both compilers' tables, history tables and init rows, and
   ``step_rows``/``property_masks`` on every state, in both network
   packings;
 - the engine against ``spawn_tpu(sync=True)``: wo(2,1) at 97 / 71 in both
   packings, and wo(2,2)'s violation;
 - a write-once workload with ``put_count=2`` still raises, and the
   ``check-gpu`` verb raises without a card.

The ``put_count >= 2`` histories are in ``test_torch_multi_op.py``, which
shares :func:`build`.
"""

import numpy as np
import pytest
import torch

from stateright_tpu.models.linearizable_register import abd_model as jax_abd
from stateright_tpu.models.single_copy_register import (
    single_copy_model as jax_single_copy,
)
from stateright_tpu.models.write_once_register import (
    wo_register_model as jax_wo,
)
from stateright_tpu_torch.actor.write_once_register import WORegisterClient
from stateright_tpu_torch.models import write_once_register as port_wo
from stateright_tpu_torch.models.linearizable_register import abd_model
from stateright_tpu_torch.models.single_copy_register import single_copy_model
from stateright_tpu_torch.models.write_once_register import wo_register_model
from stateright_tpu_torch.parallel.actor_compiler import (
    CompiledActorTensor,
    CompileError,
    compile_actor_model,
)
from stateright_tpu_torch.semantics import WORegister
from test_torch_actor_compiler import assert_same_compile, engine_pair
from test_torch_paxos import as_rows, bfs_levels, check_twin_against_jax

WO21 = (97, 71)


def build(name, per_channel=False):
    """(port, JAX) models of ``name``."""
    if name == "wo-2-1":
        m, jm = wo_register_model(2, 1), jax_wo(2, 1)
    elif name == "wo-2-2":
        m, jm = wo_register_model(2, 2), jax_wo(2, 2)
    elif name == "sc-2-1-put2":
        m = single_copy_model(2, 1, put_count=2)
        jm = jax_single_copy(2, 1, put_count=2)
    elif name == "sc-2-2-put2":
        m = single_copy_model(2, 2, put_count=2)
        jm = jax_single_copy(2, 2, put_count=2)
    elif name == "abd-2-2-put2":
        m, jm = abd_model(2, 2, put_count=2), jax_abd(2, 2, put_count=2)
    else:
        raise ValueError(name)
    m.per_channel_(per_channel)
    jm.per_channel_(per_channel)
    return m, jm


# ---------------------------------------------------------------------------
# the spec and the codecs
# ---------------------------------------------------------------------------


def test_wo_register_spec():
    r = WORegister()
    r1, ret = r.invoke(("write", "A"))
    assert ret == ("write_ok",) and r1 == WORegister("A")
    assert r1.invoke(("write", "B")) == (r1, ("write_fail",))
    assert r1.invoke(("write", "A")) == (r1, ("write_ok",))
    assert r1.invoke(("read",)) == (r1, ("read_ok", "A"))
    assert r.is_valid_step(("write", "B"), ("write_fail",))[0] is False
    assert r1.is_valid_step(("write", "B"), ("write_fail",)) == (True, r1)


# ---------------------------------------------------------------------------
# the compilers' tables and steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["wo-2-1", "wo-2-2"])
@pytest.mark.parametrize("per_channel", [False, True])
def test_init_rows_and_code_tables_equal_jax(name, per_channel):
    m, jm = build(name, per_channel)
    tm, jtm = m.tensor_model(), jm.tensor_model()
    assert isinstance(tm, CompiledActorTensor)
    assert_same_compile(tm, jtm)
    assert tm.hist.strategy == jtm.hist.strategy == "table"
    np.testing.assert_array_equal(tm.hist.table_keys, jtm.hist.table_keys)
    np.testing.assert_array_equal(tm.hist.table_ok, jtm.hist.table_ok)
    if name.startswith("wo"):
        assert "h0_wfail" in tm.pk.layout
    else:
        assert "h0_snap1" in tm.pk.layout


@pytest.mark.parametrize("name,levels", [("wo-2-1", None), ("wo-2-2", None)])
@pytest.mark.parametrize("per_channel", [False, True])
def test_step_rows_and_masks_match_jax(name, levels, per_channel):
    """Every state (wo(2,2)'s ``linearizable`` verdict is False on some
    rows): successors, validity and masks equal the JAX twin's and the
    object model's."""
    m, jm = build(name, per_channel)
    states = [s for lvl in bfs_levels(m, levels) for s in lvl]
    tm = m._tensor_cached()
    for s, row in zip(states, as_rows(tm, states)):
        assert tm.decode_state(row) == s
    valid, masks = check_twin_against_jax(m, jm, states, as_rows(tm, states),
                                          True)
    if name in ("wo-2-2", "sc-2-2-put2"):
        assert not masks[:, 0].all()


# ---------------------------------------------------------------------------
# engine parity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,capacity,batch,counts", [
    ("wo-2-1", 1 << 10, 1 << 5, WO21),
])
@pytest.mark.parametrize("per_channel", [False, True])
def test_engine_matches_jax_engine(name, capacity, batch, counts,
                                   per_channel):
    m, jm = build(name, per_channel)
    t = engine_pair(m, jm, capacity, batch)
    assert (t.state_count(), t.unique_state_count()) == counts
    assert sorted(t.discoveries()) == ["value chosen"]


def test_wo_two_servers_violation_matches_jax_engine():
    m, jm = build("wo-2-2")
    t = engine_pair(m, jm, 1 << 10, 1 << 5)
    assert sorted(t.discoveries()) == ["linearizable", "value chosen"]
    final = t.discovery("linearizable").final_state()
    assert not final.history.is_consistent()


# ---------------------------------------------------------------------------
# what still raises
# ---------------------------------------------------------------------------


def test_wo_rejects_put2():
    """Write-once workloads stay ``put_count=1`` (a failed write changes
    which op takes effect; the multi-op codec models write_ok returns)."""
    m = wo_register_model(2, 1)
    for a in m.actors:
        if isinstance(a, WORegisterClient):
            a.put_count = 2
    with pytest.raises(CompileError, match="put_count"):
        compile_actor_model(m)


def test_check_gpu_verb_raises_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the verb would run")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_wo.main(["check-gpu", "2", "1", "--per-channel"])
    assert port_wo.main(["check"]) == 2
    assert "usage" in capsys.readouterr().err
