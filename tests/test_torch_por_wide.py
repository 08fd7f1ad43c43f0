"""Partial-order reduction at the width of the card's leg: per-channel
paxos-2 (W 83, A 82), against the JAX package, tolerance 0:

 - ``ample_mask`` equals JAX's on a seeded sample of 128 rows of a run
   bounded at 4,000 states;
 - the plan is pinned: 1,092 independent pairs, conflict sum 4,540, 38
   visible actions, K 2, and ``plan_digest`` of the JAX plan equals the
   constant ``chip_smoke.py`` holds the card's plan to, so a capture that
   drifts on the card's torch cannot pass unseen;
 - (``slow``) the JAX pin's run, 16,258 / 31,435 at capacity 2^15 and
   batch 256, equal to the JAX engine's.
"""

import re
from pathlib import Path

import numpy as np
import pytest

import torch

from stateright_tpu.analysis.independence import (
    por_plan as jax_por_plan, run_independence as jax_run_independence,
)
from stateright_tpu_torch import convert
from stateright_tpu_torch.analysis.independence import plan_digest
from test_torch_footprint import ample_pair, twins

REPO = Path(__file__).resolve().parent.parent


def test_ample_mask_equals_jax_on_per_channel_paxos2_rows():
    """A seeded sample of 128 rows of per-channel paxos-2 (from a run
    bounded at 4,000 states): the card's leg's shapes, W 83, A 82."""
    _, tm, _, _ = twins("pc-paxos2")
    c = tm.checker().target_states(4_000).spawn_gpu(device="cpu",
                                                    batch=256).join()
    tail = int(c._final_carry[convert.TAIL])
    pick = np.random.default_rng(2).choice(tail, size=128, replace=False)
    rows = c._final_carry[convert.QROWS][torch.from_numpy(np.sort(pick))]
    got, want, valid = ample_pair("pc-paxos2", rows)
    np.testing.assert_array_equal(got, want)
    assert (got != valid).any()



def test_plan_of_per_channel_paxos2_is_pinned():
    """The plan the card's ``por_pc_paxos2`` leg is held to, from the JAX
    package: its counts, and ``plan_digest`` of it equal to
    ``chip_smoke.py``'s constant."""
    jm, _, jt, _ = twins("pc-paxos2")
    rep = jax_run_independence(jt, list(jm.properties()))
    plan = jax_por_plan(jt, list(jm.properties()))
    assert (jt.width, jt.max_actions) == (83, 82)
    assert rep.independent_pairs == 1_092
    assert int(plan.conflict.sum()) == 4_540
    assert int(plan.visible.sum()) == 38
    assert plan.enablers.shape == (82, 2, 82)
    src = (REPO / "chip_smoke.py").read_text()
    pinned = re.search(r'PC_PAXOS2_PLAN_DIGEST = "([0-9a-f]+)"', src).group(1)
    assert plan_digest(plan) == pinned


@pytest.mark.slow
def test_per_channel_paxos2_por_run_matches_jax_engine(monkeypatch):
    """The JAX pin's run (tests/test_per_channel.py:54-61: capacity 2^15,
    batch 256): 16,258 / 31,435 in both engines, with equal tables, queue
    rows, traces and tallies (about 80 s on one CPU)."""
    import stateright_tpu.analysis.footprint as jfp
    from stateright_tpu.models import paxos as jpaxos
    from stateright_tpu_torch.models import paxos
    from test_torch_footprint import jax_conjunct_eval_fn, per_channel
    from test_torch_por import same_run

    monkeypatch.setattr(jfp, "conjunct_eval_fn", jax_conjunct_eval_fn)
    j = per_channel(jpaxos.paxos_model(2)).checker().por().spawn_tpu(
        sync=True, capacity=1 << 15, batch=256)
    t = per_channel(paxos.paxos_model(2)).checker().por().spawn_gpu(
        device="cpu", capacity=1 << 15, batch=256).join()
    assert (t.unique_state_count(), t.state_count()) == (16_258, 31_435)
    same_run(t, j)
    assert t.por_status() == j.por_status()
