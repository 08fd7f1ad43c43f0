"""Per-channel paxos-2, the JAX package's ``bench.py`` leg
(``paxos_model(2, 3).per_channel_()``, ``capacity=1 << 16``,
``batch=512``), in the port: rows 83 words wide, 82 actions.

The twin's ``step_rows``/``property_masks`` equal the JAX twin's on the
first 6 BFS levels, and the engine gives the JAX test's pins (32,971
states / 16,668 unique, ``tests/test_per_channel.py:53``), with the "value
chosen" discovery replayed through the object model.  A JAX engine run of
this configuration is not repeated here: its compile alone outlasts the
file's budget on the CPU.
"""

import numpy as np

from stateright_tpu.models.paxos import paxos_model as jax_paxos
from stateright_tpu_torch.models.paxos import paxos_model
from test_torch_paxos import as_rows, bfs_levels, check_twin_against_jax

P2_FULL = (32_971, 16_668)


def per_channel(m):
    m.per_channel_()
    return m


def test_step_rows_and_masks_match_jax_on_paxos2_prefix():
    m, jm = per_channel(paxos_model(2)), per_channel(jax_paxos(2, 3))
    tm = m.tensor_model()
    assert (tm.width, tm.max_actions) == (83, 82)
    states = [s for lvl in bfs_levels(m, 6) for s in lvl]
    assert len(states) == 103
    valid, _ = check_twin_against_jax(m, jm, states, as_rows(tm, states),
                                      True)
    assert valid.sum() > len(states)


def test_bench_leg_gives_the_jax_pins():
    m = per_channel(paxos_model(2))
    c = m.checker().spawn_gpu(device="cpu", capacity=1 << 16,
                              batch=512).join()
    assert (c.state_count(), c.unique_state_count()) == P2_FULL
    assert sorted(c.discoveries()) == ["value chosen"]
    path = c.discovery("value chosen")
    assert m.property_by_name("value chosen").condition(m, path.final_state())
    # one table growth past a quarter load (2 = table full), as the
    # engine's clean-boundary trigger puts it
    assert [st for st, _ in c.growth_events] == [2]
    assert np.count_nonzero(c._table_np()[0] != np.uint64(2**64 - 1)) \
        == P2_FULL[1]
