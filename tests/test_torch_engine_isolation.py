"""The port loads neither JAX nor the reference package: each model
family's run in a subprocess of its own (``test_torch_engine.py``'s
``ISOLATION_CASES`` and ``assert_isolated``); the flags' and services'
cases are in ``test_torch_engine_isolation_flags.py``."""

import pytest

from test_torch_engine import ISOLATION_CASES, assert_isolated

# the cases that run a model family plainly; every other case turns on a
# flag or a service
MODEL_FAMILIES = ("2pc", "paxos", "single-copy", "raft", "write-once",
                  "per-channel", "symmetry")


@pytest.mark.parametrize("family", MODEL_FAMILIES)
def test_port_run_loads_neither_jax_nor_the_reference(family):
    assert_isolated(ISOLATION_CASES[family])
