"""The port loads neither JAX nor the reference package under its flags
and services: each case a subprocess of its own (``test_torch_engine.py``'s
``ISOLATION_CASES``, the ones ``test_torch_engine_isolation.py`` leaves
out)."""

import pytest

from test_torch_engine import ISOLATION_CASES, assert_isolated
from test_torch_engine_isolation import MODEL_FAMILIES


@pytest.mark.parametrize(
    "family", [f for f in ISOLATION_CASES if f not in MODEL_FAMILIES])
def test_port_run_loads_neither_jax_nor_the_reference(family):
    assert_isolated(ISOLATION_CASES[family])
