"""``put_count >= 2`` register workloads in the port
(``MultiOpLinHistoryCodec`` and the compiler's multi-op history fields)
against the JAX package, tolerance 0:

 - the multi-op codec's table, round trips, verdicts, key packing and
   device lookup (``tests/test_actor_compiler.py:71``);
 - both compilers' tables, history tables and init rows, and
   ``step_rows``/``property_masks`` on crawled rows, in both network
   packings;
 - the engine against ``spawn_tpu(sync=True)``:
   single-copy(2,1,put_count=2) at 483 / 369 in both packings and
   ABD(2,2,put_count=2) at 2,980 unique
   (``tests/test_actor_compiler.py:169``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stateright_tpu.parallel.history_tensor import (
    MultiOpLinHistoryCodec as JaxMultiOpCodec,
)
from stateright_tpu_torch.parallel.history_tensor import (
    MultiOpLinHistoryCodec,
)
from test_torch_write_once import (
    build,
    test_engine_matches_jax_engine as engine_case,
    test_init_rows_and_code_tables_equal_jax as tables_case,
    test_step_rows_and_masks_match_jax as crawl_case,
)
from test_torch_actor_compiler import engine_pair

SC21_PUT2 = (483, 369)
ABD22_PUT2_UNIQUE = 2_980


def test_multiop_codec_roundtrip_and_verdicts():
    """put_count=2 codec (the port of ``tests/test_actor_compiler.py:71``):
    the table equals the JAX codec's; every 10th enumerated joint state
    round-trips fields → tester → fields with the live tester's verdict;
    the device key packing and lookup agree with JAX on every key."""
    hc = MultiOpLinHistoryCodec([2, 3], [["A", "Z"], ["B", "Y"]], "\0")
    jc = JaxMultiOpCodec([2, 3], [["A", "Z"], ["B", "Y"]], "\0")
    assert hc.K == 2 and len(hc.table_keys) == 2016
    np.testing.assert_array_equal(hc.table_keys, jc.table_keys)
    np.testing.assert_array_equal(hc.table_ok, jc.table_ok)
    fields_all = []
    for idx in range(len(hc.table_keys)):
        key = int(hc.table_keys[idx])
        fields = []
        for i in range(hc.C):
            word = (key >> (i * hc.thread_bits)) & ((1 << hc.thread_bits) - 1)
            phase = word & ((1 << hc.phase_bits) - 1)
            off = hc.phase_bits
            snaps = []
            for _ in range(hc.K):
                snaps.append((word >> off) & ((1 << hc.snap_bits) - 1))
                off += hc.snap_bits
            rval = (word >> off) & ((1 << hc.rval_bits) - 1)
            fields.append((phase, tuple(snaps), rval))
        fields_all.append(fields)
        if idx % 10 == 0:
            tester = hc.tester_of_fields(fields)
            assert hc.fields_of_tester(tester) == fields
            assert hc.key_of_fields(fields) == key
            assert bool(hc.table_ok[idx]) == tester.is_consistent()
            assert repr(jc.tester_of_fields(fields)) == repr(tester)
    phases = np.asarray([[f[0] for f in fs] for fs in fields_all], np.int64)
    snaps = np.asarray([[f[1] for f in fs] for fs in fields_all], np.int64)
    rvals = np.asarray([[f[2] for f in fs] for fs in fields_all], np.int64)
    keys = hc.device_key(*(torch.from_numpy(x) for x in (phases, snaps,
                                                            rvals)))
    jkeys = jc.device_key(*(jnp.asarray(x.astype(np.int32))
                            for x in (phases, snaps, rvals)))
    np.testing.assert_array_equal(keys.numpy(), np.asarray(jkeys))
    np.testing.assert_array_equal(keys.numpy(), hc.table_keys)
    probe = torch.cat([keys, keys + (1 << 60)])
    got = hc.device_lookup(probe).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jc.device_lookup(jnp.asarray(probe.numpy()))))
    np.testing.assert_array_equal(got[:len(keys)], hc.table_ok)
    assert not got[len(keys):].any()


@pytest.mark.parametrize("name", ["sc-2-1-put2", "abd-2-2-put2"])
@pytest.mark.parametrize("per_channel", [False, True])
def test_init_rows_and_code_tables_equal_jax(name, per_channel):
    tables_case(name, per_channel)


@pytest.mark.parametrize("name,levels", [("sc-2-2-put2", None),
                                         ("abd-2-2-put2", 5)])
@pytest.mark.parametrize("per_channel", [False, True])
def test_step_rows_and_masks_match_jax(name, levels, per_channel):
    """Every state of single-copy(2,2,put_count=2), whose ``linearizable``
    verdict is False on some rows, and the first 5 levels of ABD."""
    crawl_case(name, levels, per_channel)


@pytest.mark.parametrize("per_channel", [False, True])
def test_engine_matches_jax_engine(per_channel):
    engine_case("sc-2-1-put2", 1 << 12, 1 << 7, SC21_PUT2, per_channel)


def test_abd_put2_matches_jax_engine():
    """ABD with two puts per client (``tests/test_actor_compiler.py:169``):
    2,980 unique, ABD stays linearizable."""
    m, jm = build("abd-2-2-put2")
    t = engine_pair(m, jm, 1 << 14, 1 << 9)
    assert t.unique_state_count() == ABD22_PUT2_UNIQUE
    assert sorted(t.discoveries()) == ["value chosen"]
