"""The port's fingerprint (``stateright_tpu_torch.ops.hashing`` and
``fingerprint``) against the JAX package's, bit for bit: the same numpy
rows, made from a seed, go through both.  Tolerance 0 — these are the
same integers."""

import importlib

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from stateright_tpu.ops import hashing as jh
from stateright_tpu_torch import fingerprint as tfp
from stateright_tpu_torch.ops import hashing as th

# the package re-exports a function named ``fingerprint`` over the module
jfp = importlib.import_module("stateright_tpu.fingerprint")

EMPTY = np.uint64(0xFFFFFFFFFFFFFFFF)


def as_torch(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int64))


def as_u64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


def special_rows(rng, n, width):
    """Random words, with top-bit words, zeros and EMPTY words mixed in."""
    rows = rng.integers(0, 1 << 64, size=(n, width), dtype=np.uint64)
    pick = rng.random((n, width))
    rows[pick < 0.1] = np.uint64(0)
    rows[(pick >= 0.1) & (pick < 0.2)] = EMPTY
    rows[(pick >= 0.2) & (pick < 0.3)] |= np.uint64(1 << 63)
    return rows


@pytest.mark.parametrize("width", [1, 2, 5])
def test_row_hash_matches_jax_and_host(width):
    rng = np.random.default_rng(100 + width)
    rows = special_rows(rng, 512, width)
    want = np.asarray(jh.row_hash(jnp.asarray(rows)))
    got = as_u64(th.row_hash(as_torch(rows)))
    np.testing.assert_array_equal(got, want)
    for i in range(0, 512, 37):
        assert int(got[i]) == jfp.hash_words(int(w) for w in rows[i])
        assert int(got[i]) == tfp.hash_words(int(w) for w in rows[i])


def test_row_hash_valid_mask_matches_engine_masking():
    """``row_hash(rows, valid)`` is the engine's
    ``jnp.where(valid, row_hash(rows), EMPTY)``, over a [B, A, W] stack."""
    rng = np.random.default_rng(7)
    rows = special_rows(rng, 64 * 9, 2).reshape(64, 9, 2)
    valid = rng.random((64, 9)) < 0.4
    want = np.asarray(
        jnp.where(jnp.asarray(valid), jh.row_hash(jnp.asarray(rows)), jh.EMPTY)
    )
    got = as_u64(th.row_hash(as_torch(rows), torch.from_numpy(valid)))
    np.testing.assert_array_equal(got, want)
    assert (got[~valid] == EMPTY).all()


def test_int64_constants_carry_the_reference_bits():
    mask = (1 << 64) - 1
    assert th.GAMMA & mask == int(jh._GAMMA)
    assert th.M1 & mask == int(jh._M1)
    assert th.M2 & mask == int(jh._M2)
    assert th.SEED & mask == int(jh._SEED)
    assert th.EMPTY & mask == int(jh.EMPTY)
    assert th.to_i64(int(jh.EMPTY)) == th.EMPTY == -1


def test_mix64_matches_jax_and_numpy_mirror():
    rng = np.random.default_rng(3)
    x = rng.integers(0, 1 << 64, size=4096, dtype=np.uint64)
    x[:4] = [0, 1, EMPTY, np.uint64(1 << 63)]
    want = np.asarray(jh.mix64(jnp.asarray(x)))
    np.testing.assert_array_equal(as_u64(th.mix64(as_torch(x))), want)
    np.testing.assert_array_equal(th.mix64_np(x), jh.mix64_np(x))
    for v in x[:64]:
        assert int(th.mix64_np(v)) == jfp.mix64(int(v)) == tfp.mix64(int(v))


def test_lshr_is_a_logical_shift():
    rng = np.random.default_rng(11)
    x = rng.integers(0, 1 << 64, size=256, dtype=np.uint64)
    t = as_torch(x)
    for k in (0, 1, 27, 30, 31, 63, 64):
        want = x >> np.uint64(k) if k < 64 else np.zeros_like(x)
        np.testing.assert_array_equal(as_u64(th.lshr(t, k)), want)


@pytest.mark.parametrize(
    "obj",
    [
        None, True, 7, -3, 1 << 70, 2.5, "stateright", b"\x00\x01",
        (1, "a", (None,)), [1, 2], frozenset({1, 2, 3}), {"k": (1, 2)},
    ],
)
def test_structural_fingerprint_matches_reference(obj):
    assert tfp.fingerprint(obj) == jfp.fingerprint(obj)
    assert tfp.stable_hash(obj) == jfp.stable_hash(obj)
