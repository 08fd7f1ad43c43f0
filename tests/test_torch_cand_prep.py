"""The port's candidate preparation (``stateright_tpu_torch.ops.cand_prep``)
against the JAX package, bit for bit (tolerance 0): the same seeded numpy
successor rows, valid masks and parent fingerprints go through
``cand_prep_plain`` and through the JAX composition it stands for —
``jnp.where(valid, row_hash(rows), EMPTY)``, ``lane_compact`` (the budget
compaction of ``bucket_insert``) and ``bucket_key`` — and every output
lane, ``n_valid`` and the overflow flag must be equal."""

import shutil

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from stateright_tpu.ops import buckets as jb
from stateright_tpu.ops import hashing as jh
from stateright_tpu_torch.ops import _cuda
from stateright_tpu_torch.ops import buckets as tb
from stateright_tpu_torch.ops import cand_prep as cp
from stateright_tpu_torch.ops.hashing import row_hash_plain

EMPTY = np.uint64(0xFFFFFFFFFFFFFFFF)
SIGN = np.uint64(1 << 63)


def as_torch(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.uint64).view(np.int64))


def as_u64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


def make_inputs(seed, parents, arity, width, valid_rate):
    """Successor rows (with zero, EMPTY and top-bit words), their valid
    mask and the parents' fingerprints."""
    rng = np.random.default_rng(seed)
    m = parents * arity
    rows = rng.integers(0, 1 << 64, size=(m, width), dtype=np.uint64)
    pick = rng.random((m, width))
    rows[pick < 0.1] = 0
    rows[(pick >= 0.1) & (pick < 0.2)] = EMPTY
    rows[(pick >= 0.2) & (pick < 0.3)] |= SIGN
    valid = rng.random(m) < valid_rate
    pfps = rng.integers(1, 1 << 64, size=parents, dtype=np.uint64)
    return rows, valid, pfps


def jax_prep(rows, valid, pfps, arity, cb):
    """The JAX package's functions, composed as the engine composes them."""
    fps = jnp.where(jnp.asarray(valid), jh.row_hash(jnp.asarray(rows)),
                    jh.EMPTY)
    idx, live, count = jb.lane_compact(fps != jh.EMPTY, cb)
    cfp = jnp.where(live, fps[idx], jh.EMPTY)
    par = jnp.broadcast_to(jnp.asarray(pfps)[:, None],
                           (pfps.size, arity)).reshape(-1)
    return (np.asarray(cfp), np.asarray(par[idx]), np.asarray(idx),
            np.asarray(jb.bucket_key(cfp)), int(count))


def assert_matches_jax(rows, valid, pfps, arity, cb):
    got = cp.cand_prep_plain(as_torch(rows), torch.from_numpy(valid),
                             as_torch(pfps), arity, cb)
    fp, payload, cidx, key, n_valid, overflow = got
    wfp, wpl, widx, wkey, count = jax_prep(rows, valid, pfps, arity, cb)
    for t in got[:4]:
        assert t.dtype == torch.int64 and t.shape == (cb,)
    np.testing.assert_array_equal(as_u64(fp), wfp)
    np.testing.assert_array_equal(as_u64(payload), wpl)
    np.testing.assert_array_equal(cidx.numpy(), widx.astype(np.int64))
    np.testing.assert_array_equal(as_u64(key) ^ SIGN, wkey)
    assert n_valid.dtype == torch.int64 and n_valid.dim() == 0
    assert int(n_valid) == count == int(valid.sum())
    assert bool(overflow) == (count > cb)
    return count


@pytest.mark.parametrize("width", [1, 2, 5])
@pytest.mark.parametrize("arity", [1, 3, 37])
def test_plain_matches_jax(width, arity):
    parents = 50
    rows, valid, pfps = make_inputs(width * 100 + arity, parents, arity,
                                    width, 0.3)
    m = parents * arity
    count = assert_matches_jax(rows, valid, pfps, arity, max(1, m // 2))
    assert 0 < count <= m // 2


@pytest.mark.parametrize("case", [
    "no_valid", "all_valid", "n_valid_is_cb", "n_valid_is_cb_plus_1",
    "cb_is_m",
])
def test_plain_matches_jax_at_the_edges(case):
    parents, arity, width = 40, 7, 2
    m = parents * arity
    rows, valid, pfps = make_inputs(len(case), parents, arity, width, 0.4)
    nv = int(valid.sum())
    cb = {"no_valid": 64, "all_valid": m, "n_valid_is_cb": nv,
          "n_valid_is_cb_plus_1": nv - 1, "cb_is_m": m}[case]
    if case == "no_valid":
        valid[:] = False
    elif case == "all_valid":
        valid[:] = True
    count = assert_matches_jax(rows, valid, pfps, arity, cb)
    assert (count > cb) == (case == "n_valid_is_cb_plus_1")


@pytest.mark.parametrize("nbuckets", [1, 2, 32, 1 << 20])
def test_sort_prepared_matches_jax_sort_and_buckets(nbuckets):
    """The one stable sort of the engine: the permutation is the JAX
    ``argsort`` of the unsigned key, and each bucket its high bits."""
    parents, arity = 64, 5
    rows, valid, pfps = make_inputs(nbuckets, parents, arity, 1, 0.5)
    fp, payload, cidx, key, _, _ = cp.cand_prep_plain(
        as_torch(rows), torch.from_numpy(valid), as_torch(pfps), arity, 200)
    sfp, spl, bucket, order = cp.sort_prepared(fp, payload, key, nbuckets)
    jkey = jnp.asarray(as_u64(key) ^ SIGN)
    jorder = np.asarray(jnp.argsort(jkey))
    np.testing.assert_array_equal(order.numpy(), jorder)
    bits = nbuckets.bit_length() - 1
    skey = np.asarray(jkey)[jorder]
    want = (skey >> np.uint64(64 - bits)).astype(np.int64) if bits else 0 * skey
    np.testing.assert_array_equal(bucket.numpy(), want)
    np.testing.assert_array_equal(sfp.numpy(), fp.numpy()[jorder])
    np.testing.assert_array_equal(spl.numpy(), payload.numpy()[jorder])


@pytest.mark.parametrize("cb", ["m", "n_valid"])
def test_compacted_plan_equals_uncompacted_plan(cb):
    """Compacting (as the engine now always does, CB == M included) plans
    the same insert as not compacting: the same slots, fingerprints,
    payloads and original indices on ``[:n_new]``, the same ``n_new``."""
    parents, arity, nbuckets = 60, 9, 128
    rows, valid, pfps = make_inputs(cb == "m", parents, arity, 1, 0.3)
    m = parents * arity
    rng = np.random.default_rng(3)
    tfp = torch.full((nbuckets * tb.SLOTS,), -1, dtype=torch.int64)
    tpl = torch.zeros_like(tfp)
    pre = as_torch(rng.integers(1, 1 << 64, size=150, dtype=np.uint64))
    tb.bucket_insert(tfp, tpl, pre, pre)
    # half of the batch's successors are in the table already
    rows[::2] = rows[1::2]
    tb.bucket_insert(tfp, tpl, row_hash_plain(as_torch(rows[1::4])),
                     pre[:rows[1::4].shape[0]])
    budget = m if cb == "m" else int(valid.sum())
    fp, payload, cidx, key, _, covf = cp.cand_prep_plain(
        as_torch(rows), torch.from_numpy(valid), as_torch(pfps), arity, budget)
    got = tb.bucket_plan_plain(
        tfp, *cp.sort_prepared(fp, payload, key, nbuckets), cidx, covf)
    par = as_torch(np.repeat(pfps, arity))
    want = tb.bucket_plan_plain(tfp, *tb.sort_candidates(
        row_hash_plain(as_torch(rows), torch.from_numpy(valid)), par,
        nbuckets))
    n = int(want[4])
    assert int(got[4]) == n > 0 and bool(got[5]) == bool(want[5])
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g.numpy()[:n], w.numpy()[:n])


def test_build_digest_covers_shared_headers(tmp_path, monkeypatch):
    """An edit to a shared header names another library, so a stale one is
    never loaded; only the ``.cu`` files are compiled."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_cuda.CSRC, csrc)
    monkeypatch.setattr(_cuda, "CSRC", csrc)
    assert {p.name for p in _cuda.sources()} >= {"cand_prep.cu", "row_hash.cu"}
    assert all(p.suffix == ".cu" for p in _cuda.sources())
    before = _cuda.library_path()
    header = csrc / "splitmix.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _cuda.library_path() != before
