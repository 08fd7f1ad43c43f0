"""The port's bucketized insert (``stateright_tpu_torch.ops.buckets``)
against the JAX package's ``bucket_insert``, bit for bit: the same seeded
numpy batches — duplicates, EMPTY lanes, a ``compact`` budget, forced
bucket overflow and budget overflow — go through both, and the tables,
``sel[:n_new]``, ``n_new`` and both flags must be equal (tolerance 0)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from stateright_tpu.ops import buckets as jb
from stateright_tpu_torch.ops import buckets as tb

EMPTY = np.uint64(0xFFFFFFFFFFFFFFFF)


def as_torch(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.uint64).view(np.int64))


def as_u64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


def random_batch(rng, m, dup_rate=0.3, empty_rate=0.2):
    fps = rng.integers(1, 1 << 64, size=m, dtype=np.uint64)
    dup = rng.random(m) < dup_rate
    fps[dup] = fps[rng.integers(0, m, size=int(dup.sum()))]
    fps[rng.random(m) < empty_rate] = EMPTY
    payloads = rng.integers(0, 1 << 64, size=m, dtype=np.uint64)
    return fps, payloads


class Pair:
    """One table held by both implementations."""

    def __init__(self, nbuckets):
        n = nbuckets * jb.SLOTS
        self.j = (jnp.full((n,), jb.EMPTY, jnp.uint64), jnp.zeros((n,), jnp.uint64))
        self.t = (torch.full((n,), -1, dtype=torch.int64),
                  torch.zeros(n, dtype=torch.int64))

    def insert(self, fps, payloads, compact=None, window=64):
        rj = jb.bucket_insert(*self.j, jnp.asarray(fps), jnp.asarray(payloads),
                              window=window, compact=compact)
        rt = tb.bucket_insert(*self.t, as_torch(fps), as_torch(payloads),
                              compact=compact)
        self.j, self.t = rj[:2], rt[:2]
        n_new = int(rj[3])
        assert int(rt[3]) == n_new
        assert bool(rt[4]) == bool(rj[4])  # overflow
        assert bool(rt[5]) == bool(rj[5])  # cand_overflow
        np.testing.assert_array_equal(
            rt[2].numpy()[:n_new], np.asarray(rj[2])[:n_new]
        )
        self.check_tables()
        return n_new, bool(rj[4]), bool(rj[5])

    def check_tables(self):
        np.testing.assert_array_equal(as_u64(self.t[0]), np.asarray(self.j[0]))
        np.testing.assert_array_equal(as_u64(self.t[1]), np.asarray(self.j[1]))


@pytest.mark.parametrize("seed", [0, 1])
def test_random_batches_match_jax(seed):
    rng = np.random.default_rng(seed)
    pair = Pair(64)
    total = 0
    for _ in range(5):
        fps, payloads = random_batch(rng, 160)
        n_new, ovf, covf = pair.insert(fps, payloads)
        assert not covf
        total += n_new
    assert total > 0


@pytest.mark.parametrize("seed", [0, 1])
def test_compact_budget_matches_jax(seed):
    rng = np.random.default_rng(10 + seed)
    pair = Pair(128)
    for _ in range(4):
        fps, payloads = random_batch(rng, 512, empty_rate=0.85)
        n_new, ovf, covf = pair.insert(fps, payloads, compact=128)
        assert not covf and n_new > 0


def test_cand_overflow_matches_jax_and_writes_nothing():
    rng = np.random.default_rng(5)
    pair = Pair(64)
    fps, payloads = random_batch(rng, 256, empty_rate=0.0, dup_rate=0.0)
    before = as_u64(pair.t[0]).copy()
    n_new, ovf, covf = pair.insert(fps, payloads, compact=64)
    assert covf and n_new == 0
    np.testing.assert_array_equal(as_u64(pair.t[0]), before)


def test_bucket_overflow_matches_jax_and_writes_nothing():
    nbuckets = 4
    colliding, x = [], 1
    while len(colliding) < jb.SLOTS + 1:  # > SLOTS fps in bucket 0
        if int(jb.bucket_of(np.uint64(x), nbuckets)) == 0:
            colliding.append(x)
        x += 1
    fps = np.asarray(colliding + [int(EMPTY)] * 3, np.uint64)
    pair = Pair(nbuckets)
    n_new, ovf, covf = pair.insert(fps, fps ^ np.uint64(9))
    assert ovf and n_new == 0
    assert (as_u64(pair.t[0]) == EMPTY).all()
    # one fewer fits exactly
    n_new, ovf, _ = pair.insert(fps[: jb.SLOTS], fps[: jb.SLOTS])
    assert not ovf and n_new == jb.SLOTS


def test_duplicates_of_table_entries_are_not_novel():
    rng = np.random.default_rng(9)
    pair = Pair(32)
    fps, payloads = random_batch(rng, 96)
    pair.insert(fps, payloads)
    again = fps.copy()
    rng.shuffle(again)
    n_new, _, _ = pair.insert(again, payloads)
    assert n_new == 0


def test_probe_plain_matches_line_scan():
    rng = np.random.default_rng(4)
    pair = Pair(16)
    fps, payloads = random_batch(rng, 96)
    pair.insert(fps, payloads)
    tfp = pair.t[0]
    sfp = as_torch(np.concatenate([fps[:40], [EMPTY] * 8]).astype(np.uint64))
    bucket = torch.from_numpy(tb.bucket_of(as_u64(sfp), 16))
    present, base = tb.bucket_probe_plain(tfp, sfp, bucket)
    lines = as_u64(tfp).reshape(16, jb.SLOTS)
    for i, f in enumerate(as_u64(sfp)):
        if f == EMPTY:
            assert not present[i] and base[i] == 0
            continue
        line = lines[int(bucket[i])]
        assert bool(present[i]) == bool((line == f).any())
        assert int(base[i]) == int((line != EMPTY).sum())


@pytest.mark.parametrize("nbuckets", [1, 4, 256, 1 << 12])
def test_bucket_of_matches_jax(nbuckets):
    rng = np.random.default_rng(nbuckets)
    fps = rng.integers(0, 1 << 64, size=2048, dtype=np.uint64)
    fps[0] = EMPTY
    np.testing.assert_array_equal(
        tb.bucket_of(fps, nbuckets), jb.bucket_of(fps, nbuckets)
    )
    key = tb.bucket_key(as_torch(fps))
    np.testing.assert_array_equal(
        as_u64(key), np.asarray(jb.bucket_key(jnp.asarray(fps)))
    )


def test_host_rehash_and_occupancy_match_jax():
    rng = np.random.default_rng(21)
    pair = Pair(64)
    for _ in range(3):
        pair.insert(*random_batch(rng, 200))
    tfp, tpl = as_u64(pair.t[0]), as_u64(pair.t[1])
    for nb in (128, 512):
        got = tb.host_bucket_rehash(tfp, tpl, nb)
        want = jb.host_bucket_rehash(tfp, tpl, nb)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    assert tb.occupancy_stats(tfp) == jb.occupancy_stats(tfp)


def _colliding(nbuckets, count, bucket=0):
    """``count`` fingerprints that all land in ``bucket``."""
    out, x = [], 1
    while len(out) < count:
        if int(jb.bucket_of(np.uint64(x), nbuckets)) == bucket:
            out.append(x)
        x += 1
    return np.asarray(out, np.uint64)


def _plan_case(case):
    """(nbuckets, prefill batches, fps, payloads, compact) for one case."""
    rng = np.random.default_rng(len(case))
    if case == "random":
        return 64, [random_batch(rng, 160)], *random_batch(rng, 300), None
    if case == "compact":
        return 128, [random_batch(rng, 200)], *random_batch(
            rng, 512, empty_rate=0.85), 128
    if case == "cand_overflow":  # budget exceeded, buckets fine
        return 64, [], *random_batch(rng, 256, empty_rate=0.0,
                                     dup_rate=0.0), 64
    if case == "overflow":  # one bucket past SLOTS, budget fine
        fps = np.concatenate([_colliding(4, jb.SLOTS + 1), [EMPTY] * 3])
        return 4, [], fps, fps ^ np.uint64(9), None
    if case == "all_present":  # every candidate is in the table: n_new = 0
        fps, payloads = random_batch(rng, 96)
        again = fps.copy()
        rng.shuffle(again)
        return 32, [(fps, payloads)], again, payloads, None
    raise ValueError(case)


@pytest.mark.parametrize(
    "case", ["random", "compact", "cand_overflow", "overflow", "all_present"]
)
def test_bucket_plan_plain_matches_jax_insert(case):
    """The plan's slots, fingerprints, payloads and ``sel`` on ``[:n_new]``,
    ``n_new`` and both flags, against what the JAX ``bucket_insert`` wrote:
    exactly the planned slots change, to the planned values."""
    nbuckets, prefill, fps, payloads, compact = _plan_case(case)
    pair = Pair(nbuckets)
    for batch in prefill:
        pair.insert(*batch)
    before = as_u64(pair.t[0]).copy()
    plan = tb.bucket_plan_plain(pair.t[0], *tb.sort_candidates(
        as_torch(fps), as_torch(payloads), nbuckets, compact))
    tgt, cfp, cpl, sel, n_new, overflow = plan
    rj = jb.bucket_insert(*pair.j, jnp.asarray(fps), jnp.asarray(payloads),
                          window=64, compact=compact)
    n = int(rj[3])
    assert int(n_new) == n
    assert bool(overflow) == bool(rj[4])
    cand_overflow = compact is not None and int((fps != EMPTY).sum()) > compact
    assert bool(rj[5]) == cand_overflow
    assert n == 0 if case in ("cand_overflow", "overflow", "all_present") else n > 0
    assert bool(overflow) == (case == "overflow")
    np.testing.assert_array_equal(sel.numpy()[:n], np.asarray(rj[2])[:n])
    t = tgt.numpy()[:n]
    jfp, jpl = np.asarray(rj[0]), np.asarray(rj[1])
    np.testing.assert_array_equal(np.sort(t), np.flatnonzero(jfp != before))
    np.testing.assert_array_equal(jfp[t], as_u64(cfp)[:n])
    np.testing.assert_array_equal(jpl[t], as_u64(cpl)[:n])
    np.testing.assert_array_equal(as_u64(cfp)[:n], fps[sel.numpy()[:n]])
