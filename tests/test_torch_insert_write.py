"""The plain commit of kernel ``insert_commit``
(``stateright_tpu_torch.ops.insert_commit``): its table half against the
JAX package's Pallas insert kernel
(``stateright_tpu.ops.pallas_insert.pallas_scatter_insert``), which runs
in Pallas interpret mode on the CPU as ``tests/test_pallas_insert.py``
runs it, and its queue half against the append's contract.  The same
seeded numpy inputs go through both; results must be equal (tolerance
0).  M stays at 1024 or less to keep the fast tier."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from stateright_tpu.ops.pallas_insert import pallas_scatter_insert
from stateright_tpu_torch.ops import _cuda
from stateright_tpu_torch.ops.insert_commit import (
    COMMIT_THREADS,
    COMMIT_TILE_WORDS,
    QueueAppend,
    commit_tile,
    insert_commit,
    insert_commit_plain,
    insert_write_plain,
)

EMPTY = np.uint64(0xFFFFFFFFFFFFFFFF)


def as_torch(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.uint64).view(np.int64))


def case(rng, nslots, m, n_new):
    """A table with some entries, and ``n_new`` distinct free target slots
    as the prefix of an M-lane candidate window (pad lanes -> nslots)."""
    tfp = np.full(nslots, EMPTY, np.uint64)
    tpl = np.zeros(nslots, np.uint64)
    used = rng.choice(nslots, size=nslots // 8, replace=False)
    tfp[used] = rng.integers(0, 1 << 64, size=used.size, dtype=np.uint64)
    tpl[used] = rng.integers(0, 1 << 64, size=used.size, dtype=np.uint64)
    free = np.setdiff1d(np.arange(nslots), used)
    tgt = np.full(m, nslots, np.int32)
    tgt[:n_new] = rng.choice(free, size=n_new, replace=False)
    cfp = rng.integers(0, 1 << 64, size=m, dtype=np.uint64)
    cpl = rng.integers(0, 1 << 64, size=m, dtype=np.uint64)
    return tfp, tpl, tgt, cfp, cpl


@pytest.mark.parametrize("nslots,m,n_new", [(4096, 1024, 700), (2048, 256, 0)])
def test_plain_write_matches_pallas_kernel(nslots, m, n_new):
    rng = np.random.default_rng(nslots + m + n_new)
    tfp, tpl, tgt, cfp, cpl = case(rng, nslots, m, n_new)
    jf, jp = pallas_scatter_insert(
        jnp.asarray(tfp), jnp.asarray(tpl), jnp.asarray(tgt),
        jnp.asarray(cfp), jnp.asarray(cpl), jnp.int32(n_new),
    )
    tf, tp = as_torch(tfp), as_torch(tpl)
    out = insert_commit(
        tf, tp, torch.from_numpy(tgt.astype(np.int64)), as_torch(cfp),
        as_torch(cpl), torch.tensor(n_new, dtype=torch.int64),
    )
    assert out[0] is tf and out[1] is tp  # in place
    np.testing.assert_array_equal(tf.numpy().view(np.uint64), np.asarray(jf))
    np.testing.assert_array_equal(tp.numpy().view(np.uint64), np.asarray(jp))


def test_plain_write_ignores_lanes_past_n_new():
    """Lanes at or past ``n_new`` are never written, even when they carry
    real slots (a blocked insert forces ``n_new`` to 0)."""
    rng = np.random.default_rng(2)
    tfp, tpl, tgt, cfp, cpl = case(rng, 1024, 128, 100)
    tf, tp = as_torch(tfp), as_torch(tpl)
    insert_write_plain(
        tf, tp, torch.from_numpy(tgt.astype(np.int64)), as_torch(cfp),
        as_torch(cpl), torch.tensor(40, dtype=torch.int64),
    )
    got = tf.numpy().view(np.uint64)
    np.testing.assert_array_equal(got[tgt[:40]], cfp[:40])
    np.testing.assert_array_equal(got[tgt[40:100]], tfp[tgt[40:100]])


def test_commit_tile_is_the_kernels_tile():
    """``commit_tile``, which the card tests size their tile edges by,
    reads the constants of ``csrc/insert_commit.cu``: 256 threads a CTA,
    tiles of 1,024 row words, at least 1 and at most 256 lanes."""
    import re

    src = (_cuda.CSRC / "insert_commit.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert (const("kThreads"), const("kTileWords")) == (COMMIT_THREADS,
                                                       COMMIT_TILE_WORDS)
    got = [commit_tile(w) for w in (0, 1, 4, 5, 21, 33, 83, 700, 2048)]
    assert got == [256, 256, 256, 204, 48, 31, 12, 1, 1]


def jax_append_novel(qrows, qfp, qebits, qdepth, tail, sel, crows, cfp,
                     cebt, cdep):
    """The JAX engine's plain ``append_novel``
    (``stateright_tpu/parallel/wavefront.py:369``): the ``sel`` window of
    the candidate stack written at ``tail`` by ``dynamic_update_slice``
    (the rows past ``n_new`` in it are garbage the engine overwrites)."""
    import jax

    tail = jnp.int32(tail)
    sel = jnp.asarray(sel)
    return (
        jax.lax.dynamic_update_slice(jnp.asarray(qrows),
                                     jnp.asarray(crows)[sel],
                                     (tail, jnp.int32(0))),
        jax.lax.dynamic_update_slice(jnp.asarray(qfp), jnp.asarray(cfp)[sel],
                                     (tail,)),
        jax.lax.dynamic_update_slice(jnp.asarray(qebits),
                                     jnp.asarray(cebt)[sel], (tail,)),
        jax.lax.dynamic_update_slice(jnp.asarray(qdepth),
                                     jnp.asarray(cdep)[sel], (tail,)),
    )


@pytest.mark.parametrize("width", [1, 3, 21, 33, 83])
def test_commit_plain_appends_the_written_lanes_to_the_queue(width):
    """The queue half: row ``tail + j`` gets candidate ``sel[j]``, its
    fingerprint and its parent's ebits and depth + 1 (parent ``sel[j] //
    arity``), for ``j < n_new`` only, at the engines' row widths (2pc 1,
    single-copy-4 21, paxos-3 33, per-channel paxos-2 83): the rows
    ``[tail, tail + n_new)`` equal the JAX engine's ``append_novel`` on the
    same candidates, and no other row changes; the table half is the
    Pallas kernel's write, as above."""
    rng = np.random.default_rng(3 + width)
    nslots, m, n_new, arity, q, tail = 2048, 256, 90, 4, 600, 37
    tfp, tpl, tgt, cfp, cpl = case(rng, nslots, m, n_new)
    jf, jp = pallas_scatter_insert(
        jnp.asarray(tfp), jnp.asarray(tpl), jnp.asarray(tgt),
        jnp.asarray(cfp), jnp.asarray(cpl), jnp.int32(n_new),
    )
    src = rng.integers(-(1 << 62), 1 << 62, size=(m, width))
    sel = rng.permutation(m)
    pebits = rng.integers(-(1 << 31), 1 << 31, size=m // arity).astype(np.int32)
    pdepth = rng.integers(0, 100, size=m // arity).astype(np.int32)
    qrows0 = rng.integers(-(1 << 62), 1 << 62, size=(q, width))
    queue = QueueAppend(
        torch.from_numpy(qrows0.copy()), torch.full((q,), -1),
        torch.zeros(q, dtype=torch.int32), torch.zeros(q, dtype=torch.int32),
        torch.tensor(tail), torch.from_numpy(sel), torch.from_numpy(src),
        torch.from_numpy(pebits), torch.from_numpy(pdepth), arity,
    )
    tf, tp = as_torch(tfp), as_torch(tpl)
    insert_commit_plain(
        tf, tp, torch.from_numpy(tgt.astype(np.int64)), as_torch(cfp),
        as_torch(cpl), torch.tensor(n_new), queue,
    )
    np.testing.assert_array_equal(tf.numpy().view(np.uint64), np.asarray(jf))
    np.testing.assert_array_equal(tp.numpy().view(np.uint64), np.asarray(jp))
    rows = slice(tail, tail + n_new)
    s = sel[:n_new]
    # the JAX engine's per-candidate lanes: each candidate's fingerprint
    # (the plan gives lane j the one of candidate sel[j]) and its parent's
    # ebits and depth + 1, broadcast over the parent's arity
    cand_fp = np.zeros(m, np.uint64)
    cand_fp[s] = cfp[:n_new]
    want = jax_append_novel(
        qrows0, np.full(q, EMPTY, np.uint64), np.zeros(q, np.int32),
        np.zeros(q, np.int32), tail, sel, src, cand_fp,
        np.repeat(pebits, arity), np.repeat(pdepth + 1, arity))
    np.testing.assert_array_equal(queue.rows.numpy()[rows],
                                  np.asarray(want[0])[rows])
    np.testing.assert_array_equal(queue.fps.numpy()[rows].view(np.uint64),
                                  np.asarray(want[1])[rows])
    np.testing.assert_array_equal(queue.ebits.numpy()[rows],
                                  np.asarray(want[2])[rows])
    np.testing.assert_array_equal(queue.depths.numpy()[rows],
                                  np.asarray(want[3])[rows])
    np.testing.assert_array_equal(queue.rows.numpy()[rows], src[s])
    np.testing.assert_array_equal(queue.fps.numpy()[rows].view(np.uint64),
                                  cfp[:n_new])
    np.testing.assert_array_equal(queue.ebits.numpy()[rows], pebits[s // arity])
    np.testing.assert_array_equal(queue.depths.numpy()[rows],
                                  pdepth[s // arity] + 1)
    untouched = np.r_[0:tail, tail + n_new:q]
    np.testing.assert_array_equal(queue.rows.numpy()[untouched],
                                  qrows0[untouched])
    assert (queue.fps.numpy()[untouched] == -1).all()
