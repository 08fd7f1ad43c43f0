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
from stateright_tpu_torch.ops.insert_commit import (
    QueueAppend,
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


def test_commit_plain_appends_the_written_lanes_to_the_queue():
    """The queue half: row ``tail + j`` gets candidate ``sel[j]``, its
    fingerprint and its parent's ebits and depth + 1 (parent ``sel[j] //
    arity``), for ``j < n_new`` only; the table half is the Pallas
    kernel's write, as above."""
    rng = np.random.default_rng(3)
    nslots, m, n_new, arity, width, q, tail = 2048, 256, 90, 4, 3, 600, 37
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
