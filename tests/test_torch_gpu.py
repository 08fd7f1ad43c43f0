"""Card-only tests of the port: each hand-written CUDA kernel against its
plain PyTorch version on a CUDA device (integer outputs: equal), and the
engine's table on ``cuda`` against ``cpu``.

Marked ``gpu``; each test decides inside itself whether a card is present
and skips without one.  This file imports no JAX (the machine with the
card has none), so on that machine it runs without the suite's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
from stateright_tpu_torch.ops.buckets import (
    SLOTS,
    bucket_insert,
    bucket_probe,
    bucket_probe_plain,
)
from stateright_tpu_torch.ops.hashing import row_hash, row_hash_plain
from stateright_tpu_torch.ops.insert_write import insert_write, insert_write_plain

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def rand_i64(rng, *shape):
    return torch.from_numpy(
        rng.integers(0, 1 << 64, size=shape, dtype=np.uint64).view(np.int64)
    )


@pytest.mark.parametrize("width", [1, 3])
def test_row_hash_kernel_matches_plain(cuda, width):
    rng = np.random.default_rng(width)
    rows = rand_i64(rng, 5000, width)
    rows[::7] = 0
    rows[::11] = -1
    valid = torch.from_numpy(rng.random(5000) < 0.5)
    for v in (None, valid):
        want = row_hash_plain(rows, v)
        got = row_hash(rows.to(cuda), None if v is None else v.to(cuda))
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want)


def test_bucket_probe_kernel_matches_plain(cuda):
    rng = np.random.default_rng(1)
    nb = 256
    tfp = torch.full((nb * SLOTS,), -1, dtype=torch.int64)
    tpl = torch.zeros_like(tfp)
    fps = rand_i64(rng, 3000)
    bucket_insert(tfp, tpl, fps, fps)
    probe = torch.cat([fps[:1500], rand_i64(rng, 1500)])
    probe[::5] = -1
    bucket = torch.from_numpy(rng.integers(0, nb, size=3000))
    want = bucket_probe_plain(tfp, probe, bucket)
    got = bucket_probe(tfp.to(cuda), probe.to(cuda), bucket.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


def test_insert_write_kernel_matches_plain(cuda):
    rng = np.random.default_rng(2)
    nslots, m, n_new = 1 << 14, 4096, 3000
    tfp, tpl = rand_i64(rng, nslots), rand_i64(rng, nslots)
    tgt = torch.full((m,), nslots, dtype=torch.int64)
    tgt[:n_new] = torch.from_numpy(rng.choice(nslots, n_new, replace=False))
    cfp, cpl = rand_i64(rng, m), rand_i64(rng, m)
    n = torch.tensor(n_new)
    pf, pp = insert_write_plain(tfp.clone(), tpl.clone(), tgt, cfp, cpl, n)
    kf, kp = insert_write(*(t.to(cuda) for t in (tfp, tpl, tgt, cfp, cpl, n)))
    torch.cuda.synchronize()
    assert torch.equal(kf.cpu(), pf) and torch.equal(kp.cpu(), pp)


def test_engine_tables_identical_on_cuda_and_cpu(cuda):
    g = TwoPhaseSys(4).checker().spawn_gpu(device=cuda, batch=256).join()
    c = TwoPhaseSys(4).checker().spawn_gpu(device="cpu", batch=256).join()
    assert g.unique_state_count() == c.unique_state_count()
    for a, b in zip(g._table_np(), c._table_np()):
        np.testing.assert_array_equal(a, b)
