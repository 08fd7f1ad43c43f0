"""Seeded ``bucket_plan`` inputs, shared by the CPU parity tests
(``tests/test_torch_symmetry.py`` and ``tests/test_torch_plan_fused.py``,
against the JAX package) and the card tests (``tests/test_torch_gpu.py``,
kernel against plain): the generation-order cases (``GEN_CASES``) and the
plan's edge cases (``PLAN_CASES``: runs across tiles, an overflow in the
last tile only, budget overflow, nothing novel, one lane, a tile and one
lane, far more tiles than resident CTAs).  It imports only the port,
numpy and torch, so the card's machine, which has no JAX, can import it
too.  It holds cases, not tests."""

import numpy as np
import torch

from stateright_tpu_torch.ops.buckets import (
    PLAN_TILE,
    SLOTS,
    bucket_insert,
    bucket_of,
)

EMPTY = np.uint64(0xFFFFFFFFFFFFFFFF)
GEN_CASES = ["duplicates", "present", "full_bucket_line", "cand_overflow"]


def in_buckets(rng, nbuckets, keep, count):
    """``count`` distinct random fingerprints whose bucket satisfies
    ``keep``."""
    out = np.empty(0, np.uint64)
    while out.size < count:
        f = rng.integers(1, 1 << 64, size=4 * count, dtype=np.uint64)
        out = np.unique(np.concatenate([out, f[keep(bucket_of(f, nbuckets))]]))
    return rng.permutation(out)[:count]


def gen_case(case, rng):
    """(nbuckets, table fingerprints already present, candidates, compact)
    of the generation-order case ``case``."""
    nb = 64
    pre = rng.integers(1, 1 << 64, size=200, dtype=np.uint64)
    fps = rng.integers(1, 1 << 64, size=300, dtype=np.uint64)
    compact = None
    if case == "duplicates":
        fps = np.where(rng.random(300) < 0.4,
                       fps[rng.integers(0, 300, 300)], fps)
        fps[rng.random(300) < 0.2] = EMPTY
    elif case == "present":
        fps = np.where(rng.random(300) < 0.5, rng.choice(pre, 300), fps)
    elif case == "full_bucket_line":
        # seventeen novel fingerprints for one bucket: overflow
        fps = np.concatenate([fps[:100], in_buckets(
            rng, nb, lambda b: b == 5, SLOTS + 1)])
        fps = rng.permutation(fps)
    elif case == "cand_overflow":
        compact = 256
    else:
        raise ValueError(case)
    return nb, pre, fps, compact


def rand_i64(rng, *shape):
    return torch.from_numpy(
        rng.integers(0, 1 << 64, size=shape, dtype=np.uint64).view(np.int64)
    )


def i64(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.uint64).view(np.int64).copy())


def plan_case(case, rng):
    """(table fp, table payload, candidates, payloads, compact)."""
    nb, compact = 256, None
    pre = in_buckets(rng, nb, lambda b: b >= 0, 4 * nb)
    if case == "segment_spans_3_tiles":
        # one bucket, one fingerprint 600 times and eleven others: the
        # bucket's run and the fingerprint's run both cross tile edges
        nb, pre = 1, in_buckets(rng, 1, lambda b: b >= 0, 4)
        few = in_buckets(rng, 1, lambda b: b >= 0, 12)
        fps = np.concatenate([np.repeat(few[:1], 600),
                              rng.choice(few, 3 * PLAN_TILE - 600)])
    elif case == "overflow_in_last_tile_only":
        # 17 novel fingerprints in the last bucket sort to the last tile
        nb = 64
        pre = in_buckets(rng, nb, lambda b: b < nb - 1, 2 * nb)
        others = in_buckets(rng, nb, lambda b: b < nb - 1, 150)
        fps = np.concatenate([
            rng.choice(others, 2 * PLAN_TILE + 83),
            in_buckets(rng, nb, lambda b: b == nb - 1, SLOTS + 1),
        ])
    elif case == "cand_overflow":
        fps = in_buckets(rng, nb, lambda b: b >= 0, 700)
        compact = 512
    elif case == "n_new_zero":  # every candidate is in the table
        fps = rng.choice(pre, 900)
    elif case == "m_1":
        fps = in_buckets(rng, nb, lambda b: b >= 0, 1)
    elif case == "m_tile_plus_1":
        fps = rng.choice(in_buckets(rng, nb, lambda b: b >= 0, 200),
                         PLAN_TILE + 1)
        fps[::5] = EMPTY
    elif case == "many_tiles":  # far more tiles than resident CTAs
        nb, pre = 1 << 15, np.empty(0, np.uint64)
        fps = rng.choice(in_buckets(rng, nb, lambda b: b >= 0, 60_000),
                         300_000)
        fps[rng.random(fps.size) < 0.3] = EMPTY
        compact = 250_000
    else:
        raise ValueError(case)
    tfp = torch.full((nb * SLOTS,), -1, dtype=torch.int64)
    tpl = torch.zeros_like(tfp)
    if pre.size:
        bucket_insert(tfp, tpl, i64(pre), i64(pre))
    return tfp, tpl, i64(fps), rand_i64(rng, fps.size), compact


PLAN_CASES = ["segment_spans_3_tiles", "overflow_in_last_tile_only",
              "cand_overflow", "n_new_zero", "m_1", "m_tile_plus_1",
              "many_tiles"]
