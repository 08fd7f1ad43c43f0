"""Seeded ``bucket_plan`` inputs in generation order, shared by the CPU
parity tests (``tests/test_torch_symmetry.py``, against the JAX package)
and the card tests (``tests/test_torch_gpu.py``, kernel against plain).
It imports only the port and numpy, so the card's machine, which has no
JAX, can import it too.  It holds cases, not tests."""

import numpy as np

from stateright_tpu_torch.ops.buckets import SLOTS, bucket_of

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
