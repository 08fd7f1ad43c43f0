"""The device Bloom filter over the SPILLED fingerprint set.

The port's own copy of ``stateright_tpu/spill/bloom.py``.  A candidate
that misses the hot table and misses the filter is provably novel and
inserts on the device; only filter-positive candidates pay the trip to
the host index.  The filter covers only the spilled fingerprints (the
insert checks the hot table exactly), so its load follows the spilled
set.  The host sets bits at eviction boundaries (:func:`bloom_set_np`,
on a host mirror); the step only tests (:func:`bloom_test`).

Hash family: four slices of ``mix64(fp)`` and ``mix64(mix64(fp))``, the
low and the high 32 bits of each, masked to the filter width.  The bit
layout is the JAX package's: bit ``i`` of the filter is bit ``i & 31`` of
32-bit word ``i >> 5``.  torch has no ``uint32`` shifts, so the device
holds the words as ``int32`` bit patterns and every fingerprint as an
``int64`` bit pattern (``ops/hashing.py``); :func:`bloom_test` shifts
them with ``lshr`` only.  A snapshot's and a host mirror's words stay
``uint32``, the JAX layout, so either package resumes the other's.

No false negatives: the host mirror and the device test derive the bit
positions from the same ``mix64``, so every spilled fingerprint tests
positive and exactness rests on the host index.  With ``n`` spilled
fingerprints, ``k`` = :data:`BLOOM_K` slices and ``B`` bits the expected
false-positive rate is ``(1 - e^(-k*n/B))^k``; a saturated filter costs
throughput (everything defers), never correctness.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.hashing import lshr, mix64, mix64_np

# hash functions per fingerprint: four 32-bit slices of two mix rounds
BLOOM_K = 4

# the narrowest filter: below this the word array is under a cache line
MIN_BLOOM_BITS = 1 << 10

# the widest filter: a bit position must fit 31 bits, as in the JAX
# package, whose device test indexes with int32 (2^31 bits = 256 MiB)
MAX_BLOOM_BITS = 1 << 31


def bloom_words(bits: int) -> int:
    """32-bit words backing a ``bits``-wide filter (a power of two, so a
    multiple of 32)."""
    assert bits % 32 == 0 and bits >= MIN_BLOOM_BITS
    return bits // 32


def bloom_est_false_pos(n_set: int, bits: int, k: int = BLOOM_K) -> float:
    """Expected false-positive rate with ``n_set`` elements inserted."""
    if bits <= 0 or n_set <= 0:
        return 0.0
    return float((1.0 - math.exp(-k * n_set / bits)) ** k)


def _slices_np(fps: np.ndarray, bits: int) -> np.ndarray:
    """``int64[k, n]`` bit positions of ``fps`` (the host mirror's; equal
    to the device's bit for bit)."""
    fps = np.asarray(fps, np.uint64)
    mask = np.uint64(bits - 1)
    g1 = mix64_np(fps)
    g2 = mix64_np(g1)
    return np.stack([
        (g1 & mask).astype(np.int64),
        ((g1 >> np.uint64(32)) & mask).astype(np.int64),
        (g2 & mask).astype(np.int64),
        ((g2 >> np.uint64(32)) & mask).astype(np.int64),
    ])


def bloom_set_np(words: np.ndarray, fps) -> np.ndarray:
    """Set the bits of ``fps`` in the host mirror ``words`` (``uint32``),
    in place; returns ``words``.  Called at eviction boundaries only."""
    fps = np.asarray(fps, np.uint64)
    if fps.size == 0:
        return words
    bits = int(words.size) * 32
    idx = _slices_np(fps, bits).reshape(-1)
    np.bitwise_or.at(
        words, idx >> 5, (np.uint32(1) << (idx & 31).astype(np.uint32))
    )
    return words


def bloom_test_np(words: np.ndarray, fps) -> np.ndarray:
    """Host membership test (all ``k`` bits set), the device test's
    oracle."""
    fps = np.asarray(fps, np.uint64)
    bits = int(words.size) * 32
    idx = _slices_np(fps, bits)
    hit = np.ones(fps.shape, bool)
    for row in idx:
        w = words[row >> 5]
        hit &= ((w >> (row & 31).astype(np.uint32)) & np.uint32(1)) != 0
    return hit


def bloom_test(words: torch.Tensor, fps: torch.Tensor,
               bits: int) -> torch.Tensor:
    """Device membership test: ``bool[...]`` per fingerprint, True iff
    all :data:`BLOOM_K` slice bits are set.  ``words`` is the filter as
    ``int32`` bit patterns, ``fps`` ``int64`` bit patterns.  Reads the
    filter only, gathers with ``index_select`` (no host read), and shifts
    right with ``lshr`` only."""
    mask = bits - 1
    g1 = mix64(fps.reshape(-1))
    g2 = mix64(g1)
    one = torch.ones_like(g1)
    hit = None
    for h in (g1, lshr(g1, 32), g2, lshr(g2, 32)):
        idx = h & mask
        # the word, sign-extended: bits 0-31 are the filter's
        w = words.index_select(0, lshr(idx, 5)).to(torch.int64)
        b = (w & torch.bitwise_left_shift(one, idx & 31)) != 0
        hit = b if hit is None else (hit & b)
    return hit.reshape(fps.shape)
