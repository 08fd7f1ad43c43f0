"""The insert's candidate preparation: hash, key and compact in one pass.

The engine step's counterpart of three pieces of the JAX package: the
successor fingerprint under the engine's valid mask
(``stateright_tpu/parallel/wavefront.py:491``, ``row_hash`` of
``stateright_tpu/ops/hashing.py``), the parents' broadcast (``cand_par``,
wavefront.py:513) and ``bucket_insert``'s budget compaction and sort key
(``stateright_tpu/ops/buckets.py:181-194``, the ``lane_compact`` idiom,
and ``bucket_key``).  Given ``M = B * arity`` successor rows, their valid
mask and the ``B`` parents' fingerprints, it moves the valid lanes, in
lane order, to the front of a ``CB``-wide buffer and gives each its
fingerprint, its parent's fingerprint (the payload), its lane index
(``cidx``) and its sort key; see :func:`cand_prep_plain` for every lane.

In a sweep (``sweep/engine.py``) the prep takes a :class:`Namespace`: each
valid lane's fingerprint is namespaced by its parent's instance tag
(``ops/hashing.ns_hash_plain``) before it is keyed and compacted, the
JAX sweep step's ``ns_hash(row_hash(succ), ...)``.  Without one (the
plain engine) the launch and its bytes are unchanged.

It always compacts, even at ``CB == M``: the sorted valid prefix, and so
the tables and the queue, come out the same as without compaction.

On a CUDA tensor :func:`cand_prep` launches ``csrc/cand_prep.cu`` once;
on a CPU tensor it runs :func:`cand_prep_plain`.  The engine then sorts
the keys once (``torch.sort``) and hands the unsorted lanes with the
permutation to ``ops/buckets.bucket_plan_fused``; :func:`sort_prepared`
is the sort with the sorted lanes gathered, that plan's plain
counterpart.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import _cuda
from .buckets import bucket_bits, bucket_key, key_buckets
from .hashing import EMPTY, SIGN, ns_hash_plain, row_hash_plain

PREP_TILE = 1024  # input (or output) lanes per CTA of csrc/cand_prep.cu
PREP_SCRATCH = 2  # cand_prep.cu's scratch words before the tile states


class Namespace(NamedTuple):
    """The namespace mode of :func:`cand_prep`: lane ``i``'s fingerprint
    is ``ns_hash(fp, low[t], xor[t], bits)`` with ``t = tags[i // arity]``
    (``ops/hashing.ns_hash_plain``)."""

    tags: torch.Tensor  # int32[B]: the parents' instance tags
    low: torch.Tensor  # int64[K]: each tag's low key bits (its global tag)
    xor: torch.Tensor  # int64[K]: each tag's high-bit seed scramble
    bits: int


def cand_prep_plain(rows, valid, pfps, arity: int, cb: int,
                    ns: Optional[Namespace] = None):
    """Plain PyTorch version: ``row_hash_plain``, the JAX budget compaction
    and ``bucket_key``, composed.  ``rows`` int64[M, W], ``valid`` bool[M],
    ``pfps`` int64[M // arity].  Returns ``(fp, payload, cidx, key,
    n_valid, cand_overflow)``: four int64[CB] lanes, where output lane
    ``j < n_valid`` holds the j-th valid lane ``i = cidx[j]``'s fingerprint,
    ``pfps[i // arity]`` and ``bucket_key(fp) ^ SIGN`` (unsigned key order
    as signed order), and later lanes EMPTY, ``pfps[(M-1) // arity]``,
    ``M - 1`` and ``EMPTY ^ SIGN``; then the 0-d int64 count of valid lanes
    and the 0-d flag ``n_valid > CB``.  With ``ns`` each valid lane's
    fingerprint is namespaced first, and the key is taken from it."""
    m = rows.shape[0]
    dev = rows.device
    fp = row_hash_plain(rows, valid)
    if ns is not None:
        t = ns.tags.to(torch.int64).repeat_interleave(arity)
        fp = torch.where(valid, ns_hash_plain(fp, ns.low[t], ns.xor[t],
                                              ns.bits), EMPTY)
    vsum = torch.cumsum(valid.to(torch.int32), 0, dtype=torch.int32)
    n_valid = vsum[m - 1].to(torch.int64)
    # index of the j-th valid lane = first position where the running
    # valid count reaches j+1 (monotone, so a binary search per lane)
    want = torch.arange(1, cb + 1, dtype=torch.int32, device=dev)
    cidx = torch.searchsorted(vsum, want, side="left").clamp_(max=m - 1)
    live = torch.arange(cb, device=dev) < n_valid
    cfp = torch.where(live, fp[cidx], EMPTY)
    return (cfp, pfps[cidx // arity], cidx, bucket_key(cfp) ^ SIGN,
            n_valid, n_valid > cb)


class PrepBuffers:
    """Outputs and scratch of :func:`cand_prep` for ``m`` input lanes and a
    ``cb``-lane budget on one CUDA device, allocated and validated once (each
    engine allocates its own).  The kernel's last CTA zeroes the scratch
    (two tickets, one state word per input tile) again for the next
    launch."""

    def __init__(self, m: int, cb: int, device):
        if not 0 < cb <= m < 1 << 30:
            raise ValueError(f"cand_prep: {m} lanes, budget {cb}; the kernel "
                             "takes 1 <= budget <= lanes < 2^30 (it counts "
                             "in 30 bits)")
        i64 = dict(dtype=torch.int64, device=device)
        self.m, self.cb, self.device = m, cb, torch.device(device)
        self.fp, self.payload, self.cidx, self.key = (
            torch.empty(cb, **i64) for _ in range(4)
        )
        self.n_valid = torch.zeros((), **i64)
        self.cand_overflow = torch.zeros((), dtype=torch.bool, device=device)
        self.scratch = torch.zeros(PREP_SCRATCH + -(-m // PREP_TILE),
                                   **i64)
        self.outputs = (self.fp, self.payload, self.cidx, self.key,
                        self.n_valid, self.cand_overflow)
        self.ptrs = tuple(t.data_ptr() for t in self.outputs + (self.scratch,))


def cand_prep(rows, valid, pfps, arity: int, cb: int,
              out: PrepBuffers = None, *, check: bool = True, stream=None,
              ns: Optional[Namespace] = None):
    """:func:`cand_prep_plain`'s function; CUDA tensors launch
    ``csrc/cand_prep.cu`` once, into ``out`` (allocated here when None);
    ``ns`` turns on the namespace mode of a sweep.
    The outputs are ``out``'s tensors: the next launch into the same
    buffers overwrites them.  ``check=False`` skips the argument checks:
    only for a caller that built the inputs itself (the engine).
    ``stream``: the raw CUDA stream (default: the current one)."""
    if rows.device.type != "cuda":
        return cand_prep_plain(rows, valid, pfps, arity, cb, ns)
    m = rows.shape[0]
    dev = rows.device
    if check:
        _cuda.require(rows, "rows", torch.int64, 2, dev)
        _cuda.require(valid, "valid", torch.bool, 1, dev, m)
        _cuda.require(pfps, "pfps", torch.int64, 1, dev)
        if arity < 1 or pfps.shape[0] * arity != m:
            raise ValueError(f"pfps: {pfps.shape[0]} parents of arity "
                             f"{arity} for {m} lanes")
        if out is not None and (out.m, out.cb, out.device) != (m, cb, dev):
            raise ValueError(f"out: buffers for {out.m} lanes, budget "
                             f"{out.cb}, on {out.device}")
        if ns is not None:
            _cuda.require(ns.tags, "tags", torch.int32, 1, dev,
                          pfps.shape[0])
            _cuda.require(ns.low, "low", torch.int64, 1, dev)
            _cuda.require(ns.xor, "xor", torch.int64, 1, dev,
                          ns.low.shape[0])
            if not 1 <= ns.bits <= 63:
                raise ValueError(f"ns.bits: {ns.bits}, want 1..63")
    if out is None:
        out = PrepBuffers(m, cb, dev)
    if stream is None:
        stream = _cuda.stream_of(rows)
    nsargs = ((None, None, None, 0) if ns is None else
              (ns.tags.data_ptr(), ns.low.data_ptr(), ns.xor.data_ptr(),
               ns.bits))
    _cuda.check("cand_prep", _cuda.library().srt_cand_prep(
        rows.data_ptr(), valid.data_ptr(), pfps.data_ptr(), *out.ptrs,
        *nsargs, m, cb, rows.shape[1], arity, stream,
    ))
    _cuda.count_launch(cand_prep)
    return out.outputs


cand_prep.launches = 0


def sort_prepared(fp, payload, key, nbuckets: int):
    """The stable sort of :func:`cand_prep`'s lanes by key, with the
    sorted lanes gathered: ``(sfp, spl, bucket, order)``, the pre-gathered
    plan's inputs (``ops/buckets.bucket_plan``).  One ``torch.sort`` gives
    the sorted keys and the permutation; a lane's bucket is the high
    ``log2(nbuckets)`` bits of its unsigned key (``key_buckets``).  The
    engines sort alone and give ``bucket_plan_fused`` the unsorted lanes
    instead, so these gathers and the shift (the sort's tail) do not run
    on their step; this composition is its plain counterpart."""
    bits = bucket_bits(nbuckets)
    skey, order = torch.sort(key, stable=True)
    return fp[order], payload[order], key_buckets(skey, bits), order
