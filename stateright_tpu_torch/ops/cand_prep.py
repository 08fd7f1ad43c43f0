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

It always compacts, even at ``CB == M``: the sorted valid prefix, and so
the tables and the queue, come out the same as without compaction.

On a CUDA tensor :func:`cand_prep` launches ``csrc/cand_prep.cu`` once;
on a CPU tensor it runs :func:`cand_prep_plain`.  :func:`sort_prepared`
is the stable key sort that follows it in the engine.
"""

from __future__ import annotations

import torch

from . import _cuda
from .buckets import bucket_key
from .hashing import EMPTY, SIGN, row_hash_plain

PREP_TILE = 256  # input (or output) lanes per CTA of csrc/cand_prep.cu


def cand_prep_plain(rows, valid, pfps, arity: int, cb: int):
    """Plain PyTorch version: ``row_hash_plain``, the JAX budget compaction
    and ``bucket_key``, composed.  ``rows`` int64[M, W], ``valid`` bool[M],
    ``pfps`` int64[M // arity].  Returns ``(fp, payload, cidx, key,
    n_valid, cand_overflow)``: four int64[CB] lanes, where output lane
    ``j < n_valid`` holds the j-th valid lane ``i = cidx[j]``'s fingerprint,
    ``pfps[i // arity]`` and ``bucket_key(fp) ^ SIGN`` (unsigned key order
    as signed order), and later lanes EMPTY, ``pfps[(M-1) // arity]``,
    ``M - 1`` and ``EMPTY ^ SIGN``; then the 0-d int64 count of valid lanes
    and the 0-d flag ``n_valid > CB``."""
    m = rows.shape[0]
    dev = rows.device
    fp = row_hash_plain(rows, valid)
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
        self.scratch = torch.zeros(2 + -(-m // PREP_TILE), **i64)
        self.outputs = (self.fp, self.payload, self.cidx, self.key,
                        self.n_valid, self.cand_overflow)
        self.ptrs = tuple(t.data_ptr() for t in self.outputs + (self.scratch,))


def cand_prep(rows, valid, pfps, arity: int, cb: int,
              out: PrepBuffers = None, *, check: bool = True, stream=None):
    """:func:`cand_prep_plain`'s function; CUDA tensors launch
    ``csrc/cand_prep.cu`` once, into ``out`` (allocated here when None).
    The outputs are ``out``'s tensors: the next launch into the same
    buffers overwrites them.  ``check=False`` skips the argument checks:
    only for a caller that built the inputs itself (the engine).
    ``stream``: the raw CUDA stream (default: the current one)."""
    if rows.device.type != "cuda":
        return cand_prep_plain(rows, valid, pfps, arity, cb)
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
    if out is None:
        out = PrepBuffers(m, cb, dev)
    if stream is None:
        stream = _cuda.stream_of(rows)
    _cuda.check("cand_prep", _cuda.library().srt_cand_prep(
        rows.data_ptr(), valid.data_ptr(), pfps.data_ptr(), *out.ptrs,
        m, cb, rows.shape[1], arity, stream,
    ))
    cand_prep.launches += 1
    return out.outputs


cand_prep.launches = 0


def sort_prepared(fp, payload, key, nbuckets: int):
    """The stable sort of :func:`cand_prep`'s lanes by key, as the insert
    needs them: ``(sfp, spl, bucket, order)``.  One ``torch.sort`` gives
    the sorted keys and the permutation; a lane's bucket is the high
    ``log2(nbuckets)`` bits of its unsigned key ``skey ^ SIGN``, which is
    ``(skey >> s) + 2^(63 - s)`` for the arithmetic shift ``s``."""
    if nbuckets & (nbuckets - 1):
        raise ValueError("bucket count must be a power of two")
    bits = int(nbuckets).bit_length() - 1
    skey, order = torch.sort(key, stable=True)
    if bits:
        bucket = (skey >> (64 - bits)) + (1 << (bits - 1))
    else:
        bucket = torch.zeros_like(skey)
    return fp[order], payload[order], bucket, order
