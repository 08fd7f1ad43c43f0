"""Bucketized device visited set: one-shot insert, no probe loop.

The port's counterpart of ``stateright_tpu/ops/buckets.py``, with the same
table layout and the same insert rules, so a port run and a JAX run leave
the same table bytes:

 - the table is ``nslots / SLOTS`` buckets of ``SLOTS`` fingerprints; a
   fingerprint's bucket is the HIGH bits of ``mix64(fp)``
   (:func:`bucket_key`), and ``host_bucket_rehash`` derives the same bucket
   on the host;
 - candidates are sorted ONCE by that key (stable, so equal fingerprints
   keep their lane order and EMPTY lanes sort last), which groups
   duplicates for first-occurrence dedup and same-bucket candidates for
   per-bucket ranks;
 - a novel candidate's slot is its bucket's occupancy plus its rank; a
   bucket past ``SLOTS`` raises ``overflow`` and more valid candidates than
   the ``compact`` budget raise ``cand_overflow``, and then nothing is
   written and ``n_new`` is 0.

Values are int64 bit patterns (``ops/hashing.py``).  The insert runs in
three stages: the budget compaction (:func:`compact_candidates`) and one
stable ``torch.sort`` of the keys (``torch.argsort`` is not stable by
default, and the table and traces depend on it, so every sort passes
``stable=True``), then :func:`bucket_plan_fused` (membership, occupancy,
dedup, ranks, flags and the compaction of the novel candidates, reading
the fingerprints and payloads through the sort's permutation; on CUDA one
launch of ``csrc/bucket_plan.cu``, two in generation order), then the
commit (``ops/insert_commit.py``).  :func:`bucket_plan` is the same plan
over inputs the caller sorted itself (:func:`sort_candidates`; the sharded
engine's per-shard sorts).

The novel candidates are compacted in one of two orders.  Plain runs use
table order (sorted key order).  Symmetry runs use **generation order**
(``generation_order=True``, JAX ``ops/buckets.py:282-297``, :341-343): the
order of the candidates themselves, so the queue, and with it which
member of a symmetry class is explored, follows the order the successors
were generated in, as a host FIFO search would.  Table slots are the same
in both orders; only the order of the compacted lists changes.

The engine's step takes its first stage from ``ops/cand_prep.py`` instead
(hash, key and compaction in one launch, then one sort);
:func:`bucket_insert` serves the init rows, the spill inject's lanes and
the tests.  Under
``.prededup()`` the step first masks a window's repeated fingerprints
(:func:`window_unique`).  The JAX
version's data-dependent ``while_loop`` s become full-width passes masked
by counts that stay on the device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import _cuda
from .hashing import EMPTY, EMPTY_U64, SIGN, mix64, mix64_np
from .insert_commit import insert_commit

SLOTS = 16  # fingerprints per bucket (one 128-byte line of 64-bit words)
PLAN_TILE = 256  # sorted lanes per CTA of csrc/bucket_plan.cu
PLAN_SCRATCH = 5  # bucket_plan.cu's scratch words before the tile states


def bucket_key(fps: torch.Tensor) -> torch.Tensor:
    """Sort/derivation key ``mix64(fp)``, EMPTY lanes pinned to the maximal
    key, and the one valid fp whose mix equals EMPTY moved to ``EMPTY - 1``
    (same bucket) — as ``stateright_tpu/ops/buckets.py::bucket_key``."""
    k = mix64(fps)
    k = torch.where(k == EMPTY, EMPTY - 1, k)
    return torch.where(fps == EMPTY, EMPTY, k)


def bucket_bits(nbuckets: int) -> int:
    """``log2(nbuckets)``: the key bits that name a bucket."""
    if nbuckets & (nbuckets - 1):
        raise ValueError("bucket count must be a power of two")
    return int(nbuckets).bit_length() - 1


def key_buckets(skey: torch.Tensor, bits: int) -> torch.Tensor:
    """The buckets of sorted keys ``skey`` (``bucket_key ^ SIGN``, signed
    order): the high ``bits`` bits of the unsigned key ``skey ^ SIGN``,
    which is ``(skey >> s) + 2^(63 - s)`` for the arithmetic shift
    ``s = 64 - bits``; all 0 at ``bits == 0``."""
    if bits:
        return (skey >> (64 - bits)) + (1 << (bits - 1))
    return torch.zeros_like(skey)


def bucket_of(fps, nbuckets: int) -> np.ndarray:
    """Host-side bucket derivation (numpy ``uint64`` in): the bucket
    :func:`bucket_insert` and :func:`host_bucket_rehash` place ``fps`` in
    for an ``nbuckets``-bucket table."""
    if nbuckets & (nbuckets - 1):
        raise ValueError("bucket count must be a power of two")
    bits = int(nbuckets).bit_length() - 1
    k = mix64_np(fps)
    k = np.where(k == EMPTY_U64, EMPTY_U64 - np.uint64(1), k)
    if bits == 0:
        return np.zeros(k.shape, np.int64)
    return (k >> np.uint64(64 - bits)).astype(np.int64)


def window_unique(fps: torch.Tensor) -> torch.Tensor:
    """Intra-window pre-dedup (JAX ``ops/buckets.py:73-102``): every later
    occurrence of a fingerprint becomes EMPTY, the first (lowest lane)
    stays; EMPTY lanes stay EMPTY.  The kept lane is the one the insert's
    stable sort keeps, so the inserted set, ``sel`` and ``n_new`` do not
    change; only the candidate budget sees fewer lanes.  One stable sort
    in unsigned order, and the first-occurrence flags scattered back (a
    boolean-mask index would read a count on the host).  A ``[K, M]``
    input is ``K`` windows, each deduplicated on its own (the sharded
    engine's shards)."""
    sfp, order = torch.sort(fps ^ SIGN, dim=-1, stable=True)
    first = torch.ones_like(fps, dtype=torch.bool)
    first[..., 1:] = sfp[..., 1:] != sfp[..., :-1]
    keep = torch.zeros_like(first).scatter_(-1, order, first)
    return torch.where(keep, fps, EMPTY)


def lane_compact(mask: torch.Tensor, width: int):
    """Order-preserving lane compaction (JAX ``ops/buckets.py:105-123``):
    ``(idx, live, count)`` such that ``x[idx]`` gathers the first
    ``width`` True lanes of ``mask`` to the front, ``live`` flags the
    output lanes that are real, and ``count`` is the 0-d number of True
    lanes.  A cumsum and a binary search per output lane, the budget
    compaction's idiom: nothing reads the count on the host (no
    ``nonzero``, no ``masked_select``).  Dead lanes' ``idx`` is clamped
    to ``m - 1``, so a gather through it stays in range."""
    m = mask.shape[0]
    dev = mask.device
    csum = torch.cumsum(mask.to(torch.int32), 0, dtype=torch.int32)
    count = csum[m - 1]
    want = torch.arange(1, width + 1, dtype=torch.int32, device=dev)
    idx = torch.searchsorted(csum, want, side="left").clamp_(max=m - 1)
    live = torch.arange(width, device=dev) < count
    return idx, live, count


def bucket_probe_plain(tfp, sfp, bucket):
    """Membership and occupancy of each candidate's bucket line:
    ``present = any(line == fp)``, ``base = count(line != EMPTY)``; EMPTY
    lanes give ``(False, 0)``.  Returns ``(bool[M], int32[M])``."""
    lines = tfp.view(-1, SLOTS)[bucket]  # [M, SLOTS]
    valid = sfp != EMPTY
    present = (lines == sfp[:, None]).any(dim=1) & valid
    base = torch.where(
        valid, (lines != EMPTY).sum(dim=1, dtype=torch.int32), 0
    ).to(torch.int32)
    return present, base


def compact_candidates(fps: torch.Tensor, payloads: torch.Tensor,
                       compact: int = None):
    """The insert's budget compaction (JAX ``ops/buckets.py:181-194``):
    with ``compact=CB`` below the lane count, the valid lanes move in lane
    order to the front of CB lanes and the rest turn EMPTY.  Returns
    ``(fps, payloads, cidx, cand_overflow)``: the compacted lanes (the
    inputs when not compacted), the compaction index (None when not
    compacted) and the 0-d flag "more valid lanes than CB"."""
    dev = fps.device
    m_orig = fps.shape[0]
    cand_overflow = torch.zeros((), dtype=torch.bool, device=dev)
    if compact is None or compact >= m_orig:
        return fps, payloads, None, cand_overflow
    vsum = torch.cumsum((fps != EMPTY).to(torch.int32), 0, dtype=torch.int32)
    n_valid_orig = vsum[m_orig - 1]
    cand_overflow = n_valid_orig > compact
    # index of the j-th valid lane = first position where the running
    # valid count reaches j+1 (monotone, so a binary search per lane)
    want = torch.arange(1, compact + 1, dtype=torch.int32, device=dev)
    cidx = torch.searchsorted(vsum, want, side="left").clamp_(max=m_orig - 1)
    live = torch.arange(compact, device=dev) < n_valid_orig
    fps = torch.where(live, fps[cidx], EMPTY)
    payloads = payloads[cidx]  # dead lanes masked by the EMPTY fp above
    return fps, payloads, cidx, cand_overflow


def sort_keys(fps: torch.Tensor):
    """The stable sort by :func:`bucket_key`: ``(skey, order)``, the keys
    as ``bucket_key ^ SIGN`` (unsigned key order as signed order; EMPTY
    lanes last) sorted, and the permutation."""
    return torch.sort(bucket_key(fps) ^ SIGN, stable=True)


def sort_candidates(fps: torch.Tensor, payloads: torch.Tensor,
                    nbuckets: int, compact: int = None):
    """The insert's first half in its pre-gathered form: optional budget
    compaction, then the stable sort by :func:`bucket_key` and the sorted
    lanes gathered.  Returns ``(sfp, spl, bucket, order, cidx,
    cand_overflow)``: sorted fingerprints and payloads, their buckets, the
    sort permutation, the compaction index (None when not compacted), and
    the 0-d budget-overflow flag: :func:`bucket_plan`'s inputs."""
    bits = bucket_bits(nbuckets)
    fps, payloads, cidx, cand_overflow = compact_candidates(fps, payloads,
                                                            compact)
    skey, order = sort_keys(fps)
    return (fps[order], payloads[order], key_buckets(skey, bits), order,
            cidx, cand_overflow)


def plan_writes(sfp, spl, bucket, present, base, nslots: int, cand_overflow,
                order=None):
    """The insert's rank pass over sorted candidates: first-occurrence
    dedup, novelty, per-bucket ranks by segmented cumsum, the overflow
    flags, and the novel candidates compacted to the front, in table order,
    or in generation order when the sort permutation ``order`` is given.
    Returns ``(tgt, cfp, cpl, perm, n_new, overflow)``; ``tgt`` is
    ``nslots`` on non-novel lanes and ``n_new`` is 0 when blocked."""
    m = sfp.shape[0]
    dev = sfp.device
    first = torch.ones(m, dtype=torch.bool, device=dev)
    first[1:] = sfp[1:] != sfp[:-1]
    novel = first & (sfp != EMPTY) & ~present

    # per-bucket insertion rank among this batch's novel candidates
    idx = torch.arange(m, device=dev)
    bstart = torch.ones(m, dtype=torch.bool, device=dev)
    bstart[1:] = bucket[1:] != bucket[:-1]
    seg_start = torch.cummax(torch.where(bstart, idx, 0), 0).values
    novel_i = novel.to(torch.int64)
    csum = torch.cumsum(novel_i, 0)
    # (csum - novel)[seg_start] = novel count before the bucket's first row
    rank = torch.where(novel, csum - 1 - (csum - novel_i)[seg_start], 0)

    slot = base + rank
    overflow = (novel & (slot >= SLOTS)).any()
    n_new = torch.where(overflow | cand_overflow, 0, csum[m - 1])
    # novel lanes first: in sorted order, or in the order of the lanes the
    # sort drew them from (generation order)
    perm = torch.argsort(torch.where(novel, idx if order is None else order, m),
                         stable=True)
    tgt = torch.where(novel, bucket * SLOTS + slot, nslots)[perm]
    return tgt, sfp[perm], spl[perm], perm, n_new, overflow


def bucket_plan_plain(tfp, sfp, spl, bucket, order, cidx, cand_overflow,
                      generation_order: bool = False):
    """:func:`bucket_probe_plain`, :func:`plan_writes` and the ``sel`` remap,
    composed.  Returns ``(tgt, cfp, cpl, sel, n_new, overflow)``: the novel
    candidates' slots, fingerprints, payloads and ORIGINAL indices
    (``cidx[order[i]]``, or ``order[i]`` when ``cidx`` is None), in table
    order or, with ``generation_order``, in candidate order; then the 0-d
    count (0 when blocked) and the 0-d bucket-overflow flag."""
    present, base = bucket_probe_plain(tfp, sfp, bucket)
    tgt, cfp, cpl, perm, n_new, overflow = plan_writes(
        sfp, spl, bucket, present, base, tfp.shape[0], cand_overflow,
        order if generation_order else None,
    )
    sel = order[perm]
    if cidx is not None:
        sel = cidx[sel]  # map compacted positions back to original indices
    return tgt, cfp, cpl, sel, n_new, overflow


def bucket_plan_fused_plain(tfp, fp, payload, skey, order, cidx,
                            cand_overflow, nbuckets: int,
                            generation_order: bool = False, win=None,
                            boff: int = 0):
    """Plain version of the fused plan: the sort's tail (``fp[order]``,
    ``payload[order]`` and the keys' buckets, :func:`key_buckets`) and
    :func:`bucket_plan_plain`, composed.  ``fp``/``payload`` are the
    unsorted lanes, ``skey``/``order`` the stable sort of their keys, and
    ``nbuckets`` the bucket count the keys are cut for.  With ``win`` (a
    2-word tensor ``lo, hi``) it plans the sorted lanes ``[lo, hi)`` as
    lanes ``0..`` of a table piece ``tfp`` whose buckets start at
    ``boff``: the other lanes dead (EMPTY, the piece's last bucket), as
    the mesh engine's pieces take them."""
    sfp, spl = fp[order], payload[order]
    bucket = key_buckets(skey, bucket_bits(nbuckets))
    if boff:
        bucket = bucket - boff
    if win is not None:
        m = skey.shape[0]
        idx = win[0] + torch.arange(m, device=skey.device)
        live = idx < win[1]
        idx = idx.clamp_(max=m - 1)
        sfp = torch.where(live, sfp[idx], EMPTY)
        spl, order = spl[idx], order[idx]
        bucket = torch.where(live, bucket[idx], tfp.shape[0] // SLOTS - 1)
    return bucket_plan_plain(tfp, sfp, spl, bucket, order, cidx,
                             cand_overflow, generation_order)


class PlanBuffers:
    """Outputs and scratch of :func:`bucket_plan` for ``m`` sorted lanes on
    one CUDA device, allocated and validated once (the engine keeps one per
    candidate width; the fused and the pre-gathered entries take the same
    buffers).  Zero-filled, so the entries past ``n_new`` that a launch
    leaves alone stay in-range indices; the kernel's last CTA zeroes the
    scratch (two tickets, the overflow word, the highest staged position,
    one state word per tile) again for the next launch.

    ``generation_order`` adds the staging area of that mode: three int64
    words (slot, fingerprint, payload) per candidate, indexed by the
    candidate's position, with slot -1 for "no novel lane here".  The
    compaction launch puts the -1 back wherever it read a record, so the
    slot words are all -1 again between launches, as they are allocated
    (the other two words are read only under a staged slot)."""

    def __init__(self, m: int, device, generation_order: bool = False):
        if not 0 < m < 1 << 30:
            raise ValueError(f"bucket_plan: {m} lanes; the kernel takes 1 "
                             "to 2^30 - 1 (it counts in 30 bits)")
        i64 = dict(dtype=torch.int64, device=device)
        self.m, self.device = m, torch.device(device)
        self.tgt, self.cfp, self.cpl, self.sel = (
            torch.zeros(m, **i64) for _ in range(4)
        )
        self.n_new = torch.zeros((), **i64)
        self.overflow = torch.zeros((), dtype=torch.bool, device=device)
        self.scratch = torch.zeros(PLAN_SCRATCH + -(-m // PLAN_TILE), **i64)
        self.generation_order = generation_order
        self.stage = (torch.full((3 * m,), -1, **i64) if generation_order
                      else None)
        self.outputs = (self.tgt, self.cfp, self.cpl, self.sel, self.n_new,
                        self.overflow)
        self.ptrs = tuple(t.data_ptr() for t in self.outputs + (self.scratch,))
        self.stage_ptr = None if self.stage is None else self.stage.data_ptr()


def bucket_plan(tfp, sfp, spl, bucket, order, cidx, cand_overflow,
                out: PlanBuffers = None, *, generation_order: bool = False,
                check: bool = True, stream=None):
    """:func:`bucket_plan_plain`'s function over pre-gathered sorted
    inputs (:func:`sort_candidates`); CUDA tensors launch
    ``csrc/bucket_plan.cu``'s pre-gathered entry into ``out`` (allocated
    here when None): once in table order, and with ``generation_order``
    twice (the plan, then the compaction in candidate order; the launch
    count counts both).  The outputs are ``out``'s tensors: the next
    launch into the same buffers overwrites them.  ``check=False`` skips
    the argument checks: only for a caller that built the inputs itself
    (the sharded engine, whose shards are sorted apart).  ``stream``: the
    raw CUDA stream (default: the current one)."""
    if sfp.device.type != "cuda":
        return bucket_plan_plain(tfp, sfp, spl, bucket, order, cidx,
                                 cand_overflow, generation_order)
    m = sfp.shape[0]
    dev = sfp.device
    if check:
        _cuda.require(tfp, "tfp", torch.int64, 1, dev)
        if tfp.shape[0] % SLOTS:
            raise ValueError("tfp: not a whole number of buckets")
        for t, name in ((sfp, "sfp"), (spl, "spl"), (bucket, "bucket"),
                        (order, "order")):
            _cuda.require(t, name, torch.int64, 1, dev, m)
        if cidx is not None:
            _cuda.require(cidx, "cidx", torch.int64, 1, dev, m)
        _cuda.require(cand_overflow, "cand_overflow", torch.bool, 0, dev)
        if out is not None and (out.m, out.device) != (m, dev):
            raise ValueError(
                f"out: buffers for {out.m} lanes on {out.device}")
    if out is None:
        out = PlanBuffers(m, dev, generation_order)
    elif out.generation_order != generation_order:
        # the buffers decide the launches (a staging area is the second
        # one's), so the two must agree even unchecked
        raise ValueError(f"out: buffers for generation_order="
                         f"{out.generation_order}")
    if stream is None:
        stream = _cuda.stream_of(sfp)
    _cuda.check("bucket_plan", _cuda.library().srt_bucket_plan(
        tfp.data_ptr(), sfp.data_ptr(), spl.data_ptr(), bucket.data_ptr(),
        order.data_ptr(), None if cidx is None else cidx.data_ptr(),
        cand_overflow.data_ptr(), *out.ptrs,
        out.stage_ptr, m, stream,
    ))
    _cuda.count_launch(bucket_plan, 1 if out.stage is None else 2)
    return out.outputs


bucket_plan.launches = 0


def bucket_plan_fused(tfp, fp, payload, skey, order, cidx, cand_overflow,
                      nbuckets: int, out: PlanBuffers = None, *,
                      generation_order: bool = False, win=None,
                      boff: int = 0, check: bool = True, stream=None):
    """:func:`bucket_plan_fused_plain`'s function: the plan straight from
    ``cand_prep``'s unsorted ``fp``/``payload`` and the key sort's
    ``skey``/``order``.  CUDA tensors launch ``csrc/bucket_plan.cu``'s
    fused entry into ``out`` (allocated here when None): once in table
    order, twice with ``generation_order``, counted in
    ``bucket_plan_fused.launches``.  ``win`` (a 2-word int64 device
    tensor) and ``boff`` plan one table piece's window of the sorted
    lanes (the mesh engine).  ``check=False`` skips the argument checks:
    only for a caller that built the inputs itself.  ``stream``: the raw
    CUDA stream (default: the current one)."""
    if skey.device.type != "cuda":
        return bucket_plan_fused_plain(tfp, fp, payload, skey, order, cidx,
                                       cand_overflow, nbuckets,
                                       generation_order, win, boff)
    m = skey.shape[0]
    dev = skey.device
    bits = bucket_bits(nbuckets)
    if check:
        _cuda.require(tfp, "tfp", torch.int64, 1, dev)
        if tfp.shape[0] % SLOTS:
            raise ValueError("tfp: not a whole number of buckets")
        for t, name in ((fp, "fp"), (payload, "payload"), (skey, "skey"),
                        (order, "order")):
            _cuda.require(t, name, torch.int64, 1, dev, m)
        if cidx is not None:
            _cuda.require(cidx, "cidx", torch.int64, 1, dev, m)
        _cuda.require(cand_overflow, "cand_overflow", torch.bool, 0, dev)
        if win is not None:
            _cuda.require(win, "win", torch.int64, 1, dev, 2)
        elif boff or tfp.shape[0] != nbuckets * SLOTS:
            raise ValueError(f"tfp: {tfp.shape[0]} slots for {nbuckets} "
                             f"buckets at offset {boff}, and no window")
        if out is not None and (out.m, out.device) != (m, dev):
            raise ValueError(
                f"out: buffers for {out.m} lanes on {out.device}")
    if out is None:
        out = PlanBuffers(m, dev, generation_order)
    elif out.generation_order != generation_order:
        raise ValueError(f"out: buffers for generation_order="
                         f"{out.generation_order}")
    if stream is None:
        stream = _cuda.stream_of(skey)
    _cuda.check("bucket_plan_fused", _cuda.library().srt_bucket_plan_fused(
        tfp.data_ptr(), fp.data_ptr(), payload.data_ptr(), skey.data_ptr(),
        order.data_ptr(), None if cidx is None else cidx.data_ptr(),
        cand_overflow.data_ptr(), *out.ptrs, out.stage_ptr,
        None if win is None else win.data_ptr(), bits, boff, m, stream,
    ))
    _cuda.count_launch(bucket_plan_fused, 1 if out.stage is None else 2)
    return out.outputs


bucket_plan_fused.launches = 0


def bucket_insert(
    table_fp: torch.Tensor,  # int64[nbuckets * SLOTS]; EMPTY = free
    table_payload: torch.Tensor,  # int64[nbuckets * SLOTS]
    fps: torch.Tensor,  # int64[M] candidates (EMPTY = invalid lane)
    payloads: torch.Tensor,  # int64[M]
    compact: int = None,  # optional valid-candidate budget CB
    generation_order: bool = False,
):
    """Insert all valid candidates; returns ``(table_fp, table_payload,
    sel, n_new, overflow, cand_overflow)``, the tables updated IN PLACE.

    ``sel[:n_new]`` holds the ORIGINAL indices (into ``fps``) of the
    inserted candidates, in table order, or in their own order with
    ``generation_order`` (symmetry runs); later entries are arbitrary
    in-range indices.  On ``overflow`` (a bucket past SLOTS) or
    ``cand_overflow`` (more valid candidates than ``compact``) nothing was
    written and ``n_new`` is 0.  ``n_new``, ``overflow`` and
    ``cand_overflow`` are 0-d device tensors: nothing here syncs the host.
    ``compact=CB`` first compacts the valid lanes into a CB-wide buffer
    (order-preserving) and runs the rest at width CB.
    """
    nslots = table_fp.shape[0]
    if nslots % SLOTS:
        raise ValueError(f"table length {nslots} is not a whole number of buckets")
    fps, payloads, cidx, cand_overflow = compact_candidates(fps, payloads,
                                                            compact)
    skey, order = sort_keys(fps)
    tgt, cfp, cpl, sel, n_new, overflow = bucket_plan_fused(
        table_fp, fps, payloads, skey, order, cidx, cand_overflow,
        nslots // SLOTS, generation_order=generation_order,
    )
    insert_commit(table_fp, table_payload, tgt, cfp, cpl, n_new)
    return table_fp, table_payload, sel, n_new, overflow, cand_overflow


def occupancy_stats(table_fp) -> dict:
    """Bucket-occupancy counters for a visited table (numpy, JSON-safe);
    ``histogram[k]`` counts buckets holding exactly ``k`` fingerprints.
    Accepts ``uint64`` or int64-bit-pattern arrays."""
    t = np.asarray(table_fp).view(np.uint64).reshape(-1, SLOTS)
    per_bucket = (t != EMPTY_U64).sum(axis=1)
    nbuckets = int(t.shape[0])
    occupied = int(per_bucket.sum())
    hist = np.bincount(per_bucket, minlength=SLOTS + 1)
    lam = occupied / nbuckets if nbuckets else 0.0
    # Poisson tail mass at/over SLOTS for the observed load — the model the
    # <=25%-load growth policy assumes; compare with full_buckets/nbuckets
    tail = 0.0
    if lam > 0:
        p = math.exp(-lam)
        cum = p
        for k in range(1, SLOTS):
            p *= lam / k
            cum += p
        tail = max(0.0, 1.0 - cum)
    return {
        "nbuckets": nbuckets,
        "slots_per_bucket": SLOTS,
        "occupied": occupied,
        "load_factor": occupied / (nbuckets * SLOTS) if nbuckets else 0.0,
        "mean_bucket": lam,
        "max_bucket": int(per_bucket.max()) if nbuckets else 0,
        "full_buckets": int((per_bucket >= SLOTS).sum()),
        "poisson_full_expect": tail * nbuckets,
        "histogram": hist.tolist(),
    }


def host_bucket_rehash(
    table_fp: np.ndarray, table_payload: np.ndarray, new_nbuckets: int
):
    """Rebuild the bucketized table with ``new_nbuckets`` buckets (numpy
    ``uint64`` in and out).  Slots fill densely per bucket in the old
    table's slot order, so occupancy is implicit in the table itself."""
    if new_nbuckets & (new_nbuckets - 1):
        raise ValueError("bucket count must be a power of two")
    occ = table_fp != EMPTY_U64
    f = table_fp[occ]
    p = table_payload[occ]
    out_fp = np.full(new_nbuckets * SLOTS, EMPTY_U64, np.uint64)
    out_pl = np.zeros(new_nbuckets * SLOTS, np.uint64)
    bucket = bucket_of(f, new_nbuckets)
    order = np.argsort(bucket, kind="stable")
    bucket, f, p = bucket[order], f[order], p[order]
    start = np.searchsorted(bucket, bucket, side="left")
    rank = np.arange(f.size) - start
    if rank.size and rank.max() >= SLOTS:
        raise ValueError("bucket overflow during rehash; grow further")
    out_fp[bucket * SLOTS + rank] = f
    out_pl[bucket * SLOTS + rank] = p
    return out_fp, out_pl
