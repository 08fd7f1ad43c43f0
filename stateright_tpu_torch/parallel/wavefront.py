"""The GPU wavefront BFS engine — ``spawn_gpu()``.

The port's counterpart of ``stateright_tpu/parallel/wavefront.py``
(``_build_engine`` and ``TpuChecker``), single device, with symmetry
reduction, intra-window pre-dedup (``.prededup()``) and search
cartography (``.cartography()``); no POR, spill, checked mode or
prewarm.  The engine keeps a device-resident FIFO queue of state rows and
a bucketized visited table (``ops/buckets.py``), and each step pops a
batch and

 1. evaluates the property masks, recording first-hit fingerprints;
 2. expands every row through the twin's ``step_rows`` (and, for a twin
    with a ``within_boundary``, masks the successors outside it);
 3. flushes pending ``eventually`` bits at terminal rows;
 4. fingerprints, keys and compacts the successors (kernel
    ``cand_prep``), sorts them by bucket key, and plans the insert (kernel
    ``bucket_plan``);
 5. writes the novel fingerprints into the table and appends their rows
    at the queue tail (kernel ``insert_commit``).

On CUDA, steps 4 and 5 are three launches and one stable sort (four
launches under symmetry); the kernels' outputs and scratch are allocated
once per engine (``PrepBuffers``, ``PlanBuffers``).

**Symmetry reduction** (``.symmetry()``, JAX wavefront.py:469-473, :776):
the search still explores ORIGINAL rows, but the table is keyed on the
canonical class member's hash, the device form of the host DFS's
``_dedup_key``.  ``cand_prep`` hashes ``tensor.representative_rows(succ)``
(a twin's canonical rows may be wider or narrower than its rows: the
compiled twin's are a virtual row of ``n + 1 + NS`` words), while the
queue append copies ``succ``; the queue's fingerprints are the canonical
ones.  ``bucket_plan`` compacts the novel candidates in generation order,
so the reduced search is the one a host FIFO search over original states
with representative dedup makes, and so the JAX engine's.  Traces are
rebuilt by matching classes (``Path.from_fingerprints(key=...)``).

**Pre-dedup** (``.prededup()``, JAX wavefront.py:484-497): duplicate
fingerprints within one step's candidates are masked off before the
insert, the first occurrence kept (``ops/buckets.window_unique``).  The JAX
step dedups the hashed candidates before the budget compaction; here
``cand_prep`` fuses the hash with that compaction, so under the flag the
step hashes the candidate (or canonical) rows once more with the
``row_hash`` kernel, runs ``window_unique``, and gives ``cand_prep`` the
first-occurrence mask.  The state count still adds every generated state,
duplicates included (a device sum of the valid mask), and the candidate
budget's overflow is judged on the unique lanes, as in JAX.  With the
flag off the step issues none of these operations.

Pops are in BFS level order, so parent pointers record shortest paths.

**No host sync per step.**  The JAX engine runs ``steps_per_call`` steps in
one jitted ``while_loop`` whose ``cond`` stops at a non-OK status, an empty
queue, all properties discovered, or the target.  Here the cursors,
counters and status stay on the device and every step computes that same
``go`` flag there: a step after the stop is a no-op (its lanes are dead,
so nothing is inserted, and head, tail, counters and status keep their
values), so a block runs exactly the steps the JAX loop would, and the host
reads one packed stats tensor per block.  ``lax.dynamic_slice`` at
``head`` becomes an index gather at ``head + arange(batch)``, and the
append at ``tail`` writes only the ``n_new`` live lanes.  The table and
queue are updated in place.

**Growth without lost work** is the JAX engine's: at a block boundary
whose status is not OK the host rehashes the table (``host_bucket_rehash``)
or compacts/extends the queue in numpy, or doubles the candidate budget,
and resumes exactly where the device stopped.  A run with the same
capacities leaves the same table bytes as the JAX engine's.

**Cartography** (``.cartography()``, JAX wavefront.py:633-649, :735-745):
three counters ride the carry after its 13 snapshot buffers (the
per-action successor histogram, property evaluations and property hits),
updated each step with the state count's replay rule (an overflowed batch
counts nothing), and the queue-derived depth histogram joins them in the
packed stats tensor once a block (``ops/cartography.py``), so a host sync
is still one copy.  Growth reclaims the popped queue prefix on the host:
its depth lanes are banked first (``_bank_depth_lanes``), and the bank
travels in snapshots as ``cart_depth_base``.  With the flag off the step
issues none of these operations.

**Telemetry** (``.telemetry()``, JAX wavefront.py:2159-2473): the host loop
records one ``step`` per block from the stats it already read, ``growth``
records (and a ``growth`` span) at each growth event, occupancy samples,
the memory ledger's observations (``telemetry/memory.py``) and the
stage seconds (``device``, ``growth``, ``checkpoint``); none of it adds a
device operation or a host read to a block.

**Checkpoints** (JAX wavefront.py:2253-2268, :2386-2392): at each block
boundary, after the stats read and before any growth, the host loop
serves a pending ``checkpoint()`` and the autosave cadence
(``_base.WavefrontChecker._at_host_sync``), and a stopped run writes one
forced last generation.  A run resumed from any of these snapshots ends
with the uninterrupted run's table bytes and queue rows.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from .. import convert
from ..convert import (
    DISC, HEAD, MAXDEPTH, QDEPTH, QEBITS, QFP, QROWS, SCOUNT, STATUS, TAIL,
    TFP, TPL, UNIQUE,
)
from ..core import Expectation
from ..ops import _cuda
from ..ops.buckets import (
    SLOTS, PlanBuffers, bucket_insert, bucket_plan, host_bucket_rehash,
    window_unique,
)
from ..ops.cand_prep import PrepBuffers, cand_prep, sort_prepared
from ..ops.cartography import (
    DEPTH_BINS, action_hist_delta, cart_carry_shapes, prop_tally_delta,
    queue_depth_hist, queue_depth_hist_exact, queue_depth_hist_np, snapshot,
)
from ..ops.hashing import EMPTY, row_hash
from ..ops.insert_commit import QueueAppend, insert_commit
from ..telemetry.spans import span as tel_span
from ._base import WavefrontChecker

_STATUS_OK = 0
_STATUS_QUEUE_FULL = 1
_STATUS_TABLE_FULL = 2
_STATUS_CAND_FULL = 3  # valid candidates exceeded the compaction budget
_STATUS_POISON = 4  # a compiled-twin transition crossed its compile bound

# growth-record names for the flight recorder (telemetry.STATUS_NAMES)
_STATUS_TELEMETRY_NAMES = {
    _STATUS_OK: "ok",
    _STATUS_QUEUE_FULL: "queue_full",
    _STATUS_TABLE_FULL: "table_full",
    _STATUS_CAND_FULL: "cand_full",
    _STATUS_POISON: "poison",
}

# Packed stats layout: [head, tail, unique, scount, maxdepth, status, disc...]
# and, under cartography, [depth_hist, action_hist, prop_evals, prop_hits]
_ST_STATUS = 5
_ST_DISC = 6
_STATS_CARRY_ORDER = (HEAD, TAIL, UNIQUE, SCOUNT, MAXDEPTH, STATUS)
# the cartography counters ride the carry after its snapshot buffers
CART = len(convert.SNAPSHOT_KEYS)


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


# spawn_gpu()'s default table slots and rows a step
DEFAULT_CAPACITY, DEFAULT_BATCH = 1 << 17, 1 << 11


def default_caps(capacity: int = DEFAULT_CAPACITY, batch: int = DEFAULT_BATCH,
                 cand: Optional[int] = None,
                 queue_capacity: Optional[int] = None) -> dict:
    """The engine's first capacities for ``spawn_gpu``'s arguments: the
    table slots, the queue's high-water mark, the rows a step and the
    candidate budget (before the run clamps it to ``batch * arity``)."""
    cap = max(_pow2(capacity), 4 * SLOTS)
    batch = max(8, batch)
    return {"cap": cap, "qcap": queue_capacity or max(cap // 2, 4 * batch),
            "batch": batch, "cand": cand or max(4 * batch, 4096)}


def memory_spec_fn(tensor, n_props: int, *, cartography: bool = False,
                   sym: bool = False, cuda: bool = True):
    """``caps -> [BufferSpec]``: the memory ledger's analytic buffers of a
    run of ``tensor`` at the capacities ``caps`` (``telemetry/memory.
    wavefront_specs``)."""
    from ..telemetry.memory import wavefront_specs

    width, arity = tensor.width, tensor.max_actions

    def spec_fn(caps):
        return wavefront_specs(
            width, arity, n_props, int(caps["cap"]), int(caps["qcap"]),
            int(caps["batch"]), int(caps["cand"]), cartography=cartography,
            sym=sym, cuda=cuda,
        )

    return spec_fn


def _i32(x: int) -> int:
    """The int32 whose bits are the low 32 bits of ``x`` (queue ebits)."""
    x &= 0xFFFFFFFF
    return x - (1 << 32) if x >= 1 << 31 else x


def stats_of(carry: list, exact: bool = False) -> torch.Tensor:
    """Every scalar the host loop reads, packed into one int64 tensor, so
    a host sync is a single device-to-host copy.  A carry with the
    cartography counters (past :data:`CART`) appends the queue-derived
    depth histogram and the counters (JAX ``stats_of``'s layout);
    ``exact`` takes the exact histogram the JAX engine's host-side stats
    give after a growth or a resume (``ops/cartography.py``)."""
    parts = [torch.stack([carry[i] for i in _STATS_CARRY_ORDER]), carry[DISC]]
    if len(carry) > CART:
        hist = queue_depth_hist_exact if exact else queue_depth_hist
        parts.append(hist(carry[QDEPTH], carry[TAIL]))
        parts += carry[CART:]
    return torch.cat(parts)


def zero_counters(arity: int, n_props: int, device) -> list:
    """Fresh cartography counters: a new run's, or a resumed one's (the
    counters restart at zero, JAX wavefront.py:2129-2139)."""
    return [torch.zeros(s, dtype=torch.int64, device=device)
            for s in cart_carry_shapes(arity, n_props)]


def stats_host(carry_np: list, counters: np.ndarray) -> np.ndarray:
    """:func:`stats_of` of a numpy carry (the JAX engine's ``_stats_np``):
    the sync that follows a growth reads the carry the host just grew, not
    the device.  ``counters`` is the cartography counter section (empty
    when the counters are off)."""
    vals = [int(np.asarray(carry_np[i])) for i in _STATS_CARRY_ORDER]
    parts = [np.asarray(vals, np.int64),
             np.asarray(carry_np[DISC]).view(np.int64).reshape(-1)]
    if counters.size:
        parts.append(queue_depth_hist_np(carry_np[QDEPTH],
                                         int(carry_np[TAIL])))
        parts.append(counters)
    return np.concatenate(parts)


class _Engine:
    """The device program for fixed capacities: :meth:`init` builds the
    initial carry, :meth:`run` advances it by up to ``steps`` steps."""

    def __init__(self, tensor, props, cap: int, qcap: int, batch: int,
                 steps: int, target: Optional[int], cand: Optional[int],
                 device, sym: bool = False, prededup: bool = False,
                 removed: Optional[torch.Tensor] = None,
                 cartography: bool = False):
        self.tensor, self.props = tensor, props
        self.cap, self.qcap, self.batch, self.steps = cap, qcap, batch, steps
        self.target, self.device, self.sym = target, device, sym
        self.cart = cartography
        self.key = (cap, qcap, batch, cand, sym, cartography)
        self.width, self.arity = tensor.width, tensor.max_actions
        self.m = batch * self.arity
        self.eff_cand = min(cand, self.m) if cand else self.m
        # the queue over-allocates one batch's candidates past the
        # high-water mark
        self.qalloc = qcap + self.m
        self.prededup = prededup
        # under prededup, a device count of the lanes it took out
        self.removed = removed
        self.ev_idx = [
            i for i, p in enumerate(props)
            if p.expectation is Expectation.EVENTUALLY
        ]
        if len(self.ev_idx) > 32:
            raise ValueError("at most 32 eventually properties are supported")
        self.ebit_of = {i: e for e, i in enumerate(self.ev_idx)}
        self.init_ebits = _i32((1 << len(self.ev_idx)) - 1)
        self.lanes = torch.arange(batch, device=device)
        # the compiled twins' hooks: a tabulated within_boundary, and the
        # poison bit of a row reached across a compile-time bound
        self.boundary_fn = (tensor.boundary_rows
                            if getattr(tensor, "has_boundary", False) else None)
        self.poison_fn = getattr(tensor, "poison_rows", None)
        # the insert's own buffers (validated here, so the step launches
        # unchecked) and the stream its kernels go to
        self.prep_out = self.plan_out = self.stream = None
        if self.device.type == "cuda":
            self.prep_out = PrepBuffers(self.m, self.eff_cand, self.device)
            self.plan_out = PlanBuffers(self.eff_cand, self.device, sym)
            self.stream = _cuda.stream_of(self.plan_out.tgt)

    # -- step pieces ---------------------------------------------------------

    def _record_first(self, cur, hit, fps):
        """First-wins discovery at the first hit row.  The first row is
        gathered with ``index_select`` on a one-element index: indexing
        with a 0-d tensor would read the index on the host (a
        device-to-host copy and a stream sync per property per step)."""
        first = torch.argmax(hit.to(torch.int8)).reshape(1)
        fp = fps.index_select(0, first).squeeze(0)
        take = (cur == 0) & hit.any()
        return torch.where(take, fp, cur)

    def eval_props(self, masks, fps, live, ebits, disc):
        out = list(disc.unbind())
        for i, p in enumerate(self.props):
            if p.expectation is Expectation.ALWAYS:
                out[i] = self._record_first(out[i], live & ~masks[:, i], fps)
            elif p.expectation is Expectation.SOMETIMES:
                out[i] = self._record_first(out[i], live & masks[:, i], fps)
            else:
                clear = _i32(~(1 << self.ebit_of[i]))
                ebits = torch.where(masks[:, i], ebits & clear, ebits)
        return ebits, torch.stack(out)

    def flush_terminal(self, terminal, fps, ebits, disc):
        if not self.ev_idx:
            return disc
        out = list(disc.unbind())
        for i in self.ev_idx:
            bit = (ebits >> self.ebit_of[i]) & 1
            out[i] = self._record_first(out[i], terminal & (bit == 1), fps)
        return torch.stack(out)

    def all_discovered(self, disc):
        if not self.props:
            return torch.zeros((), dtype=torch.bool, device=self.device)
        return (disc != 0).all()

    def step(self, c: list) -> list:
        """Pop one batch, expand, dedup+insert, append novel rows."""
        batch, arity, m, width = self.batch, self.arity, self.m, self.width
        head, tail, unique = c[HEAD], c[TAIL], c[UNIQUE]
        status, disc = c[STATUS], c[DISC]
        go = (status == _STATUS_OK) & (tail > head) & ~self.all_discovered(disc)
        if self.target is not None:
            go &= unique < self.target
        n_avail = torch.where(go, tail - head, 0)
        pos = (head + self.lanes).clamp_(max=self.qalloc - 1)
        rows = c[QROWS][pos]
        fps = c[QFP][pos]
        ebits = c[QEBITS][pos]
        depths = c[QDEPTH][pos]
        live = self.lanes < n_avail

        masks = self.tensor.property_masks(rows)  # [B, P] bool
        ebits, disc = self.eval_props(masks, fps, live, ebits, disc)
        maxdepth = torch.maximum(
            c[MAXDEPTH], torch.where(live, depths, 0).max().to(torch.int64)
        )
        # mid-run early exit: stop expanding once every property has a
        # discovery (reference ``bfs.rs:121-128``)
        elive = live & ~self.all_discovered(disc)
        succ, valid = self.tensor.step_rows(rows)  # [B, A, W], [B, A]
        if self.boundary_fn is not None:
            # mirror the host checkers: out-of-boundary successors are
            # neither counted nor enqueued, and a state whose successors
            # all fall outside IS terminal for the ebits flush
            valid = valid & self.boundary_fn(succ)
        valid = valid & elive[:, None]
        terminal = elive & ~valid.any(dim=-1)
        disc = self.flush_terminal(terminal, fps, ebits, disc)

        cand_rows = succ.reshape(m, width)
        # under symmetry the table is keyed on the canonical rows' hash,
        # while the queue keeps the original rows
        krows = (self.tensor.representative_rows(succ).reshape(m, -1)
                 .contiguous() if self.sym else cand_rows)
        cvalid = kept = valid.reshape(m)
        if self.prededup:  # only each fingerprint's first lane goes on
            kept = window_unique(row_hash(krows, cvalid)) != EMPTY
        # the engine built every input itself: the kernels run unchecked
        pfp, ppl, cidx, key, n_valid, coverflow = cand_prep(
            krows, kept, fps, arity, self.eff_cand,
            self.prep_out, check=False, stream=self.stream,
        )
        # the state count adds every generated state, repeats included
        n_gen = cvalid.sum() if self.prededup else n_valid
        sfp, spl, bucket, order = sort_prepared(pfp, ppl, key,
                                                self.cap // SLOTS)
        tgt, cfp, cpl, sel, n_new, toverflow = bucket_plan(
            c[TFP], sfp, spl, bucket, order, cidx, coverflow, self.plan_out,
            generation_order=self.sym, check=False, stream=self.stream,
        )
        insert_commit(
            c[TFP], c[TPL], tgt, cfp, cpl, n_new,
            QueueAppend(c[QROWS], c[QFP], c[QEBITS], c[QDEPTH], tail, sel,
                        cand_rows, ebits, depths, arity),
            check=False, stream=self.stream,
        )

        # any overflow means the batch wrote nothing durable: cursors and
        # counters stay so it replays after the host grows
        overflow = toverflow | coverflow
        head = torch.where(overflow, head, head + torch.clamp(n_avail, max=batch))
        tail = tail + n_new
        unique = unique + n_new
        scount = torch.where(overflow, c[SCOUNT], c[SCOUNT] + n_gen)
        if self.prededup:
            self.removed.add_(torch.where(overflow, 0, n_gen - n_valid))
        if self.cart:
            # the state count's replay rule: an overflowed batch counts
            # nothing (the depth histogram reads the queue, which an
            # overflowed insert did not append to)
            d_evals, d_hits = prop_tally_delta(live, masks, len(self.props))
            for i, d in enumerate((action_hist_delta(valid), d_evals, d_hits)):
                c[CART + i] = c[CART + i] + torch.where(overflow, 0, d)
        # clean-boundary growth triggers (table target load <= 25%)
        new_status = torch.where(
            toverflow | (unique * 4 > self.cap) | (self.eff_cand * 4 > self.cap),
            _STATUS_TABLE_FULL,
            torch.where(
                coverflow, _STATUS_CAND_FULL,
                torch.where(tail > self.qcap, _STATUS_QUEUE_FULL, status),
            ),
        )
        if self.poison_fn is not None:
            # a poisoned popped row means a reachable transition crossed a
            # compile-time bound: counts would be silently wrong, and
            # growing cannot fix a bound, so this status wins
            new_status = torch.where((self.poison_fn(rows) & live).any(),
                                     _STATUS_POISON, new_status)
        status = torch.where(go, new_status, status)
        c[HEAD], c[TAIL], c[UNIQUE], c[SCOUNT] = head, tail, unique, scount
        c[DISC], c[MAXDEPTH], c[STATUS] = disc, maxdepth, status
        return c

    # -- programs ------------------------------------------------------------

    def run(self, carry: list):
        """Up to ``steps`` steps (no-ops once the run must stop); returns
        ``(carry, stats)``."""
        carry = list(carry)
        for _ in range(self.steps):
            carry = self.step(carry)
        return carry, stats_of(carry)

    def init(self):
        dev, cap, qalloc = self.device, self.cap, self.qalloc
        i64 = dict(dtype=torch.int64, device=dev)
        i32 = dict(dtype=torch.int32, device=dev)
        tfp = torch.full((cap,), EMPTY, **i64)
        tpl = torch.zeros((cap,), **i64)
        qrows = torch.zeros((qalloc, self.width), **i64)
        qfp = torch.full((qalloc,), EMPTY, **i64)
        qebits = torch.zeros((qalloc,), **i32)
        qdepth = torch.zeros((qalloc,), **i32)

        init_np = np.asarray(self.tensor.init_rows(), np.uint64)
        n_init = init_np.shape[0]
        irows = torch.from_numpy(init_np.view(np.int64).copy()).to(dev)
        ifp = row_hash(self.tensor.representative_rows(irows).contiguous()
                       if self.sym else irows)
        tfp, tpl, sel, n_new, overflow, _ = bucket_insert(
            tfp, tpl, ifp, torch.zeros((n_init,), **i64),  # parent 0 = init
            generation_order=self.sym,
        )
        qrows[:n_init] = irows[sel]
        qfp[:n_init] = ifp[sel]
        qebits[:n_init] = self.init_ebits
        status = torch.where(
            overflow | (n_new * 4 > cap) | (self.eff_cand * 4 > cap),
            _STATUS_TABLE_FULL,
            torch.where(n_new > self.qcap, _STATUS_QUEUE_FULL, _STATUS_OK),
        )
        zero = torch.zeros((), **i64)
        carry = [
            tfp, tpl, qrows, qfp, qebits, qdepth,
            zero, n_new, n_new.clone(),
            torch.tensor(n_init, **i64),  # state_count counts all inits
            torch.zeros((max(len(self.props), 1),), **i64),
            zero.clone(), status,
        ]
        if self.cart:
            carry += zero_counters(self.arity, len(self.props), dev)
        return carry, stats_of(carry)


class GpuChecker(WavefrontChecker):
    """Queue-based wavefront BFS on a CUDA device (or, in tests, the CPU).

    ``capacity`` — table slots (grown on demand, work preserved).
    ``queue_capacity`` — queue high-water mark (default ``max(capacity //
    2, 4 * batch)``; grown on demand).  ``batch`` — rows expanded per
    device step.  ``cand`` — valid-candidate
    compaction budget per batch (default ``max(4 * batch, 4096)``; doubled
    on demand).  ``steps_per_call`` — device steps per host sync.
    ``device`` — ``None`` means ``cuda``, and raises when there is no CUDA
    device.  ``resume`` — a snapshot (``convert.py``) to continue from.
    """

    # the engine's name in telemetry, reports and the run registry (the
    # JAX engine's is "wavefront": a JAX-vs-port report pair is an engine
    # delta, whose contract is identical counts)
    _telemetry_tag = _report_engine = "gpu-wavefront"

    def __init__(self, options, capacity: int = DEFAULT_CAPACITY,
                 batch: int = DEFAULT_BATCH,
                 cand: Optional[int] = None, steps_per_call: int = 64,
                 device=None, resume: Optional[dict] = None,
                 queue_capacity: Optional[int] = None):
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "spawn_gpu(): no CUDA device is available (the port "
                    "never falls back to the CPU; pass device='cpu' to run "
                    "the plain PyTorch path)"
                )
            device = "cuda"
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        caps = default_caps(capacity, batch, cand, queue_capacity)
        self._cap, self._qcap = caps["cap"], caps["qcap"]
        self._batch, self._cand = caps["batch"], caps["cand"]
        self._steps = steps_per_call
        self._resume = resume
        # (status, unique-at-boundary) per mid-run growth event, and the
        # host seconds each took (device sync, host rehash and copies)
        self.growth_events: list = []
        self.growth_secs: list = []
        # under the memory ledger on cuda, per growth event: the forecast
        # transient (the buffers before and after, live together) and the
        # run's measured allocation peak across the growth, where the
        # growth raised the process's peak (the device's peak counters
        # are the caller's and are never reset here)
        self.growth_memory: list = []
        self.steps_run = 0  # device steps issued, post-stop no-ops included
        self._final_carry = None
        self._last_engine: Optional[_Engine] = None
        # under prededup, the lanes it took out since this process started
        self._removed = torch.zeros((), dtype=torch.int64,
                                    device=self.device)
        self._init_common(options)

    def _engine(self, cap, qcap, batch, cand) -> _Engine:
        return _Engine(self.tensor, self._props, cap, qcap, batch,
                       self._steps, self._target, cand, self.device,
                       sym=self._symmetry is not None,
                       prededup=self._prededup, removed=self._removed,
                       cartography=self._cartography)

    def _pre_run_validate(self) -> None:
        if self._resume is not None:
            self._check_snapshot_sig(self._resume)

    def _qalloc(self, qcap: int, batch: int) -> int:
        return qcap + batch * self.tensor.max_actions

    # -- memory-ledger hooks (telemetry/memory.py) ---------------------------

    def _memory_spec_fn(self):
        return memory_spec_fn(
            self.tensor, len(self._props), cartography=self._cartography,
            sym=self._symmetry is not None, cuda=self.device.type == "cuda",
        )

    def _memory_caps(self, cap=None, qcap=None, batch=None, cand=None) -> dict:
        batch = self._batch if batch is None else batch
        return {
            "cap": self._cap if cap is None else cap,
            "qcap": self._qcap if qcap is None else qcap,
            "batch": batch,
            "cand": min(self._cand if cand is None else cand,
                        batch * self.tensor.max_actions),
        }

    def live_buffers(self) -> dict:
        """The finished run's device-resident buffers, ``name -> tensor``
        under the memory ledger's names (``telemetry/memory.py``): the
        carry, the cartography counters, and the last engine's lane index
        and kernel buffers.  What the ledger's analytic bytes are held
        against."""
        from ..telemetry.memory import _CARRY_NAMES, _CART_NAMES

        self.join()
        c = self._final_carry
        out = dict(zip(_CARRY_NAMES, c[:CART]))
        out.update(zip(_CART_NAMES, c[CART:]))
        eng = self._last_engine
        if eng is not None:
            out["lanes"] = eng.lanes
            for pre, buf, names in (
                ("prep", eng.prep_out,
                 ("fp", "payload", "cidx", "key", "n_valid",
                  "cand_overflow", "scratch")),
                ("plan", eng.plan_out,
                 ("tgt", "cfp", "cpl", "sel", "n_new", "overflow",
                  "scratch", "stage")),
            ):
                for n in names if buf is not None else ():
                    t = getattr(buf, n)
                    if t is not None:
                        out[f"{pre}_{n}"] = t
        return out

    # -- cartography (ops/cartography.py) ------------------------------------

    def _bank_depth_lanes(self, qdepth, n: int) -> None:
        """Fold the depth lanes of ``qdepth[:n]`` (the queue prefix a
        growth reclaims) into the depth bank (JAX wavefront.py:1167-1179),
        so ``sum(depth_hist) == unique`` survives the reclaim.  No-op with
        cartography off."""
        if not self._cartography or n <= 0:
            return
        if self._cart_depth_base is None:
            self._cart_depth_base = np.zeros(DEPTH_BINS, np.int64)
        self._cart_depth_base += queue_depth_hist_np(qdepth, n)

    def _sync_cartography(self, tail, *, states: int, unique: int) -> None:
        """Parse the cartography section of the packed stats (the part
        after the discovery fingerprints) into the live snapshot, and hand
        it to the flight recorder (JAX wavefront.py:1181-1209)."""
        arity = max(self.tensor.max_actions, 1)
        p = max(len(self._props), 1)
        dh = np.asarray(tail[:DEPTH_BINS]).astype(np.int64)
        if self._cart_depth_base is not None:
            dh = dh + self._cart_depth_base
        o = DEPTH_BINS
        ah, pe, ph = (tail[o:o + arity], tail[o + arity:o + arity + p],
                      tail[o + arity + p:o + arity + 2 * p])
        snap = snapshot(
            depth_hist=dh, action_hist=ah, prop_evals=pe, prop_hits=ph,
            prop_names=[pr.name for pr in self._props],
            states=states, unique=unique,
        )
        self._live_cart = snap
        if self.flight_recorder is not None:
            self.flight_recorder.set_cartography(snap)

    # -- growth ---------------------------------------------------------------

    def _grow(self, carry_np: list, cap: int, qcap: int, batch: int,
              status: int, cand: int):
        """Grow whatever is (near) full; returns ``(cap, qcap, carry_np)``.
        Both conditions are re-checked whichever status fired."""

        def table_small():
            return int(carry_np[UNIQUE]) * 4 > cap or cand * 4 > cap

        if table_small() or status == _STATUS_TABLE_FULL:
            if table_small():
                while table_small():
                    cap *= 2
            else:
                cap *= 2  # a single bucket clustered past SLOTS entries
            carry_np[TFP], carry_np[TPL] = host_bucket_rehash(
                carry_np[TFP], carry_np[TPL], cap // SLOTS
            )
        head, tail = int(carry_np[HEAD]), int(carry_np[TAIL])
        pending = tail - head
        # bank the depth lanes of the prefix the slice below drops, or the
        # queue-derived depth histogram forgets every popped state
        self._bank_depth_lanes(carry_np[QDEPTH], head)
        # reclaim the consumed prefix; grow only if still needed
        for i in convert.QUEUE:
            carry_np[i] = carry_np[i][head:tail].copy()
        carry_np[HEAD] = np.int32(0)
        carry_np[TAIL] = np.int32(pending)
        while pending * 2 > qcap:
            qcap *= 2
        carry_np[STATUS] = np.int32(_STATUS_OK)
        convert.repad_queue(carry_np, self._qalloc(qcap, batch))
        return cap, qcap, carry_np

    def _regrow(self, carry, cap, qcap, batch, status, cand, at=None):
        """:meth:`_grow` over a device carry (through the host); returns
        ``(cap, qcap, carry, carry_np)``, the grown carry on the device and
        as numpy.  ``at`` names a growth boundary the recorder samples:
        the carry's bytes both ways and the table's occupancy (free: the
        table is on the host here).  The cartography counters past
        :data:`CART` are not part of the transform and stay as they are."""
        rec = self.flight_recorder
        carry_np = convert.carry_to_arrays(carry[:CART])
        if rec is not None and at is not None:
            rec.add_bytes(d2h=sum(a.nbytes for a in carry_np if a.ndim))
            self._telemetry_occupancy(carry_np[TFP], at=at)
        cap, qcap, carry_np = self._grow(carry_np, cap, qcap, batch, status,
                                         cand)
        if rec is not None and at is not None:
            rec.add_bytes(h2d=sum(a.nbytes for a in carry_np if a.ndim))
        grown = convert.carry_from_arrays(
            carry_np, self.device, self._qalloc(qcap, batch)
        )
        return cap, qcap, grown + list(carry[CART:]), carry_np

    def _peaks(self) -> tuple:
        """The device's peak counters now: requested and allocated bytes."""
        st = torch.cuda.memory_stats(self.device)
        return (st["requested_bytes.all.peak"],
                st["allocated_bytes.all.peak"])

    def _growth_peak(self, opened: tuple, after: dict, base: tuple) -> None:
        """Close one growth's memory measurement (memory ledger on cuda).

        ``opened`` is the capacities before the growth and the device's
        peak counters as it began.  The counters belong to the process and
        are never reset here, so a growth's own peak is known exactly only
        where it raised them: then it is the new peak, above ``base`` (the
        current bytes as the run began).  Otherwise it was at most the
        earlier peak and the entry's ``peak_*`` is None.  Each entry sits
        beside the ledger's forecast for this growth
        (``telemetry/memory.transient_block``)."""
        from ..telemetry.memory import MEMORY_V, transient_block

        before, (req0, alloc0) = opened
        req1, alloc1 = self._peaks()
        entry = {
            "before": before, "after": after,
            **transient_block(self._memory_spec_fn(), before, after),
            "peak_requested_bytes": req1 - base[0] if req1 > req0 else None,
            "peak_bytes": alloc1 - base[1] if alloc1 > alloc0 else None,
        }
        self.growth_memory.append(entry)
        if self.flight_recorder is not None:
            self.flight_recorder.record("memory", v=MEMORY_V, at="growth_peak",
                                        **entry)

    # -- the host loop ---------------------------------------------------------

    def _run(self) -> None:
        cap, qcap, batch = self._cap, self._qcap, self._batch
        arity = self.tensor.max_actions
        cand = min(self._cand, batch * arity)
        rec = self.flight_recorder
        cart = self._cartography
        # the growth memory measurement (memory ledger on cuda): the run's
        # own allocations are counted above what the process held before
        measure = self._mem_ledger is not None and self.device.type == "cuda"
        mem_base = None
        if measure:
            st = torch.cuda.memory_stats(self.device)
            mem_base = (st["requested_bytes.all.current"],
                        st["allocated_bytes.all.current"])
        # static preconditions: cand*4 <= cap, and the init set fits the queue
        while cand * 4 > cap:
            cap *= 2
        n_init = len(np.asarray(self.tensor.init_rows()))
        while n_init > qcap:
            qcap *= 2
        self._cap, self._qcap, self._cand = cap, qcap, cand
        t_dev = time.perf_counter()
        if self._resume is not None:
            snap = self._resume
            cap, qcap = int(snap["cap"]), int(snap["qcap"])
            batch = self._batch = int(snap.get("batch", batch))
            cand = min(int(snap.get("cand", cand)), batch * arity)
            base = convert.cart_depth_base(snap)
            if base is not None:
                self._cart_depth_base = base
            carry = convert.carry_from_snapshot(
                snap, self.device, self._qalloc(qcap, batch)
            )
            stats = None
            # a snapshot taken at a growth boundary still carries the flag
            st = int(carry[STATUS])
            if st != _STATUS_OK:
                if st == _STATUS_CAND_FULL:
                    cand = min(cand * 2, batch * arity)
                cap, qcap, carry, _ = self._regrow(carry, cap, qcap, batch,
                                                   st, cand)
            if cart:
                # a resumed run restarts its counters at zero (JAX
                # wavefront.py:2129-2139); the depth histogram comes back
                # whole: the snapshot kept the queue and the bank
                carry = carry + zero_counters(arity, len(self._props),
                                              self.device)
        else:
            while True:
                carry, stats = self._engine(cap, qcap, batch, cand).init()
                # a table-full init wrote nothing: grow and re-init
                if int(stats[_ST_STATUS]) != _STATUS_TABLE_FULL:
                    break
                prev = cap
                while n_init * 4 > cap or cand * 4 > cap:
                    cap *= 2
                if cap == prev:
                    cap *= 2  # guarantee progress on a clustered init set

        disc_len = max(len(self._props), 1)
        cart_off = _ST_DISC + disc_len
        sym = self._symmetry is not None
        occ_every = int(self._telemetry_opts.get("occupancy_every") or 0)
        syncs = 0
        if rec is not None:
            rec.update_meta(batch=batch, steps_per_call=self._steps)
        engine = None
        ran_block = False
        peak_from = None  # (caps, peaks) as a measured growth began
        while True:
            if stats is None:
                # after a resume or a budget doubling: the exact depth
                # histogram, as the JAX engine's host-side stats give
                stats = stats_of(carry, exact=True)
            if isinstance(stats, torch.Tensor):
                stats = stats.cpu().numpy()  # the block's one host sync
            self._stage("device", time.perf_counter() - t_dev)
            if ran_block and self._profiler is not None:
                self._profiler.tick()
            head, tail, unique, scount, maxdepth, status = (
                int(x) for x in stats[:_ST_DISC]
            )
            disc = stats[_ST_DISC:cart_off].view(np.uint64)
            self._live = (scount, unique, maxdepth)
            if cart:
                self._sync_cartography(stats[cart_off:], states=scount,
                                       unique=unique)
            if rec is not None:
                # host values this sync already read: the telemetry cost
                # is a few dict appends per block
                syncs += 1
                rec.add_bytes(d2h=stats.nbytes)
                rec.step(
                    engine=self._telemetry_tag, states=scount, unique=unique,
                    depth=maxdepth, status=status, queue=max(tail - head, 0),
                    cap=cap, cand=cand, load_factor=round(unique / cap, 6),
                )
                if occ_every and syncs % occ_every == 0:
                    self._telemetry_occupancy(carry[TFP], at=f"sync{syncs}",
                                              transferred=True)
                if self._mem_ledger is not None:
                    self._mem_ledger.observe(
                        self._memory_caps(cap, qcap, batch, cand),
                        extra={"queue_capacity": qcap,
                               "candidate_budget": cand},
                    )
            if status == _STATUS_POISON:
                raise RuntimeError(
                    "poisoned rows reached by the device run: a compiled "
                    "transition crossed its compile-time state_bound/"
                    "env_bound, so counts would be silently wrong. Loosen "
                    "the bounds (they must cover everything the bounded "
                    "configuration actually reaches)."
                )

            def snap_fn():
                return self._snapshot(carry, cap, qcap, batch, cand)

            # a pending checkpoint and the autosave cadence are served
            # BEFORE growing: a boundary snapshot carries status != OK, and
            # resume re-applies the growth
            saved = self._at_host_sync(snap_fn)
            if status != _STATUS_OK:
                self.growth_events.append((status, unique))
                if measure:
                    if peak_from is not None:
                        self._growth_peak(peak_from, self._memory_caps(
                            cap, qcap, batch, cand), mem_base)
                    peak_from = (self._memory_caps(cap, qcap, batch, cand),
                                 self._peaks())
                name = _STATUS_TELEMETRY_NAMES.get(status, str(status))
                if rec is not None:
                    rec.record("growth", status=name, unique=unique, cap=cap,
                               qcap=qcap, cand=cand)
                    if status == _STATUS_CAND_FULL:
                        rec.add("compaction_hits")
                    if cart:
                        # growth boundaries are the cartography time series
                        rec.record("cartography", at="growth",
                                   **self._live_cart)
                t0 = time.perf_counter()
                with tel_span("growth", rec, parent=self._run_span_ctx,
                              status=name, unique=unique):
                    if status == _STATUS_CAND_FULL:
                        # the budget is an engine parameter: double it,
                        # clear the status (the insert wrote nothing),
                        # replay
                        cand = min(cand * 2, batch * arity)
                        carry[STATUS] = torch.zeros_like(carry[STATUS])
                        stats = None
                        while cand * 4 > cap:
                            cap, qcap, carry, _ = self._regrow(
                                carry, cap, qcap, batch, _STATUS_TABLE_FULL,
                                cand,
                            )
                    else:
                        cap, qcap, carry, carry_np = self._regrow(
                            carry, cap, qcap, batch, status, cand,
                            at="growth",
                        )
                        # the next sync reads the carry the host just grew
                        stats = stats_host(carry_np, stats[cart_off
                                                           + DEPTH_BINS:]
                                           if cart else stats[:0])
                secs = time.perf_counter() - t0
                self.growth_secs.append(secs)
                self._stage("growth", secs)
                t_dev = time.perf_counter()
                ran_block = False
                continue
            if self._stop.is_set():
                # stop()/timeout(): one forced last generation (unless this
                # sync wrote one), so a stopped run loses at most the
                # current block
                if not saved:
                    self._maybe_autosave(snap_fn, force=True)
                break
            all_disc = bool(self._props) and bool((disc != 0).all())
            target_hit = self._target is not None and unique >= self._target
            if tail <= head or all_disc or target_hit:
                break
            if engine is None or engine.key != (cap, qcap, batch, cand, sym,
                                                cart):
                engine = self._engine(cap, qcap, batch, cand)
            if peak_from is not None:
                self._growth_peak(peak_from, self._memory_caps(
                    cap, qcap, batch, cand), mem_base)
                peak_from = None
            if self._profiler is not None:
                self._profiler.maybe_start()
            t_dev = time.perf_counter()
            carry, stats = engine.run(carry)
            ran_block = True
            self.steps_run += engine.steps

        if peak_from is not None:
            self._growth_peak(peak_from, self._memory_caps(
                cap, qcap, batch, cand), mem_base)
        self._cap, self._qcap, self._cand = cap, qcap, cand
        self._final_carry = carry
        self._last_engine = engine
        if self._profiler is not None:
            self._profiler.stop()
        if rec is not None and occ_every:
            # close the occupancy series with the final table (a D2H pull,
            # taken only when sampling was asked for)
            self._telemetry_occupancy(carry[TFP], at="final", transferred=True)
        self._results = {
            "unique": unique,
            "states": scount,
            "disc": np.asarray(disc),
            "depth": maxdepth,
        }
        if cart:
            self._results["cartography"] = self._live_cart
            if rec is not None:
                rec.record("cartography", at="final", **self._live_cart)
        if self._mem_ledger is not None:
            self._mem_ledger.finalize()
        if rec is not None:
            # a deadline-cut run stopped; it did not finish
            rec.close_run(done=not self._timed_out)

    def prededup_removed(self) -> Optional[int]:
        """Under ``.prededup()``, the valid successor lanes the pre-dedup
        took out of this run's committed steps (each a repeat of an earlier
        lane's fingerprint in its step).  The count lives in this process,
        outside the carry and its snapshots, so a resumed run, whose state
        count covers the steps before the resume too, has none: None then,
        and when the flag is off."""
        self.join()
        if not self._prededup or self._resume is not None:
            return None
        return int(self._removed)

    def _table_np(self):
        return tuple(
            self._final_carry[i].cpu().numpy().view(np.uint64)
            for i in (TFP, TPL)
        )

    def _snapshot(self, carry, cap, qcap, batch, cand) -> dict:
        """A carry as a snapshot in the JAX engine's layout (numpy, copied
        off the device): either engine resumes from it.  It carries the
        run's id (a resumed run records it as its parent), the analytic
        footprint at these capacities (``telemetry/memory.py``) and the
        cartography depth bank."""
        extra = {}
        fb = self._analytic_footprint_bytes(
            self._memory_caps(cap, qcap, batch, cand))
        if fb is not None:
            extra["footprint_bytes"] = np.int64(fb)
        return convert.carry_to_snapshot(
            carry[:CART], cap, qcap, batch, cand, width=self.tensor.width,
            engine=self._engine_tag, model_sig=self._model_sig(),
            run_id=self.run_id, cart_depth_base=self._cart_depth_base,
            **extra,
        )

    def final_snapshot(self) -> dict:
        """The finished run's carry as a snapshot (:meth:`_snapshot`)."""
        self.join()
        return self._snapshot(self._final_carry, self._cap, self._qcap,
                              self._batch, self._cand)
