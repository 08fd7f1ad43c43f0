"""The GPU wavefront BFS engine — ``spawn_gpu()``.

The port's counterpart of ``stateright_tpu/parallel/wavefront.py``
(``_build_engine``, ``_build_inject`` and ``TpuChecker``), single device,
with symmetry reduction, intra-window pre-dedup (``.prededup()``),
partial-order reduction (``.por()``), search cartography
(``.cartography()``), checked mode (``.checked()``), the spill tier
(``.spill()``) and engine prewarm (``.prewarm()``).  The engine keeps a
device-resident FIFO queue of state rows and
a bucketized visited table (``ops/buckets.py``), and each step pops a
batch and

 1. evaluates the property masks, recording first-hit fingerprints;
 2. expands every row through the twin's ``step_rows`` (and, for a twin
    with a ``within_boundary``, masks the successors outside it);
 3. flushes pending ``eventually`` bits at terminal rows;
 4. fingerprints, keys and compacts the successors (kernel
    ``cand_prep``), sorts them by bucket key, and plans the insert (kernel
    ``bucket_plan``'s fused entry, which reads the unsorted lanes through
    the sort's permutation);
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

**The block loop on the device.**  The JAX engine runs ``steps_per_call``
steps in one jitted ``while_loop`` whose ``cond`` stops at a non-OK status,
an empty queue, all properties discovered, the target or a failed check.
Here the cursors, counters and status stay on the device and every step
computes that same ``go`` flag there (:meth:`_Engine.go_of`): a step whose
``go`` is false leaves every carry entry as it was (its lanes are dead, so
nothing is inserted or deferred, and head, tail, counters and status keep
their values).  On CUDA a block is one launch of the engine's block graph
(``ops/block_loop.py``): the step captured once per engine key, inside a
conditional WHILE node that the ``block_cond`` kernel stops, so no step
runs after the stop; on the CPU the eager loop (:meth:`_Engine._run_steps`)
issues every step.  Either way a block does the work the JAX loop does, its
stats carry the steps it executed, and the host reads one packed stats
tensor per block.  ``lax.dynamic_slice`` at
``head`` becomes an index gather at ``head + arange(batch)``, and the
append at ``tail`` writes only the ``n_new`` live lanes.  The table and
queue are updated in place.

**Growth without lost work** is the JAX engine's: at a block boundary
whose status is not OK the host rehashes the table (``host_bucket_rehash``)
or compacts/extends the queue in numpy, or doubles the candidate budget,
and resumes exactly where the device stopped.  A run with the same
capacities leaves the same table bytes as the JAX engine's.

**Cartography** (``.cartography()``, JAX wavefront.py:633-649, :735-745):
three counters ride the carry's tail (the
per-action successor histogram, property evaluations and property hits),
updated each step with the state count's replay rule (an overflowed batch
counts nothing), and the queue-derived depth histogram joins them in the
packed stats tensor once a block (``ops/cartography.py``), so a host sync
is still one copy.  Growth reclaims the popped queue prefix on the host:
its depth lanes are banked first (``_bank_depth_lanes``), and the bank
travels in snapshots as ``cart_depth_base``.  With the flag off the step
issues none of these operations.

**The carry's optional tail** (:class:`CarryLayout`, JAX wavefront.py:
300-306) follows its 13 snapshot buffers: the checked error word, the POR
pair, the spill tail, the cartography counters, each only under its
flag.

**Partial-order reduction** (``.por()``, JAX wavefront.py:266-277,
:474-495, :519-545, :608-630): the step masks each row's enabled actions
to an ample set (``ops/por.ample_mask``, over the plan of
``analysis/independence.py``; every enabled action while the carry's
boost word is armed) and inserts those successors; then, in a second
insert appended after the first's rows, the other successors of every
reduced row none of whose ample successors was novel (the cycle
proviso).  Each insert is ``cand_prep``, the sort, ``bucket_plan_fused`` and
``insert_commit``, the second into a buffer pair of its own so the
first's ``tgt``, ``sel`` and ``n_new`` survive it.  An overflow in
either writes the first's and the second's slots back to empty
(``_Engine._rollback``: an add, no table copy, no host read), so the
replay after growth sees the same novelty; the state count adds the
generated successors, and the tallies (rows reduced, proviso
re-expansions, candidates masked) ride the stats read.  Growths and
resumes arm the boost.  Off, or falling back (``_base.py``), the step
issues none of these operations.

**Checked mode** (``.checked()``, JAX wavefront.py:426-458, :690-710):
the twin's ``property_masks`` and ``step_rows`` run under the guard of
``analysis/sanitizer.py`` on rows whose dead lanes hold the first init
row; the flag is ORed into the carry's error word, ``go`` takes ``&
~err``, so the block stops at a failure, and the word rides the block's
stats read.  The host loop then replays the failing window one
row at a time and raises ``CheckedExecutionError``.

**The spill tier** (``.spill()``, ``spill/``, JAX wavefront.py:498-511,
:575-607, :652-678, :904-965, :1211-1685): at a growth whose next table
rung does not fit the device budget (``telemetry/memory.device_budget``,
this engine's own analytic buffers and growth transient), the host
evicts the hot table to the spill store and folds its fingerprints into
a Bloom filter the step reads; the step hashes its candidates once more
(``row_hash``, sharing the pre-dedup's launch), defers the lanes the
filter may hold to a pending buffer (``_Engine._defer``), and stops the
block (``spill_sync``) before the buffer can overflow; the table trigger
reads hot occupancy.  At the next sync the host resolves the pending
lanes against the store and inserts the novel ones through
:meth:`_Engine.inject` (the key sort, ``bucket_plan_fused``,
``insert_commit``); a queue doubling the budget blocks moves the queue's
tail to a host FIFO, refilled as the queue drains.  Snapshots carry every
tier.

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

**Fault seams** (``testing/faults.py``; JAX wavefront.py:2251, :2306): the
host loop fires ``host_sync`` at every sync, before the checkpoint seam,
and ``growth`` first at every growth boundary.  Both are host-side checks
that read nothing from the device.

**Prewarm and compile attribution** (``.prewarm()``, ``.compile_cache()``,
``parallel/prewarm.py``; JAX wavefront.py:1687-1846, :2046-2075): each
engine acquisition (:meth:`GpuChecker._engine_for`) records one
``compile`` event (``rung`` ``init`` or ``growth``, ``source`` ``fresh``,
``prewarm`` or ``persistent``, ``duration``: the seconds the run thread
waited) and the ``compile`` stage.  The block that first launches a
kernel pays the kernel library's build or load and amends the event with
it.  Under ``.prewarm()`` the host loop schedules, once a growth trigger
is near or within the next block's reach, the growth ladder's next rungs
(the table, queue and budget doublings) on the ``stateright-prewarm``
thread, which builds each exactly as a cold build would, on the run
thread's stream; a growth boundary then takes the built engine.  The
step is the same either way.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import convert
from ..convert import (
    DISC, HEAD, MAXDEPTH, QDEPTH, QEBITS, QFP, QROWS, SCOUNT, STATUS, TAIL,
    TFP, TPL, UNIQUE,
)
from ..core import Expectation
from ..ops import _cuda
from ..ops.block_loop import (
    CUPTI_FAULT, BlockGraph, CondInputs, block_cond_plain, block_go,
)
from ..ops.buckets import (
    SLOTS, PlanBuffers, bucket_insert, bucket_plan_fused,
    host_bucket_rehash, lane_compact, sort_keys, window_unique,
)
from ..ops.cand_prep import PrepBuffers, cand_prep
from ..ops.cartography import (
    DEPTH_BINS, action_hist_delta, cart_carry_shapes, prop_tally_delta,
    queue_depth_hist, queue_depth_hist_exact, queue_depth_hist_np, snapshot,
)
from ..ops.hashing import EMPTY, EMPTY_U64, row_hash
from ..ops.insert_commit import QueueAppend, insert_commit
from ..spill.bloom import bloom_test
from ..telemetry.spans import span as tel_span
from ..testing import faults
from ._base import WavefrontChecker
from .prewarm import CompileWatch, build_site

_STATUS_OK = 0
_STATUS_QUEUE_FULL = 1
_STATUS_TABLE_FULL = 2
_STATUS_CAND_FULL = 3  # valid candidates exceeded the compaction budget
_STATUS_POISON = 4  # a compiled-twin transition crossed its compile bound
_STATUS_SPILL_SYNC = 5  # spill tier: the pending buffer is near full, the
#                         host must resolve it against the host index

# growth-record names for the flight recorder (telemetry.STATUS_NAMES)
_STATUS_TELEMETRY_NAMES = {
    _STATUS_OK: "ok",
    _STATUS_QUEUE_FULL: "queue_full",
    _STATUS_TABLE_FULL: "table_full",
    _STATUS_CAND_FULL: "cand_full",
    _STATUS_POISON: "poison",
    _STATUS_SPILL_SYNC: "spill_sync",
}

# Packed stats layout: [head, tail, unique, scount, maxdepth, status, disc...]
# then, each only when its flag is on, the checked error word, the POR
# tallies [rows_reduced, rows_full_proviso, candidates_masked], the spill
# section [pend_count, spill_base, deferred, on_device] and the
# cartography section [depth_hist, action_hist, prop_evals, prop_hits]
_ST_STATUS = 5
_ST_DISC = 6
_STATS_CARRY_ORDER = (HEAD, TAIL, UNIQUE, SCOUNT, MAXDEPTH, STATUS)
_SPILL_STATS_SECTION = 4
# the carry's 13 snapshot buffers; the optional tail follows them
BASE = len(convert.SNAPSHOT_KEYS)
# the spill tail (JAX wavefront.py:119-131), offsets from its start: the
# Bloom words over the spilled fingerprints, the spill base (unique states
# off the device), the pending buffers of Bloom-positive candidates
# deferred to the host, the pending count and the deferred/on-device tally
_SPILL_LEN = 9
(_SP_BLOOM, _SP_BASE, _SP_PFP, _SP_PROWS, _SP_PPAR, _SP_PEBT, _SP_PDEP,
 _SP_PCOUNT, _SP_STATS) = range(_SPILL_LEN)


class CarryLayout(NamedTuple):
    """Which optional parts ride the carry after its :data:`BASE`
    snapshot buffers, in the JAX order (wavefront.py:300-306): the checked
    error word, the POR pair (the boost word, int32, and the stats triple,
    int64[3]), the spill tail, the cartography counters."""

    checked: bool = False
    spill: bool = False
    cart: bool = False
    por: bool = False

    @property
    def err(self) -> int:
        return BASE

    @property
    def por_start(self) -> int:
        return BASE + int(self.checked)

    @property
    def spill_start(self) -> int:
        return self.por_start + (2 if self.por else 0)

    @property
    def cart_start(self) -> int:
        return self.spill_start + (_SPILL_LEN if self.spill else 0)


def resolve_device(device) -> torch.device:
    """A run's device: ``None`` means ``cuda`` (the current CUDA device)
    and raises when there is none; the port never falls back to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "spawn_gpu(): no CUDA device is available (the port "
                "never falls back to the CPU; pass device='cpu' to run "
                "the plain PyTorch path)"
            )
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


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
                   sym: bool = False, cuda: bool = True, checked: bool = False,
                   spill: Optional[tuple] = None, por: bool = False):
    """``caps -> [BufferSpec]``: the memory ledger's analytic buffers of a
    run of ``tensor`` at the capacities ``caps`` (``telemetry/memory.
    wavefront_specs``); ``spill`` is the tier's ``(bloom_bits,
    pend_cap)`` when it is armed, ``por`` whether reduction is on."""
    from ..telemetry.memory import wavefront_specs

    width, arity = tensor.width, tensor.max_actions

    def spec_fn(caps):
        return wavefront_specs(
            width, arity, n_props, int(caps["cap"]), int(caps["qcap"]),
            int(caps["batch"]), int(caps["cand"]), cartography=cartography,
            sym=sym, cuda=cuda, checked=checked, spill=spill, por=por,
        )

    return spec_fn


def _i32(x: int) -> int:
    """The int32 whose bits are the low 32 bits of ``x`` (queue ebits)."""
    x &= 0xFFFFFFFF
    return x - (1 << 32) if x >= 1 << 31 else x


def stats_of(carry: list, layout: CarryLayout,
             exact: bool = False) -> torch.Tensor:
    """Every scalar the host loop reads, packed into one int64 tensor, so
    a host sync is a single device-to-host copy.  ``layout`` says which
    optional sections the carry holds: the checked error word, the spill
    section (JAX ``stats_of``'s, wavefront.py:726-734) and the
    queue-derived depth histogram with the cartography counters;
    ``exact`` takes the exact histogram the JAX engine's host-side stats
    give after a growth or a resume (``ops/cartography.py``)."""
    parts = [torch.stack([carry[i] for i in _STATS_CARRY_ORDER]), carry[DISC]]
    if layout.checked:
        parts.append(carry[layout.err].to(torch.int64).reshape(1))
    if layout.por:
        parts.append(carry[layout.por_start + 1])
    if layout.spill:
        sp = layout.spill_start
        parts.append(torch.stack([carry[sp + _SP_PCOUNT], carry[sp + _SP_BASE]]))
        parts.append(carry[sp + _SP_STATS])
    if layout.cart:
        hist = queue_depth_hist_exact if exact else queue_depth_hist
        parts.append(hist(carry[QDEPTH], carry[TAIL]))
        parts += carry[layout.cart_start:]
    return torch.cat(parts)


def zero_counters(arity: int, n_props: int, device) -> list:
    """Fresh cartography counters: a new run's, or a resumed one's (the
    counters restart at zero, JAX wavefront.py:2129-2139)."""
    return [torch.zeros(s, dtype=torch.int64, device=device)
            for s in cart_carry_shapes(arity, n_props)]


def qalloc_of(qcap: int, m: int, spill: Optional[tuple] = None,
              por: bool = False) -> int:
    """The queue's rows for a high-water mark ``qcap`` and ``m`` candidate
    lanes a step (JAX wavefront.py:266-277): one window of ``m`` rows past
    the mark, two under POR (the proviso round appends after the ample
    round), or the spill inject's ``pend_cap`` rows when wider."""
    if por:
        return qcap + 2 * m
    return qcap + (max(spill[1], m) if spill else m)


def stats_host(carry_np: list, mid: np.ndarray,
               counters: np.ndarray) -> np.ndarray:
    """:func:`stats_of` of a numpy carry (the JAX engine's ``_stats_np``):
    the sync that follows a growth reads the carry the host just grew, not
    the device.  ``mid`` is the section between the discoveries and the
    cartography section (the checked error word; a spill run re-reads the
    device instead), ``counters`` the cartography counter section (empty
    when the counters are off)."""
    vals = [int(np.asarray(carry_np[i])) for i in _STATS_CARRY_ORDER]
    parts = [np.asarray(vals, np.int64),
             np.asarray(carry_np[DISC]).view(np.int64).reshape(-1)]
    parts.append(np.asarray(mid, np.int64))
    if counters.size:
        parts.append(queue_depth_hist_np(carry_np[QDEPTH],
                                         int(carry_np[TAIL])))
        parts.append(counters)
    return np.concatenate(parts)


class _Engine:
    """The device program for fixed capacities: :meth:`init` builds the
    initial carry, :meth:`run` advances it by up to ``steps`` steps, and
    under ``.spill()`` :meth:`inject` inserts a host-verified batch."""

    # on CUDA a block is one launch of the block graph
    graph_block = True

    def __init__(self, tensor, props, cap: int, qcap: int, batch: int,
                 steps: int, target: Optional[int], cand: Optional[int],
                 device, sym: bool = False, prededup: bool = False,
                 removed: Optional[torch.Tensor] = None,
                 cartography: bool = False, checked: bool = False,
                 spill: Optional[tuple] = None, por=None):
        self.tensor, self.props = tensor, props
        self.cap, self.qcap, self.batch, self.steps = cap, qcap, batch, steps
        self.target, self.device, self.sym = target, device, sym
        self.cart, self.checked, self.spill = cartography, checked, spill
        self.por = por is not None
        self.layout = CarryLayout(checked, spill is not None, cartography,
                                  self.por)
        self.key = (cap, qcap, batch, cand, sym, cartography, checked, spill,
                    self.por)
        self.width, self.arity = tensor.width, tensor.max_actions
        self.m = batch * self.arity
        self.eff_cand = min(cand, self.m) if cand else self.m
        self.qalloc = qalloc_of(qcap, self.m, spill, self.por)
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
        if checked:
            from ..analysis.sanitizer import checked_kernels

            # the guarded model kernels, and the known-good row that stands
            # in for the dead lanes (JAX wavefront.py:436-446)
            self.kernels = checked_kernels(tensor)
            init_np = np.asarray(tensor.init_rows(), np.uint64)[0]
            self.init_row = torch.from_numpy(
                init_np.view(np.int64).copy()).to(device)
        if spill:
            self.spill_bits, self.pend_cap = spill
            self.palloc = self.pend_cap + self.m
            # a step's pending window, added to the pending cursor
            self.pend_lanes = torch.arange(self.m, device=device)
        if self.por:
            from ..analysis.footprint import conjunct_eval_fn
            from ..ops.por import PorConstants

            # the plan's tensors and the guard-conjunct kernel (JAX
            # wavefront.py:316-320); the proviso round's lane positions
            self.por_consts = PorConstants(por, device)
            self.conj_kernel = conjunct_eval_fn(tensor)
            if self.conj_kernel is not None:
                # the capture at this batch, outside any step
                self.conj_kernel.build(batch, device)
            self.cand_lanes = torch.arange(self.eff_cand, device=device)
        # the insert's own buffers (validated here, so the step launches
        # unchecked) and the stream its kernels go to; under POR a second
        # pair for the proviso round, whose launches must leave the ample
        # round's tgt, sel and n_new as they were; under spill the
        # inject's plan buffers
        self.prep_out = self.plan_out = self.stream = self.inject_out = None
        self.prep_out2 = self.plan_out2 = None
        if self.device.type == "cuda":
            self.prep_out = PrepBuffers(self.m, self.eff_cand, self.device)
            self.plan_out = PlanBuffers(self.eff_cand, self.device, sym)
            self.stream = _cuda.stream_of(self.plan_out.tgt)
            if self.por:
                self.prep_out2 = PrepBuffers(self.m, self.eff_cand,
                                             self.device)
                self.plan_out2 = PlanBuffers(self.eff_cand, self.device, sym)
            if spill:
                self.inject_out = PlanBuffers(self.pend_cap, self.device, sym)
        # on CUDA, the block graph (``ops/block_loop.py``), captured at the
        # first run
        self.block: Optional[BlockGraph] = None

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

    def cond_inputs(self, c: list) -> CondInputs:
        """What the block's ``cond`` reads of the carry ``c``."""
        return CondInputs(c[HEAD], c[TAIL], c[UNIQUE], c[STATUS],
                          c[DISC] if self.props else None,
                          c[self.layout.err] if self.checked else None,
                          self.target)

    def go_of(self, c: list) -> torch.Tensor:
        """Whether a step of ``c`` does work (0-d bool): JAX's ``cond``
        (wavefront.py:701-710) without its ``k < steps`` term.  A failed
        check stops the block (the host raises from it).  A step whose
        ``go`` is false leaves every carry entry as it was."""
        return block_go(self.cond_inputs(c))

    def step(self, c: list) -> list:
        """Pop one batch, expand, dedup+insert, append novel rows."""
        batch, m, width = self.batch, self.m, self.width
        head, tail, unique = c[HEAD], c[TAIL], c[UNIQUE]
        disc = c[DISC]
        go = self.go_of(c)
        n_avail = torch.where(go, tail - head, 0)
        pos = (head + self.lanes).clamp_(max=self.qalloc - 1)
        rows, fps, ebits, depths = self._pop(c, pos)
        live = self.lanes < n_avail

        if self.checked:
            # both model kernels under the guard, the flag sticky in the
            # carry; dead lanes hold queue padding the guard would check,
            # so the first init row stands in for them (their outputs are
            # discarded by the live mask below)
            safe = torch.where(live[:, None], rows, self.init_row)
            err, (masks, succ, valid) = self.kernels(safe, c[self.layout.err])
            c[self.layout.err] = err
        else:
            masks = self.tensor.property_masks(rows)  # [B, P] bool
        ebits, disc = self.eval_props(masks, fps, live, ebits, disc)
        maxdepth = torch.maximum(
            c[MAXDEPTH], torch.where(live, depths, 0).max().to(torch.int64)
        )
        # mid-run early exit: stop expanding once every property has a
        # discovery (reference ``bfs.rs:121-128``)
        elive = live & ~self.all_discovered(disc)
        if not self.checked:
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
        if self.por:
            return self._step_por(c, go, rows, valid, live, masks, krows,
                                  cand_rows, fps, ebits, depths, n_avail,
                                  disc, maxdepth)
        cvalid = kept = valid.reshape(m)
        if self.prededup or self.spill:
            # the successors' fingerprints before the budget compaction
            # (one launch serves both flags)
            fph = row_hash(krows, cvalid)
            if self.prededup:  # only each fingerprint's first lane goes on
                fph = window_unique(fph)
            kept = fph != EMPTY
            if self.spill:
                # Bloom pre-filter (JAX wavefront.py:498-511): a candidate
                # that may be spilled leaves the device insert for the
                # pending buffer; before the first eviction the filter is
                # all-zero and nothing defers
                maybe = kept & bloom_test(c[self.layout.spill_start
                                            + _SP_BLOOM], fph,
                                          self.spill_bits)
                kept = kept & ~maybe
        _, _, n_new, n_valid, toverflow, coverflow = self._insert_round(
            c, krows, kept, fps, tail, cand_rows, ebits, depths,
            self.prep_out, self.plan_out)
        # the state count adds every generated state, repeats and deferred
        # candidates included
        n_gen = cvalid.sum() if (self.prededup or self.spill) else n_valid

        # any overflow means the batch wrote nothing durable: cursors and
        # counters stay so it replays after the host grows
        overflow = toverflow | coverflow
        head = torch.where(overflow, head, head + torch.clamp(n_avail, max=batch))
        tail = tail + n_new
        unique = unique + n_new
        scount = torch.where(overflow, c[SCOUNT], c[SCOUNT] + n_gen)
        if self.spill:
            n_def = self._defer(c, maybe, fph, cand_rows, fps, ebits, depths,
                                cvalid, overflow)
        if self.prededup:
            removed = n_gen - n_valid
            if self.spill:  # the deferred lanes were not taken out
                removed = removed - n_def
            self.removed.add_(torch.where(overflow, 0, removed))
        return self._finish_step(c, go, rows, live, masks, valid, overflow,
                                 toverflow, coverflow, head, tail, unique,
                                 scount, disc, maxdepth)

    def _pop(self, c, pos):
        """The popped window's rows, fingerprints, ebits and depths: the
        queue rows at ``pos`` (the mesh engine reads them from the queue's
        pieces)."""
        return c[QROWS][pos], c[QFP][pos], c[QEBITS][pos], c[QDEPTH][pos]

    def _finish_step(self, c, go, rows, live, masks, gen_mask, overflow,
                     toverflow, coverflow, head, tail, unique, scount, disc,
                     maxdepth) -> list:
        """The step's counters and status: cartography's tallies of the
        generated successors ``gen_mask``, the growth triggers, the spill
        stop and the poison status, then the cursors into the carry."""
        m, status = self.m, c[STATUS]
        if self.cart:
            # the state count's replay rule: an overflowed batch counts
            # nothing (the depth histogram reads the queue, which an
            # overflowed insert did not append to)
            d_evals, d_hits = prop_tally_delta(live, masks, len(self.props))
            cs = self.layout.cart_start
            for i, d in enumerate((action_hist_delta(gen_mask), d_evals,
                                   d_hits)):
                c[cs + i] = c[cs + i] + torch.where(overflow, 0, d)
        # clean-boundary growth triggers (table target load <= 25%); under
        # spill the trigger reads HOT occupancy (JAX wavefront.py:652-660)
        hot = (unique - c[self.layout.spill_start + _SP_BASE] if self.spill
               else unique)
        new_status = torch.where(
            toverflow | (hot * 4 > self.cap) | (self.eff_cand * 4 > self.cap),
            _STATUS_TABLE_FULL,
            torch.where(
                coverflow, _STATUS_CAND_FULL,
                torch.where(tail > self.qcap, _STATUS_QUEUE_FULL, status),
            ),
        )
        if self.spill:
            # the pending buffer cannot take another window: stop at this
            # clean boundary so the host resolves it; a growth status wins
            pcount = c[self.layout.spill_start + _SP_PCOUNT]
            new_status = torch.where(
                (new_status == _STATUS_OK) & (pcount + m > self.pend_cap),
                _STATUS_SPILL_SYNC, new_status)
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

    def _insert_round(self, c, krows, kept, fps, tail, cand_rows, ebits,
                      depths, prep_out, plan_out):
        """One insert of the candidate lanes ``kept``: ``cand_prep``, the
        key sort, ``bucket_plan_fused``, and ``insert_commit`` with the
        queue append at ``tail``.  The engine built every input itself, so the
        kernels run unchecked.  Returns ``(tgt, sel, n_new, n_kept,
        toverflow, coverflow)``, ``n_kept`` the count of ``kept``."""
        pfp, ppl, cidx, key, n_kept, coverflow = cand_prep(
            krows, kept, fps, self.arity, self.eff_cand, prep_out,
            check=False, stream=self.stream,
        )
        skey, order = torch.sort(key, stable=True)
        tgt, cfp, cpl, sel, n_new, toverflow = bucket_plan_fused(
            c[TFP], pfp, ppl, skey, order, cidx, coverflow,
            self.cap // SLOTS, plan_out, generation_order=self.sym,
            check=False, stream=self.stream,
        )
        insert_commit(
            c[TFP], c[TPL], tgt, cfp, cpl, n_new,
            QueueAppend(c[QROWS], c[QFP], c[QEBITS], c[QDEPTH], tail, sel,
                        cand_rows, ebits, depths, self.arity),
            check=False, stream=self.stream,
        )
        return tgt, sel, n_new, n_kept, toverflow, coverflow

    def _rollback(self, c, overflow, tgt, n_new) -> None:
        """Undo one insert round's table writes when the step overflowed
        (JAX keeps the pre-step table and selects it, wavefront.py:519-520,
        :608-611; here the rounds wrote in place): the slots of the round's
        first ``n_new`` lanes get ``EMPTY`` and the empty payload 0 back,
        by an add, so the stale lanes past ``n_new`` (in-range, possibly
        repeating a live slot) add 0.  No host read, no table copy."""
        undo = overflow & (self.cand_lanes < n_new)
        idx = torch.where(undo, tgt, 0)
        fp = c[TFP].index_select(0, idx)
        pl = c[TPL].index_select(0, idx)
        c[TFP].index_add_(0, idx, torch.where(undo, EMPTY - fp, 0))
        c[TPL].index_add_(0, idx, torch.where(undo, -pl, 0))

    def _step_por(self, c, go, rows, valid, live, masks, krows, cand_rows,
                  fps, ebits, depths, n_avail, disc, maxdepth) -> list:
        """The insert of a step under POR (JAX wavefront.py:474-495,
        :519-545, :608-630): the ample round inserts the ample successors
        (every enabled one while the boost word is armed); a row whose
        ample successors were all duplicates is reduced and gets its
        other successors inserted in a proviso round, appended after the
        first round's rows.  An overflow in either round undoes both, so
        the replay after growth sees the same novelty verdicts."""
        from ..ops.por import ample_mask, candidate_novelty

        batch, arity, m = self.batch, self.arity, self.m
        ps = self.layout.por_start
        boost, pstats = c[ps], c[ps + 1]
        head, tail, unique = c[HEAD], c[TAIL], c[UNIQUE]
        amp = ample_mask(valid, rows, self.por_consts, self.conj_kernel)
        amp = torch.where(boost > 0, valid, amp)
        if self.prededup:
            # one hash of every valid successor serves both rounds' windows
            fph = row_hash(krows, valid.reshape(m))

            def kept_of(mask):
                return window_unique(torch.where(mask.reshape(m), fph,
                                                 EMPTY)) != EMPTY
        else:
            def kept_of(mask):
                return mask.reshape(m)
        tgt1, sel1, n_new1, kept1, tovf1, covf1 = self._insert_round(
            c, krows, kept_of(amp), fps, tail, cand_rows, ebits, depths,
            self.prep_out, self.plan_out)
        # the conservative cycle proviso: a reduced row none of whose ample
        # successors was novel expands its other successors too
        novel = candidate_novelty(m, sel1, n_new1)
        reduced_row = (valid & ~amp).any(dim=1)
        fresh_row = novel.reshape(batch, arity).any(dim=1)
        need_full = reduced_row & ~fresh_row
        v2 = valid & ~amp & need_full[:, None]
        tgt2, _, n_new2, kept2, tovf2, covf2 = self._insert_round(
            c, krows, kept_of(v2), fps, tail + n_new1, cand_rows, ebits,
            depths, self.prep_out2, self.plan_out2)
        toverflow = tovf1 | tovf2
        coverflow = covf1 | covf2
        overflow = toverflow | coverflow
        self._rollback(c, overflow, tgt1, n_new1)
        self._rollback(c, overflow, tgt2, n_new2)
        n_new = torch.where(overflow, 0, n_new1 + n_new2)
        head = torch.where(overflow, head, head + torch.clamp(n_avail, max=batch))
        tail = tail + n_new
        unique = unique + n_new
        gen_mask = amp | v2
        n_gen = gen_mask.sum()
        scount = torch.where(overflow, c[SCOUNT], c[SCOUNT] + n_gen)
        d_por = torch.stack([(reduced_row & ~need_full).sum(),
                             need_full.sum(), valid.sum() - n_gen])
        c[ps + 1] = pstats + torch.where(overflow, 0, d_por)
        # a committed batch consumes the boundary boost; a replayed
        # (overflowed) one, or a step after the stop, keeps it armed
        c[ps] = torch.where(go & ~overflow, 0, boost)
        if self.prededup:
            self.removed.add_(torch.where(overflow, 0,
                                          n_gen - kept1 - kept2))
        return self._finish_step(c, go, rows, live, masks, gen_mask, overflow,
                                 toverflow, coverflow, head, tail, unique,
                                 scount, disc, maxdepth)

    def _defer(self, c, maybe, fph, cand_rows, fps, ebits, depths, cvalid,
               overflow):
        """Append the deferred lanes, compacted in lane order, at the
        pending cursor (JAX wavefront.py:575-607), and count the spill
        tallies.  The writes run even on an overflowed batch; the cursor
        and the tallies then stay, so the replay overwrites the same
        window.  Only the deferred lanes are written: the window's other
        lanes get back what they held, so a step that defers nothing (one
        whose ``go`` is false among them) leaves the buffers as they were.
        Returns the 0-d count of deferred lanes."""
        sp = self.layout.spill_start
        pcount = c[sp + _SP_PCOUNT]
        didx, dlive, n_def = lane_compact(maybe, self.m)
        n_def = n_def.to(torch.int64)
        parent = torch.div(didx, self.arity, rounding_mode="floor")
        dst = pcount + self.pend_lanes
        for j, src in ((_SP_PFP, fph.index_select(0, didx)),
                       (_SP_PROWS, cand_rows.index_select(0, didx)),
                       (_SP_PPAR, fps.index_select(0, parent)),
                       (_SP_PEBT, ebits.index_select(0, parent)),
                       (_SP_PDEP, depths.index_select(0, parent) + 1)):
            buf = c[sp + j]
            live = dlive[:, None] if src.dim() == 2 else dlive
            buf.index_copy_(0, dst, torch.where(live, src,
                                                buf.index_select(0, dst)))
        c[sp + _SP_PCOUNT] = pcount + torch.where(overflow, 0, n_def)
        d_sp = torch.stack([n_def, cvalid.sum() - n_def])
        c[sp + _SP_STATS] = c[sp + _SP_STATS] + torch.where(overflow, 0, d_sp)
        return n_def

    # -- programs ------------------------------------------------------------

    def run(self, carry: list):
        """One block of up to ``steps`` steps; returns ``(carry, stats)``,
        ``stats`` the packed stats (:meth:`_stats`) followed by ``k``, the
        steps the block executed.  On CUDA the block is one launch of the
        block graph (``ops/block_loop.py``), captured at the first run; on
        the CPU it is the eager loop :meth:`_run_steps`."""
        if not self.uses_graph:
            return self._run_steps(carry)
        if self.block is None:
            # the capture is this engine's build, charged to the compile
            # stage and its event
            with build_site():
                self.block = BlockGraph(self, carry)
        carry, k = self.block.run(carry)
        return carry, torch.cat([self._stats(carry), k])

    @property
    def uses_graph(self) -> bool:
        """Whether a block is a launch of the block graph (on CUDA)."""
        return self.device.type == "cuda" and self.graph_block

    def _run_steps(self, carry: list):
        """The block's plain version: ``steps`` steps issued from Python,
        each after the stop a no-op, with JAX's ``cond`` evaluated before
        each (:func:`~..ops.block_loop.block_cond_plain`) to count the
        steps that did work.  Returns what :meth:`run` returns."""
        carry = list(carry)
        k = torch.zeros(1, dtype=torch.int64, device=self.device)
        for _ in range(self.steps):
            _, k = block_cond_plain(self.cond_inputs(carry), k, self.steps)
            carry = self.step(carry)
        return carry, torch.cat([self._stats(carry), k])

    def warm(self, c: list) -> None:
        """One eager step on ``c`` with its status replaced by a stopped
        one: ``go`` is false, so the step changes no carry entry, and it
        builds every per-device cache the step builds at its first call
        (the compiled twins' tables, the POR gather index), before the
        block graph's capture."""
        w = list(c)
        w[STATUS] = torch.full_like(c[STATUS], _STATUS_QUEUE_FULL)
        self.step(w)

    def account(self, k: int) -> None:
        """Count the launches of a graph block that executed ``k`` steps
        (the eager loop's wrappers counted their own)."""
        if self.block is not None:
            self.block.account(k)

    def _stats(self, carry: list) -> torch.Tensor:
        """The block's packed stats (:func:`stats_of`)."""
        return stats_of(carry, self.layout)

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
        if self.checked:
            carry.append(torch.zeros((), dtype=torch.bool, device=dev))
        if self.por:
            # boost 0: the init batch is not a growth or resume boundary
            carry += por_tail(0, dev)
        if self.spill:
            # an all-zero filter (nothing spilled, nothing defers), empty
            # pending buffers, spill base 0
            carry += spill_tail(self.spill_bits, self.palloc, self.width,
                                dev)
        if self.cart:
            carry += zero_counters(self.arity, len(self.props), dev)
        return carry, stats_of(carry, self.layout)

    def inject(self, carry: list, ifp, irows, ipar, iebt, ipdep) -> tuple:
        """Insert one host-verified batch of ``pend_cap`` lanes into the
        hot table and the queue, in place (JAX ``_build_inject``,
        wavefront.py:904-965): fingerprints ``ifp`` as given (EMPTY on dead
        lanes; never rehashed, since under symmetry a fingerprint is the
        canonical row's), rows ``irows``, parents ``ipar``, ebits
        ``iebt`` and parent depths ``ipdep``.  The insert is the step's:
        the stable key sort, ``bucket_plan_fused`` (generation order under
        symmetry) and ``insert_commit`` with the queue append, so a Bloom
        false positive that is hot-resident drops out as a duplicate.  It
        bumps ``unique`` and ``tail``, clears ``spill_sync`` and the
        pending count, and sets the growth statuses the step would; on a
        table overflow nothing is written.  Returns ``(carry, io)``,
        ``io`` the 0-d count inserted and the overflow flag, packed."""
        c = list(carry)
        sp = self.layout.spill_start
        tail = c[TAIL]
        skey, order = sort_keys(ifp)
        no_cov = torch.zeros((), dtype=torch.bool, device=ifp.device)
        tgt, cfp, cpl, sel, n_new, tovf = bucket_plan_fused(
            c[TFP], ifp, ipar, skey, order, None, no_cov,
            self.cap // SLOTS, self.inject_out, generation_order=self.sym,
            stream=self.stream,
        )
        insert_commit(
            c[TFP], c[TPL], tgt, cfp, cpl, n_new,
            QueueAppend(c[QROWS], c[QFP], c[QEBITS], c[QDEPTH], tail, sel,
                        irows, iebt, ipdep, 1),
            stream=self.stream,
        )
        tail = tail + n_new
        unique = c[UNIQUE] + n_new
        status = c[STATUS]
        status = torch.where(status == _STATUS_SPILL_SYNC, _STATUS_OK, status)
        status = torch.where(
            tovf | ((unique - c[sp + _SP_BASE]) * 4 > self.cap),
            _STATUS_TABLE_FULL,
            torch.where(tail > self.qcap, _STATUS_QUEUE_FULL, status),
        )
        c[TAIL], c[UNIQUE], c[STATUS] = tail, unique, status
        c[sp + _SP_PCOUNT] = torch.zeros_like(c[sp + _SP_PCOUNT])
        return c, torch.stack([n_new, tovf.to(torch.int64)])


def por_tail(boost: int, device) -> list:
    """The POR pair of the carry (JAX wavefront.py:809-812, :2117-2122):
    the boost word (1 arms one fully expanded batch, as at a growth or a
    resume) and the zeroed tallies."""
    return [torch.tensor(boost, dtype=torch.int32, device=device),
            torch.zeros((3,), dtype=torch.int64, device=device)]


def spill_tail(bits: int, palloc: int, width: int, device,
               bloom: Optional[np.ndarray] = None, base: int = 0,
               pend: Optional[dict] = None) -> list:
    """The spill tail of the carry (JAX wavefront.py:813-826): the Bloom
    words (``bloom``, a ``uint32`` host mirror, or zeros), the spill base,
    the pending buffers of ``palloc`` lanes holding ``pend``'s entries
    (``spill_pend_*`` snapshot arrays, or none), the pending count and the
    zeroed tallies."""
    i64 = dict(dtype=torch.int64, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    words = convert.signed_tensor(
        np.zeros(bits // 32, np.uint32) if bloom is None else bloom, device)
    pfp = torch.full((palloc,), EMPTY, **i64)
    prows = torch.zeros((palloc, width), **i64)
    ppar = torch.zeros((palloc,), **i64)
    pebt = torch.zeros((palloc,), **i32)
    pdep = torch.zeros((palloc,), **i32)
    pn = 0
    if pend:
        pn = int(pend["fp"].shape[0])
        for t, k in ((pfp, "fp"), (prows, "rows"), (ppar, "parent"),
                     (pebt, "ebits"), (pdep, "depth")):
            t[:pn] = convert.signed_tensor(pend[k], device)
    return [words, torch.tensor(base, **i64), pfp, prows, ppar, pebt, pdep,
            torch.tensor(pn, **i64), torch.zeros((2,), **i64)]


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
    ``spill_bloom_bits``, ``spill_dir``, ``spill_host_bytes`` — the spill
    tier's Bloom width (default ``STATERIGHT_TPU_SPILL_BLOOM_BITS``, else
    2^23), disk-tier directory and host-tier budget (default
    ``STATERIGHT_TPU_HOST_BYTES``, else half the host's RAM), used under
    ``.spill()``.  ``sync=True`` runs the engine on the caller's thread
    and returns once it is done.
    """

    # the engine's name in telemetry, reports and the run registry (the
    # JAX engine's is "wavefront": a JAX-vs-port report pair is an engine
    # delta, whose contract is identical counts)
    _telemetry_tag = _report_engine = "gpu-wavefront"

    def __init__(self, options, capacity: int = DEFAULT_CAPACITY,
                 batch: int = DEFAULT_BATCH,
                 cand: Optional[int] = None, steps_per_call: int = 64,
                 device=None, resume: Optional[dict] = None,
                 queue_capacity: Optional[int] = None,
                 spill_bloom_bits: Optional[int] = None,
                 spill_dir: Optional[str] = None,
                 spill_host_bytes: Optional[int] = None,
                 sync: bool = False):
        self.device = resolve_device(device)
        caps = default_caps(capacity, batch, cand, queue_capacity)
        self._cap, self._qcap = caps["cap"], caps["qcap"]
        self._batch, self._cand = caps["batch"], caps["cand"]
        self._steps = steps_per_call
        self._resume = resume
        # the spill tier's knobs, read by _init_spill when .spill() is on
        self._spill_bloom_bits = spill_bloom_bits
        self._spill_dir = spill_dir
        self._spill_host_bytes = spill_host_bytes
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
        # blocks times steps_per_call (the JAX engine's trip budget), and
        # the steps the blocks executed (JAX's while_loop trips; on CUDA
        # the block graph runs no other)
        self.steps_run = 0
        self.steps_executed = 0
        # on CUDA, one entry per engine whose block graph was captured:
        # its capacities and :meth:`BlockGraph.record`
        self.block_graphs: list = []
        # under spill: inject calls, and the kernel launches they made
        self.inject_calls = 0
        self.inject_launches = {"bucket_plan_fused": 0, "insert_commit": 0}
        self._final_carry = None
        self._last_engine: Optional[_Engine] = None
        self._last_engine_key: Optional[tuple] = None
        # under prededup, the lanes it took out since this process started
        self._removed = torch.zeros((), dtype=torch.int64,
                                    device=self.device)
        self._init_common(options, sync)

    @property
    def _layout(self) -> CarryLayout:
        return CarryLayout(self._checked, self._spill, self._cartography,
                           self._por)

    def _engine(self, cap, qcap, batch, cand) -> _Engine:
        return _Engine(self.tensor, self._props, cap, qcap, batch,
                       self._steps, self._target, cand, self.device,
                       sym=self._symmetry is not None,
                       prededup=self._prededup, removed=self._removed,
                       cartography=self._cartography, checked=self._checked,
                       spill=self._spill_cfg if self._spill else None,
                       por=self._por_plan if self._por else None)

    def _pre_run_validate(self) -> None:
        if self._resume is not None:
            self._check_snapshot_sig(self._resume)

    def _qalloc(self, qcap: int, batch: int) -> int:
        """The queue's rows at these capacities, as the engine allocates
        them (JAX ``_qalloc``, wavefront.py:1939-1948)."""
        return qalloc_of(qcap, batch * self.tensor.max_actions,
                         self._spill_cfg if self._spill else None, self._por)

    # -- memory-ledger hooks (telemetry/memory.py) ---------------------------

    def _memory_spec_fn(self):
        return memory_spec_fn(
            self.tensor, len(self._props), cartography=self._cartography,
            sym=self._symmetry is not None, cuda=self.device.type == "cuda",
            checked=self._checked,
            spill=self._spill_cfg if self._spill else None, por=self._por,
        )

    def _roofline_cost_fn(self):
        """The cost model at THIS engine's spawn capacities
        (``analysis/costmodel.wavefront_costs``, cached on the twin): the
        roofline ledger's source (JAX wavefront.py:1131)."""
        from ..analysis.costmodel import wavefront_costs

        tensor, cap, qcap = self.tensor, self._cap, self._qcap
        batch, cand, sym = self._batch, self._cand, self._symmetry is not None

        def cost_fn():
            return wavefront_costs(tensor, cap, qcap, batch, cand, sym=sym)

        return cost_fn

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
        carry with its optional tail, and the last engine's own buffers
        (the lane index, the checked stand-in row, the pending window, the
        kernels' outputs and scratch).  What the ledger's analytic bytes
        are held against."""
        from ..telemetry.memory import (
            _CARRY_NAMES, _CART_NAMES, _POR_NAMES, _SPILL_NAMES,
        )

        self.join()
        c, lay = self._final_carry, self._layout
        out = dict(zip(_CARRY_NAMES, c[:BASE]))
        if lay.checked:
            out["checked_err"] = c[lay.err]
        if lay.por:
            out.update(zip(_POR_NAMES, c[lay.por_start:lay.spill_start]))
        if lay.spill:
            out.update(zip(_SPILL_NAMES, c[lay.spill_start:lay.cart_start]))
        out.update(zip(_CART_NAMES, c[lay.cart_start:]))
        eng = self._last_engine
        if eng is not None:
            out["lanes"] = eng.lanes
            if eng.checked:
                out["checked_init_row"] = eng.init_row
            if eng.spill:
                out["pend_lanes"] = eng.pend_lanes
            if eng.por:
                out["por_cand_lanes"] = eng.cand_lanes
            for pre, buf, names in (
                ("prep", eng.prep_out,
                 ("fp", "payload", "cidx", "key", "n_valid",
                  "cand_overflow", "scratch")),
                ("plan", eng.plan_out,
                 ("tgt", "cfp", "cpl", "sel", "n_new", "overflow",
                  "scratch", "stage")),
                ("inject", eng.inject_out,
                 ("tgt", "cfp", "cpl", "sel", "n_new", "overflow",
                  "scratch", "stage")),
                ("prep2", eng.prep_out2,
                 ("fp", "payload", "cidx", "key", "n_valid",
                  "cand_overflow", "scratch")),
                ("plan2", eng.plan_out2,
                 ("tgt", "cfp", "cpl", "sel", "n_new", "overflow",
                  "scratch", "stage")),
            ):
                for n in names if buf is not None else ():
                    t = getattr(buf, n)
                    if t is not None:
                        out[f"{pre}_{n}"] = t
        return out

    # -- cartography (ops/cartography.py) ------------------------------------

    def _bank_depth_lanes(self, qdepth, n: int, sign: int = 1) -> None:
        """Fold the depth lanes of ``qdepth[:n]`` (a queue prefix a growth
        reclaims, or rows the spill tier offloads) into the depth bank, or
        out of it with ``sign=-1`` (rows refilled; JAX wavefront.py:
        1167-1179), so ``sum(depth_hist) == unique`` survives both.  No-op
        with cartography off."""
        if not self._cartography or n <= 0:
            return
        if self._cart_depth_base is None:
            self._cart_depth_base = np.zeros(DEPTH_BINS, np.int64)
        self._cart_depth_base += sign * queue_depth_hist_np(qdepth, n)

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
            por=self._live_por if self._por else None,
        )
        self._live_cart = snap
        if self.flight_recorder is not None:
            self.flight_recorder.set_cartography(snap)

    # -- growth ---------------------------------------------------------------

    def _grow(self, carry_np: list, cap: int, qcap: int, batch: int,
              status: int, cand: int):
        """Grow whatever is (near) full; returns ``(cap, qcap, carry_np)``.
        Both conditions are re-checked whichever status fired.  Under
        spill the table trigger reads HOT occupancy (``unique`` less the
        spilled states) and a queue doubling the device budget blocks
        offloads the queue's tail to the host instead (JAX
        wavefront.py:1984-2035)."""
        spill_base = len(self._spill_store) if self._spill else 0

        def table_small():
            return ((int(carry_np[UNIQUE]) - spill_base) * 4 > cap
                    or cand * 4 > cap)

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
            if self._spill and not self._spill_fits_transient(
                    self._memory_caps(cap, qcap, batch, cand),
                    self._memory_caps(cap, qcap * 2, batch, cand)):
                pending = self._offload_queue_tail(carry_np, pending, qcap)
                break
            qcap *= 2
        carry_np[STATUS] = np.int32(_STATUS_OK)
        convert.repad_queue(carry_np, self._qalloc(qcap, batch))
        return cap, qcap, carry_np

    def _regrow(self, carry, cap, qcap, batch, status, cand, at=None,
                evict: bool = False):
        """:meth:`_grow` over a device carry (through the host); returns
        ``(cap, qcap, carry, carry_np)``, the grown carry on the device and
        as numpy.  ``at`` names a growth boundary the recorder samples:
        the carry's bytes both ways and the table's occupancy (free: the
        table is on the host here).  ``evict`` first sweeps the hot table
        into the spill tier (:meth:`_evict_hot_table`), in place of the
        table's growth.  The carry's tail past :data:`BASE` (the checked
        word, the spill tail, the cartography counters) is not part of the
        transform and stays as it is, but for the eviction's Bloom words
        and spill base."""
        rec = self.flight_recorder
        carry_np = convert.carry_to_arrays(carry[:BASE])
        tail = list(carry[BASE:])
        if rec is not None and at is not None:
            rec.add_bytes(d2h=sum(a.nbytes for a in carry_np if a.ndim))
            self._telemetry_occupancy(carry_np[TFP], at=at)
        if evict:
            tail = self._evict_hot_table(carry_np, tail)
            status = _STATUS_OK
        cap, qcap, carry_np = self._grow(carry_np, cap, qcap, batch, status,
                                         cand)
        if rec is not None and at is not None:
            rec.add_bytes(h2d=sum(a.nbytes for a in carry_np if a.ndim))
        grown = convert.carry_from_arrays(
            carry_np, self.device, self._qalloc(qcap, batch)
        )
        return cap, qcap, grown + tail, carry_np

    # -- the spill tier (spill/; JAX wavefront.py:1211-1685) -----------------

    def _init_spill(self) -> None:
        """Arm the host and disk tiers for this run (JAX wavefront.py:
        1213-1259): the Bloom width (``spill_bloom_bits``, else
        ``STATERIGHT_TPU_SPILL_BLOOM_BITS``, else 2^23, as a power of two
        in ``[2^10, 2^31]``), the pending capacity (four expansion windows,
        so several deferring steps run per host sync), the store and the
        Bloom words' host mirror.  The device half is the carry's spill
        tail, which the engine builds."""
        import os
        import sys

        from ..spill import SpillStore
        from ..spill.bloom import MAX_BLOOM_BITS, MIN_BLOOM_BITS

        bits = self._spill_bloom_bits
        if not bits:
            env = os.environ.get("STATERIGHT_TPU_SPILL_BLOOM_BITS",
                                 "").strip()
            if env and not env.isdigit():
                print("stateright-tpu-torch: spill: ignoring malformed "
                      f"STATERIGHT_TPU_SPILL_BLOOM_BITS={env!r} (want plain "
                      "bits, e.g. 8388608); using the default",
                      file=sys.stderr)
            bits = int(env) if env.isdigit() else (1 << 23)
        bits = min(max(_pow2(int(bits)), MIN_BLOOM_BITS), MAX_BLOOM_BITS)
        self._spill_cfg = (bits, 4 * self._batch * self.tensor.max_actions)
        self._spill_store = SpillStore(directory=self._spill_dir,
                                       host_budget=self._spill_host_bytes)
        self._spill_bloom_np = np.zeros(bits // 32, np.uint32)
        self._spill_qrows: list = []  # host FIFO of offloaded queue chunks
        self._spill_tally = {
            "evictions": 0, "resolved_dups": 0, "resolved_novel": 0,
            "queue_offloaded": 0, "queue_refilled": 0, "deferred": 0,
            "on_device": 0,
        }

    def _spill_snapshot(self) -> dict:
        """The live spill status (JSON-safe; JAX wavefront.py:1261-1298):
        tier bytes, Bloom load, deferral and resolution tallies."""
        from ..spill import SPILL_V
        from ..spill.bloom import BLOOM_K, bloom_est_false_pos

        bits, pend_cap = self._spill_cfg
        store, t = self._spill_store, self._spill_tally
        out = {
            "v": SPILL_V,
            "enabled": True,
            "evictions": t["evictions"],
            "spilled_fps": len(store),
            "host_bytes": store.host_bytes,
            "disk_bytes": store.disk_bytes,
            "index_bytes": store.index_bytes,
            "bloom_bits": bits,
            "bloom_k": BLOOM_K,
            "bloom_est_false_pos": round(
                bloom_est_false_pos(len(store), bits), 6),
            "pend_cap": pend_cap,
            "deferred": t["deferred"],
            "on_device": t["on_device"],
            "resolved_dups": t["resolved_dups"],
            "resolved_novel": t["resolved_novel"],
            "queue_offloaded": t["queue_offloaded"],
            "queue_refilled": t["queue_refilled"],
            "queue_host_rows": sum(int(c[1].shape[0])
                                   for c in self._spill_qrows),
        }
        if store.degraded:
            out.update(degraded=True, degraded_reason=store.degraded_reason)
        return out

    def _refresh_spill(self) -> None:
        rec = self.flight_recorder
        if rec is not None:
            rec.set_spill(self._spill_snapshot())
            if self._spill_store.degraded:
                # the disk tier is lost: the sticky health transition
                rec.set_spill_degraded()

    def spill_status(self) -> Optional[dict]:
        """The spill tier's status (evictions, bytes per tier, the Bloom
        width and estimated false-positive rate, the deferral and
        resolution tallies), or None without ``.spill()``."""
        return self._spill_snapshot() if self._spill else None

    def _spill_fits_transient(self, cur_caps: dict, new_caps: dict) -> bool:
        """Does the growth ``cur -> new`` fit the device budget
        (``telemetry/memory.device_budget``), with both rungs' buffers
        live together as the port's :meth:`_regrow` holds them?  No budget
        known, or no analytic model, means growth proceeds as ever."""
        from ..telemetry.memory import device_budget

        budget, _ = device_budget(self.device)
        if budget is None:
            return True
        cur = self._analytic_footprint_bytes(cur_caps)
        nxt = self._analytic_footprint_bytes(new_caps)
        if cur is None or nxt is None:
            return True
        return cur + nxt <= budget

    def _spill_should_evict(self, cap, qcap, batch, cand) -> bool:
        """Evict instead of growing iff the next table rung's growth
        transient exceeds the device budget."""
        return not self._spill_fits_transient(
            self._memory_caps(cap, qcap, batch, cand),
            self._memory_caps(cap * 2, qcap, batch, cand))

    def _evict_hot_table(self, carry_np: list, tail: list) -> list:
        """Sweep the hot table into the host tier at a growth boundary
        (JAX wavefront.py:1341-1380): every occupied ``(fp, parent)`` goes
        to the store and its bits to the Bloom mirror, the hot table is
        cleared in place, and the carry tail's Bloom words and spill base
        are refreshed.  Evicted fingerprints stay reachable through the
        Bloom, the pending buffer and the host index, and their parents
        merge back at trace reconstruction (:meth:`_parents`)."""
        from ..spill import SPILL_V
        from ..spill.bloom import bloom_est_false_pos, bloom_set_np

        tfp, tpl = carry_np[TFP], carry_np[TPL]
        occ = tfp != np.uint64(EMPTY_U64)
        fps, pars = tfp[occ], tpl[occ]
        self._spill_store.append(fps, pars)
        bloom_set_np(self._spill_bloom_np, fps)
        carry_np[TFP] = np.full(tfp.shape, EMPTY_U64, np.uint64)
        carry_np[TPL] = np.zeros(tpl.shape, np.uint64)
        sp = self._layout.spill_start - BASE
        tail = list(tail)
        tail[sp + _SP_BLOOM] = convert.signed_tensor(self._spill_bloom_np,
                                                     self.device)
        tail[sp + _SP_BASE] = torch.tensor(len(self._spill_store),
                                           dtype=torch.int64,
                                           device=self.device)
        self._spill_tally["evictions"] += 1
        rec = self.flight_recorder
        if rec is not None:
            bits = self._spill_cfg[0]
            rec.add("spill_evictions")
            rec.record(
                "spill", v=SPILL_V, event="evict", evicted=int(fps.size),
                spilled_fps=len(self._spill_store),
                host_bytes=self._spill_store.host_bytes,
                disk_bytes=self._spill_store.disk_bytes, bloom_bits=bits,
                bloom_est_false_pos=round(
                    bloom_est_false_pos(len(self._spill_store), bits), 6),
            )
            self._refresh_spill()
        return tail

    def _resolve_pending(self, carry, cap, qcap, batch, cand, pend: int):
        """Resolve the device pending buffer against the host index (JAX
        wavefront.py:1401-1506): fingerprints the store holds are
        duplicates (Bloom true positives) and drop out; the rest (false
        positives) are novel and re-enter the hot table and the queue
        through :meth:`_Engine.inject`.  A hot table too full to take them
        evicts or grows, re-filters against the store and retries, so
        nothing is lost.  Returns ``(cap, qcap, carry)``."""
        from ..spill import SPILL_V

        sp = self._layout.spill_start
        pend_cap = self._spill_cfg[1]
        arrs = convert.pend_to_snapshot(
            carry[sp + _SP_PFP:sp + _SP_PCOUNT], pend)
        pfp, prows, ppar, pebt, pdep = (
            arrs[f"spill_pend_{k}"] for k, _ in convert.PEND_KEYS)
        rec = self.flight_recorder
        if rec is not None:
            rec.add_bytes(d2h=sum(a.nbytes for a in arrs.values()))
        valid = pfp != EMPTY_U64
        pfp, prows = pfp[valid], prows[valid]
        ppar, pebt, pdep = ppar[valid], pebt[valid], pdep[valid]
        # intra-batch dedup, keep-FIRST occurrence: the earliest generation
        # wins the parent, ebits and depth, the lane the insert's stable
        # sort would keep
        _, first = np.unique(pfp, return_index=True)
        first.sort()
        seen = self._spill_store.contains(pfp[first])
        novel = first[~seen]
        nfp, nrows, npar, nebt, ndep = (a[novel] for a in
                                        (pfp, prows, ppar, pebt, pdep))
        k = int(nfp.size)
        dups = pend - k
        injected = 0
        carry = list(carry)
        if k == 0:
            # nothing to inject: clear the count and the stop
            carry[sp + _SP_PCOUNT] = torch.zeros_like(carry[sp + _SP_PCOUNT])
            carry[STATUS] = torch.where(carry[STATUS] == _STATUS_SPILL_SYNC,
                                        _STATUS_OK, carry[STATUS])
        while k:
            eng = self._engine_for(cap, qcap, batch, cand)
            lanes = (np.full(pend_cap, EMPTY_U64, np.uint64),
                     np.zeros((pend_cap, self.tensor.width), np.uint64),
                     np.zeros(pend_cap, np.uint64),
                     np.zeros(pend_cap, np.uint32),
                     np.zeros(pend_cap, np.uint32))
            # the queue append adds one to a parent depth
            for a, b in zip(lanes, (nfp, nrows, npar, nebt, ndep - 1)):
                a[:k] = b
            args = [convert.signed_tensor(a, self.device) for a in lanes]
            launches = (bucket_plan_fused.launches, insert_commit.launches)
            carry, io = eng.inject(carry, *args)
            io = io.cpu().numpy()
            self.inject_calls += 1
            self.inject_launches["bucket_plan_fused"] += (
                bucket_plan_fused.launches - launches[0])
            self.inject_launches["insert_commit"] += (
                insert_commit.launches - launches[1])
            if int(io[1]) == 0:
                # what entered the hot table: the inject's dedup drops the
                # hot-resident false positives, which count as duplicates
                injected = int(io[0])
                dups += k - injected
                break
            # the hot table cannot take the batch: evict or grow, then
            # re-filter against the store (an eviction moved hot-resident
            # false positives there) and retry
            cap, qcap, carry, _ = self._regrow(
                carry, cap, qcap, batch, _STATUS_TABLE_FULL, cand,
                evict=self._spill_should_evict(cap, qcap, batch, cand))
            seen2 = self._spill_store.contains(nfp)
            if seen2.any():
                keep = ~seen2
                dups += int(seen2.sum())
                nfp, nrows, npar, nebt, ndep = (
                    a[keep] for a in (nfp, nrows, npar, nebt, ndep))
                k = int(nfp.size)
        self._spill_tally["resolved_dups"] += dups
        self._spill_tally["resolved_novel"] += injected
        if rec is not None:
            rec.record("spill", v=SPILL_V, event="resolve", pending=pend,
                       dups=dups, novel=injected)
            self._refresh_spill()
        return cap, qcap, carry

    def _offload_queue_tail(self, carry_np: list, pending: int,
                            qcap: int) -> int:
        """The queue outgrew a doubling the budget blocks: move the rows
        furthest from being popped to the host FIFO, whence
        :meth:`_queue_refill` brings them back as the device queue drains
        (JAX wavefront.py:1525-1559).  Runs after the growth's prefix
        reclaim, so the live rows are ``[0, pending)``."""
        from ..spill import SPILL_V

        keep = max(qcap // 2, 1)
        if pending <= keep:
            return pending
        chunk = tuple(np.asarray(carry_np[i][keep:pending]).copy()
                      for i in convert.QUEUE)
        self._spill_qrows.append(chunk)
        # the offloaded rows leave qdepth[:tail], which the depth histogram
        # is computed from: bank their lanes (un-banked at refill)
        self._bank_depth_lanes(chunk[3], int(chunk[3].shape[0]))
        carry_np[TAIL] = np.int32(keep)
        moved = pending - keep
        self._spill_tally["queue_offloaded"] += moved
        rec = self.flight_recorder
        if rec is not None:
            rec.record("spill", v=SPILL_V, event="queue_offload", rows=moved,
                       host_rows=sum(int(c[1].shape[0])
                                     for c in self._spill_qrows))
            self._refresh_spill()
        return keep

    def _queue_refill(self, carry, qcap, batch) -> list:
        """The device queue drained while offloaded rows remain: reclaim
        the popped prefix and append up to the high-water mark's worth
        from the host FIFO (JAX wavefront.py:1561-1610)."""
        from ..spill import SPILL_V

        carry_np = convert.carry_to_arrays(carry[:BASE])
        head, tail = int(carry_np[HEAD]), int(carry_np[TAIL])
        self._bank_depth_lanes(carry_np[QDEPTH], head)
        for i in convert.QUEUE:
            carry_np[i] = carry_np[i][head:tail].copy()
        pending = tail - head
        room = qcap - pending
        taken = [[], [], [], []]
        moved = 0
        while self._spill_qrows and room > 0:
            chunk = self._spill_qrows[0]
            if int(chunk[1].shape[0]) <= room:
                take = self._spill_qrows.pop(0)
            else:
                take = tuple(a[:room] for a in chunk)
                self._spill_qrows[0] = tuple(a[room:] for a in chunk)
            for j in range(4):
                taken[j].append(take[j])
            cn = int(take[1].shape[0])
            # the refilled rows re-enter qdepth[:tail]: un-bank them
            self._bank_depth_lanes(take[3], cn, sign=-1)
            moved += cn
            room -= cn
        for j, i in enumerate(convert.QUEUE):
            carry_np[i] = np.concatenate([carry_np[i]] + taken[j])
        carry_np[HEAD] = np.int32(0)
        carry_np[TAIL] = np.int32(pending + moved)
        self._spill_tally["queue_refilled"] += moved
        rec = self.flight_recorder
        if rec is not None:
            rec.record("spill", v=SPILL_V, event="queue_refill", rows=moved,
                       host_rows=sum(int(c[1].shape[0])
                                     for c in self._spill_qrows))
            self._refresh_spill()
        return convert.carry_from_arrays(
            carry_np, self.device, self._qalloc(qcap, batch)) + carry[BASE:]

    def _restore_spill_host(self, snap: dict) -> None:
        """Restore the host half of the tier from a snapshot (JAX
        wavefront.py:1612-1640): the Bloom width, the store and its Bloom
        mirror, the offloaded-queue FIFO.  Runs before any boundary growth
        of the resume, which reads the store's length as the spill
        base."""
        from ..spill.bloom import MAX_BLOOM_BITS, bloom_set_np

        bits = self._spill_cfg[0]
        if "spill_bloom_bits" in snap:
            bits = min(_pow2(int(snap["spill_bloom_bits"])), MAX_BLOOM_BITS)
            if bits != self._spill_cfg[0]:
                self._spill_bloom_np = np.zeros(bits // 32, np.uint32)
        # the snapshot's batch governs the window, so the pending capacity
        self._spill_cfg = (bits, 4 * self._batch * self.tensor.max_actions)
        f = snap.get("spill_fp")
        if f is not None:
            f = np.asarray(f, np.uint64)
            self._spill_store.append(
                f, np.asarray(snap["spill_parent"], np.uint64))
            bloom_set_np(self._spill_bloom_np, f)
        if "spill_q_fp" in snap:
            self._spill_qrows.append(tuple(
                np.asarray(snap[k]) for k in (
                    "spill_q_rows", "spill_q_fp", "spill_q_ebits",
                    "spill_q_depth")))

    def _spill_resume_tail(self, snap: dict, batch: int) -> list:
        """The carry's spill tail at a resume (JAX wavefront.py:1642-1672):
        the Bloom words and the base from the restored store, the pending
        entries from the snapshot (a checkpoint at a growth boundary can
        hold deferred candidates)."""
        bits, pend_cap = self._spill_cfg
        return spill_tail(
            bits, pend_cap + batch * self.tensor.max_actions,
            self.tensor.width, self.device, bloom=self._spill_bloom_np,
            base=len(self._spill_store),
            pend=convert.pend_from_snapshot(snap, pend_cap))

    def _parents(self) -> dict:
        """Trace reconstruction merges every tier: the spilled parents
        first, then the hot table's (the sets are disjoint: an eviction
        removes what it spills)."""
        if self._parent_map is None:
            parents: dict = {}
            if self._spill and len(self._spill_store):
                for fps, pars in self._spill_store.iter_segments():
                    parents.update(zip(fps.tolist(), pars.tolist()))
            parents.update(self._parents_from_table(*self._table_np()))
            self._parent_map = parents
        return self._parent_map

    def _raise_on_checked_error(self, carry, head: int, tail: int,
                                batch: int) -> None:
        """Checked mode: the block's error word is set.  Replay the
        failing step's window one row at a time on the host's side of the
        guard (JAX wavefront.py:1848-1867) and raise
        :class:`~stateright_tpu_torch.analysis.CheckedExecutionError`.
        The window is ``[head - batch, head)`` after a normal pop, or
        ``[head, head + batch)`` when an overflow kept the cursor: their
        union, clipped at ``tail``."""
        from ..analysis.sanitizer import localize_checked_failure

        qrows = carry[QROWS].cpu().numpy().view(np.uint64)
        lo = max(0, head - batch)
        hi = min(qrows.shape[0], max(head, tail), head + batch)
        localize_checked_failure(self.tensor, qrows[lo:hi], self.device)

    def _peaks(self) -> tuple:
        """The device's peak counters now: requested and allocated bytes."""
        st = torch.cuda.memory_stats(self.device)
        return (st["requested_bytes.all.peak"],
                st["allocated_bytes.all.peak"])

    def _growth_peak(self, opened: tuple, after: dict, base: tuple) -> None:
        """Close one growth's memory measurement (memory ledger on cuda).

        ``opened`` is the capacities before the growth, the device's peak
        counters as it began and the private pool of the block graph the
        growth leaves (0 without one): the forecast adds it to both rungs'
        buffers, a bound on what the released graph still holds.  The
        counters belong to the process and
        are never reset here, so a growth's own peak is known exactly only
        where it raised them: then it is the new peak, above ``base`` (the
        current bytes as the run began).  Otherwise it was at most the
        earlier peak and the entry's ``peak_*`` is None.  Each entry sits
        beside the ledger's forecast for this growth
        (``telemetry/memory.transient_block``)."""
        from ..telemetry.memory import MEMORY_V, transient_block

        before, (req0, alloc0), pool = opened
        req1, alloc1 = self._peaks()
        forecast = transient_block(self._memory_spec_fn(), before, after)
        if pool:
            forecast = dict(
                forecast, graph_pool_bytes=pool,
                transient_bytes=forecast["transient_bytes"] + pool,
                transient_alloc_bytes=forecast["transient_alloc_bytes"] + pool)
        entry = {
            "before": before, "after": after, **forecast,
            "peak_requested_bytes": req1 - base[0] if req1 > req0 else None,
            "peak_bytes": alloc1 - base[1] if alloc1 > alloc0 else None,
        }
        self.growth_memory.append(entry)
        if self.flight_recorder is not None:
            self.flight_recorder.record("memory", v=MEMORY_V, at="growth_peak",
                                        **entry)

    # -- the host loop ---------------------------------------------------------

    def _engine_key(self, cap, qcap, batch, cand) -> tuple:
        """What identifies this checker's engine at these capacities
        (JAX ``_engine_key``; the mesh engine adds its device list)."""
        return (cap, qcap, batch, cand)

    def _engine_for(self, cap, qcap, batch, cand,
                    kind: str = "growth") -> _Engine:
        """The engine of these capacities: the last one when they match,
        else a new one (:meth:`_acquire_engine`; ``kind`` names the rung
        in its ``compile`` event)."""
        key = self._engine_key(cap, qcap, batch, cand)
        eng = self._last_engine
        if eng is None or self._last_engine_key != key:
            eng = self._acquire_engine(key, cap, qcap, batch, cand, kind)
            self._last_engine, self._last_engine_key = eng, key
        return eng

    def _build_engine(self, cap, qcap, batch, cand) -> _Engine:
        """:meth:`_engine`, charged to the calling thread's compile
        counter (``prewarm.build_site``)."""
        with build_site():
            return self._engine(cap, qcap, batch, cand)

    def _acquire_engine(self, key, cap, qcap, batch, cand,
                        kind: str) -> _Engine:
        """A new engine, through the prewarmer (a growth rung built ahead
        of time) or a cold build (JAX ``_engine``, wavefront.py:
        1687-1787).  The ``compile`` event says which path served the
        rung and how long the run thread waited for it.  Engines are per
        checker (each owns mutable buffers), so every acquisition is an
        engine-cache miss."""
        rec = self.flight_recorder
        if rec is not None:
            rec.add("compile_cache_misses")
        ev = dict(cap=cap, qcap=qcap, batch=batch, cand=cand, rung=kind)
        if self._prewarmer is not None:
            try:
                taken = self._prewarmer.take(key)
            except Exception:  # noqa: BLE001 - a failed background build
                taken = None  # is built cold below
            if taken is not None:
                eng, waited, was_ready, job = taken
                self._pending_compile_rec = None
                # a ready rung costs ~0 here (the growth stall prewarm
                # removes); an in-flight one, the rest of its build
                self._stage("compile", waited)
                if rec is not None:
                    rec.record("compile", **ev, source="prewarm",
                               cache_hit=True, prewarm_ready=was_ready,
                               duration=round(waited, 6),
                               build_secs=round(job.compile_secs, 6))
                    rec.add("prewarm_consumed")
                self._schedule_prewarm(cap, qcap, batch, cand)
                return eng
        t0 = time.perf_counter()
        eng = self._build_engine(cap, qcap, batch, cand)
        secs = time.perf_counter() - t0
        self._stage("compile", secs)
        if rec is not None:
            # amended by the first block that pays the kernel library's
            # build or load (:meth:`_device_call`)
            self._pending_compile_rec = rec.record(
                "compile", **ev, source="fresh", cache_hit=False,
                prewarm_ready=False, duration=round(secs, 6),
                build_secs=round(secs, 6))
        return eng

    def _device_call(self, fn, *args):
        """``fn(*args)`` (an engine's ``init`` or ``run``) and the compile
        seconds paid inside it: the kernel library's build or load, at the
        first launch of the process (JAX ``_timed_device_call``,
        wavefront.py:2046-2075).  Those seconds go to the ``compile``
        stage and amend the pending ``compile`` event; once a call pays
        none, the event has converged and stops amending."""
        watch = CompileWatch()
        out = fn(*args)
        d = watch.delta()
        comp = max(d["compile_secs"], 0.0)
        self._stage("compile", comp)
        prev, rec = self._pending_compile_rec, self.flight_recorder
        if prev is not None and rec is not None:
            if comp > 0:
                more = {}
                if d["persistent_hits"] or d["persistent_misses"]:
                    # the kernel library's build or load (a block graph's
                    # capture is no cache lookup)
                    hit = d["persistent_hits"] > 0
                    more = dict(cache_hit=hit,
                                source="persistent" if hit else "fresh")
                rec.amend(prev,
                          duration=round(prev["duration"] + comp, 6),
                          build_secs=round(prev["build_secs"] + comp, 6),
                          **more)
            else:
                self._pending_compile_rec = None
        return out, comp

    def _maybe_schedule_prewarm(self, cap, qcap, batch, cand, unique: int,
                                tail: int) -> None:
        """The prediction gate (JAX wavefront.py:1789-1801): background
        builds start once a growth trigger approaches, JAX's way (the
        table at 1/16 load against the 1/4 trigger, the queue tail at half
        its mark) or within the next block's reach: a block of ``steps``
        steps appends at most ``steps * cand`` rows, so it can cross the
        table's 1/4 load or the queue's mark from far below them, and
        while the budget is under the batch's full width any step can
        overflow it.  (JAX's gate alone leaves 2pc-7's first three rungs
        cold at the default 64 steps a block.)  A run whose next block
        cannot grow builds nothing in the background."""
        if self._prewarmer is None:
            return
        reach = self._steps * cand
        if (unique * 16 > cap or tail * 2 > qcap
                or (unique + reach) * 4 > cap or tail + reach > qcap
                or cand < batch * self.tensor.max_actions):
            self._schedule_prewarm(cap, qcap, batch, cand)

    def _schedule_prewarm(self, cap, qcap, batch, cand) -> None:
        """Queue background builds of the growth ladder's next rungs (JAX
        wavefront.py:1803-1846): the table doubling, the queue doubling,
        and the candidate-budget doubling with the table it pre-sizes
        (growth and the budget replay only move capacities along these
        edges).  Predictions from superseded capacities are pruned.  Each
        build is exactly the cold build's engine: the same key, buffers
        and captures, made on the run thread's stream."""
        if self._prewarmer is None:
            return
        arity = self.tensor.max_actions
        rungs = [(cap * 2, qcap, cand), (cap, qcap * 2, cand)]
        cand2 = min(cand * 2, batch * arity)
        if cand2 != cand:
            nc = cap
            while cand2 * 4 > nc:  # the budget replay pre-sizes the table
                nc *= 2
            rungs.append((nc, qcap, cand2))
        keys = [self._engine_key(nc_, nq_, batch, ncd_)
                for nc_, nq_, ncd_ in rungs]
        self._prewarmer.prune(keys)
        # the worker allocates and launches nothing on its own stream: an
        # engine takes the current stream of the thread that builds it,
        # and the caching allocator ties each buffer to it
        stream = (torch.cuda.current_stream(self.device)
                  if self.device.type == "cuda" else None)
        for (ncap, nqcap, ncand), key in zip(rungs, keys):
            if key == self._last_engine_key or self._prewarmer.scheduled(key):
                continue

            def build(ncap=ncap, nqcap=nqcap, ncand=ncand):
                if stream is None:
                    return self._build_engine(ncap, nqcap, batch, ncand)
                with torch.cuda.stream(stream):
                    return self._build_engine(ncap, nqcap, batch, ncand)

            if self._prewarmer.schedule(key, build):
                if self.flight_recorder is not None:
                    self.flight_recorder.add("prewarm_scheduled")

    def _stats_of(self, carry, layout: CarryLayout, exact: bool = False):
        """:func:`stats_of` of a carry between blocks."""
        return stats_of(carry, layout, exact=exact)

    def _resume_carry(self, snap: dict, arity: int):
        """A snapshot's carry on the device, with its tail re-seeded and
        then grown when it was taken at a growth boundary: an all-clear
        checked word (JAX wavefront.py:2114-2116), the spill tail from the
        snapshot's host-tier manifest (restored first: the growth reads
        the store's length as the spill base) and zeroed cartography
        counters (JAX wavefront.py:2129-2139; the depth histogram comes
        back whole, since the snapshot kept the queue and the bank).
        Returns ``(cap, qcap, batch, cand, carry)``."""
        cap, qcap = int(snap["cap"]), int(snap["qcap"])
        batch = self._batch = int(snap.get("batch", self._batch))
        cand = min(int(snap.get("cand", self._cand)), batch * arity)
        base = convert.cart_depth_base(snap)
        if base is not None:
            self._cart_depth_base = base
        if self._spill:
            self._restore_spill_host(snap)
        carry = convert.carry_from_snapshot(
            snap, self.device, self._qalloc(qcap, batch)
        )
        # the whole carry before any growth: an eviction at the boundary
        # writes its Bloom words and spill base into the spill tail
        if self._checked:
            carry.append(torch.zeros((), dtype=torch.bool,
                                     device=self.device))
        if self._por:
            # a resume is a boundary: one fully expanded batch (boost 1);
            # the tallies restart at zero (JAX wavefront.py:2117-2122)
            carry += por_tail(1, self.device)
        if self._spill:
            carry += self._spill_resume_tail(snap, batch)
        if self._cartography:
            carry += zero_counters(arity, len(self._props), self.device)
        st = int(carry[STATUS])
        if st != _STATUS_OK:
            if st == _STATUS_CAND_FULL:
                cand = min(cand * 2, batch * arity)
            # the growth the run would have made here, eviction included
            # (the JAX resume always grows), so a resumed run ends with the
            # uninterrupted run's tables
            evict = (self._spill and st == _STATUS_TABLE_FULL
                     and self._spill_should_evict(cap, qcap, batch, cand))
            cap, qcap, carry, _ = self._regrow(carry, cap, qcap, batch, st,
                                               cand, evict=evict)
        return cap, qcap, batch, cand, carry

    def _run(self) -> None:
        try:
            self._run_blocks()
        finally:
            if self._last_engine is not None:
                # a finished or failed run launches no more blocks: its
                # graph and pool go (a finished run's carry stays in
                # _final_carry)
                self._last_engine.block = None

    def _run_blocks(self) -> None:
        cap, qcap, batch = self._cap, self._qcap, self._batch
        arity = self.tensor.max_actions
        cand = min(self._cand, batch * arity)
        rec = self.flight_recorder
        cart, lay = self._cartography, self._layout
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
            cap, qcap, batch, cand, carry = self._resume_carry(self._resume,
                                                               arity)
            stats = None
        else:
            while True:
                eng = self._engine_for(cap, qcap, batch, cand, kind="init")
                t_dev = time.perf_counter()
                (carry, stats), comp = self._device_call(eng.init)
                t_dev += comp
                # a table-full init wrote nothing: grow and re-init
                if int(stats[_ST_STATUS]) != _STATUS_TABLE_FULL:
                    break
                prev = cap
                while n_init * 4 > cap or cand * 4 > cap:
                    cap *= 2
                if cap == prev:
                    cap *= 2  # guarantee progress on a clustered init set

        disc_len = max(len(self._props), 1)
        # the checked word, the POR tallies, the spill section
        mid_off = _ST_DISC + disc_len
        por_off = mid_off + int(self._checked)
        cart_off = (por_off + (3 if self._por else 0)
                    + (_SPILL_STATS_SECTION if self._spill else 0))
        occ_every = int(self._telemetry_opts.get("occupancy_every") or 0)
        syncs = 0
        hs = 0  # the host-sync ordinal of the fault seam (JAX's ``hs``)
        if rec is not None:
            rec.update_meta(batch=batch, steps_per_call=self._steps)
            if self._spill:
                from ..spill import SPILL_V
                from ..telemetry.memory import device_budget

                budget, _ = device_budget(self.device)
                rec.record("spill", v=SPILL_V, event="arm",
                           bloom_bits=self._spill_cfg[0],
                           pend_cap=self._spill_cfg[1],
                           **({"budget_bytes": int(budget)} if budget
                              else {}))
                self._refresh_spill()
        ran_block = False
        peak_from = None  # (caps, peaks) as a measured growth began
        while True:
            if stats is None:
                # after a resume, a budget doubling or a spill-tier step:
                # the exact depth histogram, as the JAX engine's host-side
                # stats give
                stats = self._stats_of(carry, lay, exact=True)
            if isinstance(stats, torch.Tensor):
                stats = stats.cpu().numpy()  # the block's one host sync
            if ran_block:
                # the steps the block executed ride its stats read
                k = int(stats[-1])
                stats = stats[:-1]
                self.steps_executed += k
                engine.account(k)
            self._stage("device", time.perf_counter() - t_dev)
            if ran_block and self._profiler is not None:
                self._profiler.tick()
            head, tail, unique, scount, maxdepth, status = (
                int(x) for x in stats[:_ST_DISC]
            )
            disc = stats[_ST_DISC:mid_off].view(np.uint64)
            with self._live_lock:
                self._live = (scount, unique, maxdepth)
                self._live_disc = disc.copy()
            if self._por:
                self._live_por = self._por_stats_dict(
                    stats[por_off:por_off + 3])
            pend_live = spilled_live = 0
            if self._spill:
                sp = stats[cart_off - _SPILL_STATS_SECTION:cart_off]
                pend_live, spilled_live = int(sp[0]), int(sp[1])
                self._spill_tally["deferred"] = int(sp[2])
                self._spill_tally["on_device"] = int(sp[3])
            if cart:
                self._sync_cartography(stats[cart_off:], states=scount,
                                       unique=unique)
            if self._checked and stats[mid_off]:
                # a failed check raises here, before any growth or
                # checkpoint touches the carry
                self._raise_on_checked_error(carry, head, tail, batch)
            if rec is not None:
                # host values this sync already read: the telemetry cost
                # is a few dict appends per block
                syncs += 1
                rec.add_bytes(d2h=stats.nbytes)
                rec.step(
                    engine=self._telemetry_tag, states=scount, unique=unique,
                    depth=maxdepth, status=status, queue=max(tail - head, 0),
                    cap=cap, cand=cand,
                    # HOT occupancy under spill (spilled_live is 0 off)
                    load_factor=round((unique - spilled_live) / cap, 6),
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
            # the fault seam (testing/faults.py): a host-side check, inert
            # with no plan installed; it counts the same syncs as the JAX
            # engine's (one per pass of this loop, resumes and growths
            # included)
            faults.fire("host_sync", recorder=rec, step=hs, unique=unique)
            hs += 1
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
            # BEFORE growing or resolving: a boundary snapshot carries
            # status != OK and resume re-applies the growth; one taken
            # mid-deferral carries the pending buffer
            saved = self._at_host_sync(snap_fn)
            if pend_live and status in (_STATUS_OK, _STATUS_SPILL_SYNC):
                # spill: look the deferred candidates up in the host index
                # and inject the Bloom false positives (a growth boundary
                # resolves at the next sync)
                t0 = time.perf_counter()
                with tel_span("spill_drain", rec, parent=self._run_span_ctx,
                              pending=pend_live):
                    cap, qcap, carry = self._resolve_pending(
                        carry, cap, qcap, batch, cand, pend_live)
                self._stage("spill", time.perf_counter() - t0)
                stats = None
                t_dev = time.perf_counter()
                ran_block = False
                continue
            if status != _STATUS_OK:
                # the fault seam at a growth boundary (table, queue or
                # budget growth, or a spill eviction): where a device OOM
                # strikes, the growth transient
                faults.fire("growth", recorder=rec, status=status,
                            unique=unique)
                pool = 0
                if self._last_engine is not None:
                    # the next block captures anew: the carry the graph
                    # adopted and its pool go now
                    blk, self._last_engine.block = self._last_engine.block, None
                    pool = blk.pool_bytes if blk is not None else 0
                    del blk
                self.growth_events.append((status, unique))
                if measure:
                    if peak_from is not None:
                        self._growth_peak(peak_from, self._memory_caps(
                            cap, qcap, batch, cand), mem_base)
                    peak_from = (self._memory_caps(cap, qcap, batch, cand),
                                 self._peaks(), pool)
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
                        # under spill, a table rung the device budget
                        # cannot take evicts the hot table instead of
                        # growing it (JAX wavefront.py:2364-2375)
                        evict = (self._spill
                                 and status == _STATUS_TABLE_FULL
                                 and self._spill_should_evict(cap, qcap,
                                                              batch, cand))
                        cap, qcap, carry, carry_np = self._regrow(
                            carry, cap, qcap, batch, status, cand,
                            at="growth", evict=evict,
                        )
                        # the next sync reads the carry the host just grew
                        # (a spill run's section re-reads the device)
                        stats = None if self._spill else stats_host(
                            carry_np, stats[mid_off:cart_off],
                            stats[cart_off + DEPTH_BINS:] if cart
                            else stats[:0])
                if self._por:
                    # a growth is a boundary: arm one fully expanded batch
                    # (JAX wavefront.py:2333-2335)
                    carry[lay.por_start] = torch.ones(
                        (), dtype=torch.int32, device=self.device)
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
            if (self._spill and tail <= head and self._spill_qrows
                    and not all_disc and not target_hit):
                # the device queue drained with offloaded rows left on the
                # host: refill; the search ends when every tier is empty
                t0 = time.perf_counter()
                carry = self._queue_refill(carry, qcap, batch)
                self._stage("spill", time.perf_counter() - t0)
                stats = None
                t_dev = time.perf_counter()
                ran_block = False
                continue
            if tail <= head or all_disc or target_hit:
                break
            engine = self._engine_for(cap, qcap, batch, cand)
            # after the acquisition: the gate prunes every rung but the
            # next ones, and a rung built before its boundary is ready
            self._maybe_schedule_prewarm(cap, qcap, batch, cand, unique, tail)
            if peak_from is not None:
                self._growth_peak(peak_from, self._memory_caps(
                    cap, qcap, batch, cand), mem_base)
                peak_from = None
            if self._profiler is not None:
                self._profiler.maybe_start(
                    CUPTI_FAULT if engine.uses_graph else None)
            t_dev = time.perf_counter()
            (carry, stats), comp = self._device_call(engine.run, carry)
            t_dev += comp
            ran_block = True
            self.steps_run += engine.steps
            blk = getattr(engine, "block", None)
            if blk is not None and not blk.reported:
                blk.reported = True
                self.block_graphs.append(dict(cap=cap, qcap=qcap,
                                              batch=batch, cand=cand,
                                              **blk.record()))
                if self._mem_ledger is not None:
                    self._mem_ledger.note_graph_pool(blk.pool_bytes)
            del blk

        if peak_from is not None:
            self._growth_peak(peak_from, self._memory_caps(
                cap, qcap, batch, cand), mem_base)
        self._cap, self._qcap, self._cand = cap, qcap, cand
        self._final_carry = carry
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
        if self._por and self._live_por is not None:
            self._results["por"] = dict(self._live_por)
        if self._spill:
            from ..spill import SPILL_V

            snap_sp = self._results["spill"] = self._spill_snapshot()
            if rec is not None:
                rec.record(
                    "spill", v=SPILL_V, event="final",
                    spilled_fps=snap_sp["spilled_fps"],
                    host_bytes=snap_sp["host_bytes"],
                    disk_bytes=snap_sp["disk_bytes"],
                    dups=snap_sp["resolved_dups"],
                    novel=snap_sp["resolved_novel"])
                self._refresh_spill()
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
        footprint at these capacities (``telemetry/memory.py``; the hot
        tier only), the cartography depth bank and, under spill, the
        host and disk tiers' contents with the offloaded queue rows and
        the pending entries (JAX wavefront.py:1901-1932), so that a
        resumed run rebuilds the whole tiered visited set."""
        extra = {}
        fb = self._analytic_footprint_bytes(
            self._memory_caps(cap, qcap, batch, cand))
        if fb is not None:
            extra["footprint_bytes"] = np.int64(fb)
        snap = convert.carry_to_snapshot(
            carry[:BASE], cap, qcap, batch, cand, width=self.tensor.width,
            engine=self._engine_tag, model_sig=self._model_sig(),
            run_id=self.run_id, cart_depth_base=self._cart_depth_base,
            **extra,
        )
        if self._spill:
            snap["spill_bloom_bits"] = np.int64(self._spill_cfg[0])
            snap["spill_base"] = np.int64(len(self._spill_store))
            f, p = self._spill_store.to_arrays()
            if f.size:
                snap["spill_fp"], snap["spill_parent"] = f, p
            if self._spill_qrows:
                for j, k in enumerate(("spill_q_rows", "spill_q_fp",
                                       "spill_q_ebits", "spill_q_depth")):
                    snap[k] = np.concatenate([c[j] for c in self._spill_qrows])
            sp = self._layout.spill_start
            pn = int(carry[sp + _SP_PCOUNT])
            if pn > 0:
                snap.update(convert.pend_to_snapshot(
                    carry[sp + _SP_PFP:sp + _SP_PCOUNT], pn))
        return snap

    def final_snapshot(self) -> dict:
        """The finished run's carry as a snapshot (:meth:`_snapshot`)."""
        self.join()
        return self._snapshot(self._final_carry, self._cap, self._qcap,
                              self._batch, self._cand)
