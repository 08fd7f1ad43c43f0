"""The GPU wavefront BFS engine — ``spawn_gpu()``.

The port's counterpart of ``stateright_tpu/parallel/wavefront.py``
(``_build_engine`` and ``TpuChecker``), single device, with symmetry
reduction and intra-window pre-dedup (``.prededup()``); no POR, spill,
cartography, checked mode or prewarm.  The engine keeps a device-resident FIFO queue of state rows and
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
from ..ops.hashing import EMPTY, row_hash
from ..ops.insert_commit import QueueAppend, insert_commit
from ._base import WavefrontChecker

_STATUS_OK = 0
_STATUS_QUEUE_FULL = 1
_STATUS_TABLE_FULL = 2
_STATUS_CAND_FULL = 3  # valid candidates exceeded the compaction budget
_STATUS_POISON = 4  # a compiled-twin transition crossed its compile bound

# Packed stats layout: [head, tail, unique, scount, maxdepth, status, disc...]
_ST_STATUS = 5
_ST_DISC = 6
_STATS_CARRY_ORDER = (HEAD, TAIL, UNIQUE, SCOUNT, MAXDEPTH, STATUS)


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def _i32(x: int) -> int:
    """The int32 whose bits are the low 32 bits of ``x`` (queue ebits)."""
    x &= 0xFFFFFFFF
    return x - (1 << 32) if x >= 1 << 31 else x


def stats_of(carry: list) -> torch.Tensor:
    """Every scalar the host loop reads, packed into one int64 tensor, so
    a host sync is a single device-to-host copy."""
    return torch.cat([
        torch.stack([carry[i] for i in _STATS_CARRY_ORDER]), carry[DISC],
    ])


class _Engine:
    """The device program for fixed capacities: :meth:`init` builds the
    initial carry, :meth:`run` advances it by up to ``steps`` steps."""

    def __init__(self, tensor, props, cap: int, qcap: int, batch: int,
                 steps: int, target: Optional[int], cand: Optional[int],
                 device, sym: bool = False, prededup: bool = False,
                 removed: Optional[torch.Tensor] = None):
        self.tensor, self.props = tensor, props
        self.cap, self.qcap, self.batch, self.steps = cap, qcap, batch, steps
        self.target, self.device, self.sym = target, device, sym
        self.key = (cap, qcap, batch, cand, sym)
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
        return carry, stats_of(carry)


class GpuChecker(WavefrontChecker):
    """Queue-based wavefront BFS on a CUDA device (or, in tests, the CPU).

    ``capacity`` — table slots (grown on demand, work preserved).
    ``batch`` — rows expanded per device step.  ``cand`` — valid-candidate
    compaction budget per batch (default ``max(4 * batch, 4096)``; doubled
    on demand).  ``steps_per_call`` — device steps per host sync.
    ``device`` — ``None`` means ``cuda``, and raises when there is no CUDA
    device.  ``resume`` — a snapshot (``convert.py``) to continue from.
    """

    def __init__(self, options, capacity: int = 1 << 17, batch: int = 1 << 11,
                 cand: Optional[int] = None, steps_per_call: int = 64,
                 device=None, resume: Optional[dict] = None):
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
        self._cap = max(_pow2(capacity), 4 * SLOTS)
        self._batch = max(8, batch)
        self._cand = cand or max(4 * self._batch, 4096)
        self._qcap = max(self._cap // 2, 4 * self._batch)
        self._steps = steps_per_call
        self._resume = resume
        # (status, unique-at-boundary) per mid-run growth event, and the
        # host seconds each took (device sync, host rehash and copies)
        self.growth_events: list = []
        self.growth_secs: list = []
        self.steps_run = 0  # device steps issued, post-stop no-ops included
        self._final_carry = None
        # under prededup, the lanes it took out since this process started
        self._removed = torch.zeros((), dtype=torch.int64,
                                    device=self.device)
        self._init_common(options)

    def _engine(self, cap, qcap, batch, cand) -> _Engine:
        return _Engine(self.tensor, self._props, cap, qcap, batch,
                       self._steps, self._target, cand, self.device,
                       sym=self._symmetry is not None,
                       prededup=self._prededup, removed=self._removed)

    def _pre_run_validate(self) -> None:
        if self._resume is not None:
            self._check_snapshot_sig(self._resume)

    def _qalloc(self, qcap: int, batch: int) -> int:
        return qcap + batch * self.tensor.max_actions

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

    def _regrow(self, carry, cap, qcap, batch, status, cand):
        """:meth:`_grow` over a device carry (through the host)."""
        cap, qcap, carry_np = self._grow(
            convert.carry_to_arrays(carry), cap, qcap, batch, status, cand
        )
        return cap, qcap, convert.carry_from_arrays(
            carry_np, self.device, self._qalloc(qcap, batch)
        )

    def _run(self) -> None:
        cap, qcap, batch = self._cap, self._qcap, self._batch
        arity = self.tensor.max_actions
        cand = min(self._cand, batch * arity)
        # static preconditions: cand*4 <= cap, and the init set fits the queue
        while cand * 4 > cap:
            cap *= 2
        n_init = len(np.asarray(self.tensor.init_rows()))
        while n_init > qcap:
            qcap *= 2
        self._cap, self._qcap, self._cand = cap, qcap, cand
        if self._resume is not None:
            snap = self._resume
            cap, qcap = int(snap["cap"]), int(snap["qcap"])
            batch = self._batch = int(snap.get("batch", batch))
            cand = min(int(snap.get("cand", cand)), batch * arity)
            carry = convert.carry_from_snapshot(
                snap, self.device, self._qalloc(qcap, batch)
            )
            stats = None
            # a snapshot taken at a growth boundary still carries the flag
            st = int(carry[STATUS])
            if st != _STATUS_OK:
                if st == _STATUS_CAND_FULL:
                    cand = min(cand * 2, batch * arity)
                cap, qcap, carry = self._regrow(carry, cap, qcap, batch, st, cand)
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
        sym = self._symmetry is not None
        engine = None
        while True:
            if stats is None:
                stats = stats_of(carry)
            stats = stats.cpu().numpy()  # the block's one host sync
            head, tail, unique, scount, maxdepth, status = (
                int(x) for x in stats[:_ST_DISC]
            )
            disc = stats[_ST_DISC:_ST_DISC + disc_len].view(np.uint64)
            self._live = (scount, unique, maxdepth)
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
                t0 = time.perf_counter()
                if status == _STATUS_CAND_FULL:
                    # the budget is an engine parameter: double it, clear
                    # the status (the insert wrote nothing), replay
                    cand = min(cand * 2, batch * arity)
                    carry[STATUS] = torch.zeros_like(carry[STATUS])
                    while cand * 4 > cap:
                        cap, qcap, carry = self._regrow(
                            carry, cap, qcap, batch, _STATUS_TABLE_FULL, cand
                        )
                else:
                    cap, qcap, carry = self._regrow(
                        carry, cap, qcap, batch, status, cand
                    )
                self.growth_secs.append(time.perf_counter() - t0)
                stats = None
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
            if engine is None or engine.key != (cap, qcap, batch, cand, sym):
                engine = self._engine(cap, qcap, batch, cand)
            carry, stats = engine.run(carry)
            self.steps_run += engine.steps

        self._cap, self._qcap, self._cand = cap, qcap, cand
        self._final_carry = carry
        self._results = {
            "unique": unique,
            "states": scount,
            "disc": np.asarray(disc),
            "depth": maxdepth,
        }

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
        off the device): either engine resumes from it."""
        return convert.carry_to_snapshot(
            carry, cap, qcap, batch, cand, width=self.tensor.width,
            engine=self._engine_tag, model_sig=self._model_sig(),
        )

    def final_snapshot(self) -> dict:
        """The finished run's carry as a snapshot (:meth:`_snapshot`)."""
        self.join()
        return self._snapshot(self._final_carry, self._cap, self._qcap,
                              self._batch, self._cand)

