"""HBM ledger & capacity planning: where the device memory goes, and when
it runs out.

The port's counterpart of ``stateright_tpu/telemetry/memory.py``, on the
port's own buffers.  Two reconciling views:

 - **Analytic footprint model** — exact bytes per device-resident buffer
   of the GPU engine (``parallel/wavefront.py``) at the current capacities
   and at every future growth rung: the carry (table, queue, cursors and
   counters, and the cartography counters when they are on) AND the
   buffers the engine owns beside it — the kernels' outputs and scratch
   (``ops/cand_prep.PrepBuffers``, ``ops/buckets.PlanBuffers``, allocated
   once per engine on ``cuda``) and the lane index.  The JAX ledger counts
   only its carry; here the kernels' resident scratch counts against the
   budget too.  ``QueueAppend`` owns nothing: its buffers are the
   carry's queue.  Pinned by ``tests/test_torch_memory.py``: analytic
   bytes == the live tensors' ``nbytes`` exactly, at every rung.
 - **Live device readings** — :func:`device_memory_stats` on
   ``torch.cuda.memory_stats`` and ``torch.cuda.mem_get_info``; None on
   the CPU, where every consumer degrades to the analytic path.  On CUDA
   each record's live block also gives the engine's block-graph pool
   (``graph_pool_bytes``, :meth:`MemoryLedger.note_graph_pool`), which the
   analytic buffers do not cover.

On top of the ledger:

 - a **growth-transient forecast** that models the port's growth:
   ``GpuChecker._regrow`` pulls the carry to numpy, grows it there, and
   builds the new device carry while the old one (and the old engine's
   scratch) is still referenced; the next block then builds the new
   engine's scratch before the old engine is dropped.  So the next rung's
   peak is ``total(rung) + total(rung + 1)``, each total carry plus
   scratch, in tensor bytes, and :func:`alloc_bytes` bounds what the CUDA
   caching allocator charges for the same buffers (its 512-byte blocks
   and unsplit large blocks).  On the card the engine measures the peak
   of both across each growth that raises the process's peak, without
   resetting the device's peak counters (``GpuChecker.growth_memory``);
 - a ``growth_oom_risk`` health condition (``telemetry/health.py``);
 - a **preflight capacity guard** in ``spawn_gpu``: warn (flag-gated
   error via ``STATERIGHT_TPU_CAPACITY_GUARD=error``) when the requested
   capacities analytically exceed the device's memory.

``exec_memory`` (XLA's compiled-executable analysis in the JAX package)
has no counterpart until the port captures its step as one executable
(the CUDA-graph step).  Contract: the ledger is host arithmetic over
shapes the engine already knows — on or off, the step dispatches the same
operations.  The budget can be overridden with
``STATERIGHT_TPU_DEVICE_BYTES`` (bytes), which is how CPU tests exercise
the guard.
"""

from __future__ import annotations

import os
import sys
from typing import Callable, Optional

import numpy as np

# memory snapshot / ring-record schema version
MEMORY_V = 1

# table load at which the growth forecast becomes a live risk: half-way
# to the engines' 25% growth trigger — the run WILL grow soon, and if the
# next rung's transient does not fit, the operator should know before it
# happens (health.py reads this)
OOM_RISK_LOAD = 0.125

ENV_DEVICE_BYTES = "STATERIGHT_TPU_DEVICE_BYTES"
ENV_CAPACITY_GUARD = "STATERIGHT_TPU_CAPACITY_GUARD"

# engines grow the visited table when unique * 4 > capacity, so a rung of
# ``cap`` slots holds at most cap/4 unique states before the NEXT rung's
# transient must fit (ops/buckets.py Poisson tail rationale)
GROWTH_LOAD_DENOM = 4


class BufferSpec:
    """One device-resident buffer: name, shape, dtype, exact bytes."""

    __slots__ = ("name", "shape", "dtype", "nbytes")

    def __init__(self, name: str, shape: tuple, dtype) -> None:
        self.name = name
        self.shape = tuple(int(d) for d in shape)
        self.dtype = np.dtype(dtype)
        n = 1
        for d in self.shape:
            n *= d
        self.nbytes = int(n * self.dtype.itemsize)

    def __repr__(self) -> str:  # debugging ergonomics only
        return (
            f"BufferSpec({self.name!r}, {self.shape}, "
            f"{self.dtype.name}, {self.nbytes}B)"
        )


def total_bytes(specs: list) -> int:
    return int(sum(s.nbytes for s in specs))


# PyTorch's CUDA caching allocator: every block is a multiple of 512
# bytes, and a request over 1 MiB is served from the large pool, whose
# block is split only when more than 1 MiB would be left over
_ALLOC_ROUND = 512
_ALLOC_SMALL = 1 << 20


def alloc_bytes(specs: list) -> int:
    """An upper bound on the bytes the CUDA caching allocator charges
    (``allocated_bytes``) for these buffers: each rounded up to 512 bytes,
    and each large one (over 1 MiB) up to 1 MiB more, the unsplit rest of
    the block it was served from.  :func:`total_bytes` is what the
    tensors hold (``requested_bytes``)."""
    out = 0
    for s in specs:
        out += -(-s.nbytes // _ALLOC_ROUND) * _ALLOC_ROUND
        if s.nbytes > _ALLOC_SMALL:
            out += _ALLOC_SMALL
    return int(out)


def buffers_dict(specs: list) -> dict:
    """JSON-facing ``{name: nbytes}`` map (insertion = carry order)."""
    return {s.name: s.nbytes for s in specs}


# -- per-engine analytic models ----------------------------------------------

# the GPU engine's carry, in carry order (``convert.SNAPSHOT_KEYS``); its
# scalars are 0-d int64 (the JAX carry keeps head, tail, maxdepth and
# status as int32)
_CARRY_NAMES = (
    "table_fp", "table_parent", "q_rows", "q_fp", "q_ebits", "q_depth",
    "head", "tail", "unique", "scount", "disc", "maxdepth", "status",
)
_CART_NAMES = ("cart_action_hist", "cart_prop_evals", "cart_prop_hits")
# the POR pair of the carry (JAX telemetry/memory.py:125-150's names)
_POR_NAMES = ("por_boost", "por_stats")
# the spill tier's carry tail, under the JAX ledger's names (JAX
# telemetry/memory.py:148-151)
_SPILL_NAMES = ("spill_bloom", "spill_base", "pend_fp", "pend_rows",
                "pend_parent", "pend_ebits", "pend_depth", "pend_count",
                "spill_stats")


def wavefront_specs(
    width: int, arity: int, n_props: int, cap: int, qcap: int, batch: int,
    cand: int, *, cartography: bool = False, sym: bool = False,
    cuda: bool = True, checked: bool = False, spill=None, por: bool = False,
) -> list:
    """Per-buffer specs of the GPU engine's device-resident buffers at
    these capacities: the carry (``_Engine.init``; the queue is
    over-allocated by one batch's candidates, two under ``por``, or by the
    spill inject's ``pend_cap`` rows when wider), the checked error word,
    the POR pair (the boost word and the tallies), the spill tail
    (``spill`` is the tier's ``(bloom_bits, pend_cap)``; the host and disk
    tiers are what the budget is traded against and do not count), the
    cartography counters, the engine's own index buffers, and on ``cuda``
    the kernels' outputs and scratch (``PrepBuffers(m, eff_cand)``,
    ``PlanBuffers(eff_cand, sym)``, under POR a second pair for the
    proviso round, and under spill the inject's ``PlanBuffers(pend_cap,
    sym)``).  On the CPU the plain versions allocate per call, so nothing
    else stays resident.  (A POR plan's few ``A x A`` constants are the
    plan's, not the capacities', and are not counted.)"""
    from ..ops.buckets import PLAN_SCRATCH, PLAN_TILE
    from ..ops.cand_prep import PREP_SCRATCH, PREP_TILE

    i64, i32 = np.int64, np.int32
    m = batch * arity
    qalloc = qcap + (2 * m if por else max(spill[1], m) if spill else m)
    cb = min(cand, m) if cand else m
    p = max(n_props, 1)
    shapes = (
        ((cap,), i64), ((cap,), i64), ((qalloc, width), i64), ((qalloc,), i64),
        ((qalloc,), i32), ((qalloc,), i32), ((), i64), ((), i64), ((), i64),
        ((), i64), ((p,), i64), ((), i64), ((), i64),
    )
    specs = [BufferSpec(n, s, d) for n, (s, d) in zip(_CARRY_NAMES, shapes)]
    if checked:
        specs.append(BufferSpec("checked_err", (), np.bool_))
    if por:
        specs += [BufferSpec("por_boost", (), i32),
                  BufferSpec("por_stats", (3,), i64)]
    if spill:
        bits, pend_cap = spill
        palloc = pend_cap + m
        specs += [BufferSpec(n, s, d) for n, (s, d) in zip(_SPILL_NAMES, (
            ((bits // 32,), i32), ((), i64), ((palloc,), i64),
            ((palloc, width), i64), ((palloc,), i64), ((palloc,), i32),
            ((palloc,), i32), ((), i64), ((2,), i64),
        ))]
    if cartography:
        specs += [BufferSpec(n, s, i64) for n, s in
                  zip(_CART_NAMES, ((max(arity, 1),), (p,), (p,)))]
    specs.append(BufferSpec("lanes", (batch,), i64))
    if checked:
        specs.append(BufferSpec("checked_init_row", (width,), i64))
    if spill:
        specs.append(BufferSpec("pend_lanes", (m,), i64))
    if por:
        specs.append(BufferSpec("por_cand_lanes", (cb,), i64))
    if cuda:
        for pre in ("prep", "prep2") if por else ("prep",):
            specs += [BufferSpec(f"{pre}_{n}", (cb,), i64)
                      for n in ("fp", "payload", "cidx", "key")]
            specs += [
                BufferSpec(f"{pre}_n_valid", (), i64),
                BufferSpec(f"{pre}_cand_overflow", (), np.bool_),
                BufferSpec(f"{pre}_scratch",
                           (PREP_SCRATCH + -(-m // PREP_TILE),), i64),
            ]
        plans = ([("plan", cb)] + ([("plan2", cb)] if por else [])
                 + ([("inject", spill[1])] if spill else []))
        for pre, n in plans:
            specs += [BufferSpec(f"{pre}_{k}", (n,), i64)
                      for k in ("tgt", "cfp", "cpl", "sel")]
            specs += [
                BufferSpec(f"{pre}_n_new", (), i64),
                BufferSpec(f"{pre}_overflow", (), np.bool_),
                BufferSpec(f"{pre}_scratch",
                           (PLAN_SCRATCH + -(-n // PLAN_TILE),), i64),
            ]
            if sym:
                specs.append(BufferSpec(f"{pre}_stage", (3 * n,), i64))
    return specs


def sharded_specs(
    width: int, arity: int, n_props: int, ndev: int,
    cap_local: int, fcap_local: int,
    *, cartography: bool = False, por: bool = False,
) -> list:
    """Per-buffer specs of the sharded engine's global carry (JAX
    ``sharded_specs``, telemetry/memory.py:160), under the JAX names and
    dtypes, so a snapshot's ``footprint_bytes`` is the same in either
    package: the shards' tables and frontiers, the replicated scalars,
    the POR pair and the cartography counters (the per-shard load and the
    route matrix included).  The port's carry keeps its scalars as 0-d
    int64 and one more, the live frontier count: a few bytes the JAX model
    does not have."""
    p = max(n_props, 1)
    u64 = np.uint64
    specs = [
        BufferSpec("table_fp", (ndev * cap_local,), u64),
        BufferSpec("table_parent", (ndev * cap_local,), u64),
        BufferSpec("rows", (ndev * fcap_local, width), u64),
        BufferSpec("fps", (ndev * fcap_local,), u64),
        BufferSpec("ebits", (ndev * fcap_local,), np.uint32),
        BufferSpec("unique", (), np.int64),
        BufferSpec("scount", (), np.int64),
        BufferSpec("disc", (p,), u64),
        BufferSpec("depth", (), np.int32),
        BufferSpec("status", (), np.int32),
    ]
    if por:
        specs += [BufferSpec("por_boost", (), np.int32),
                  BufferSpec("por_stats", (3,), np.int64)]
    if cartography:
        from ..ops.cartography import DEPTH_BINS

        specs += [
            BufferSpec("cart_depth_hist", (DEPTH_BINS,), np.int64),
            BufferSpec("cart_action_hist", (max(arity, 1),), np.int64),
            BufferSpec("cart_prop_evals", (p,), np.int64),
            BufferSpec("cart_prop_hits", (p,), np.int64),
            BufferSpec("cart_shard_load", (ndev,), np.int64),
            BufferSpec("cart_route_matrix", (ndev, ndev), np.int64),
        ]
    return specs


# -- live device readings ----------------------------------------------------


def device_memory_stats(device=None) -> Optional[dict]:
    """Live readings of a CUDA device (default: the current one), as
    JSON-safe ints under the JAX ledger's keys: ``bytes_in_use`` and
    ``peak_bytes_in_use`` (``torch.cuda.memory_stats``'s
    ``allocated_bytes.all.current``/``.peak``), ``bytes_reserved``
    (``reserved_bytes.all.current``: the caching allocator's hold),
    ``bytes_limit`` and ``bytes_free`` (``torch.cuda.mem_get_info``).
    None on the CPU, or without a CUDA device."""
    try:
        import torch

        if device is not None and torch.device(device).type != "cuda":
            return None
        if not torch.cuda.is_available():
            return None
        dev = torch.device(device if device is not None else "cuda")
        stats = torch.cuda.memory_stats(dev)
        free, total = torch.cuda.mem_get_info(dev)
    except Exception:  # noqa: BLE001 - absent/unsupported backend
        return None
    return {
        "platform": "gpu",
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_reserved": int(stats.get("reserved_bytes.all.current", 0)),
        "bytes_limit": int(total),
        "bytes_free": int(free),
    }


def device_budget(device=None) -> tuple:
    """``(bytes, src)`` for capacity planning: the env override
    ``STATERIGHT_TPU_DEVICE_BYTES`` wins (simulated budgets — also how
    CPU tests exercise the guard), then the live ``bytes_limit``; both
    absent ⇒ ``(None, None)`` and planners print the analytic table
    without a verdict."""
    env = os.environ.get(ENV_DEVICE_BYTES, "").strip()
    if env:
        try:
            return int(env), "env"
        except ValueError:
            pass
    stats = device_memory_stats(device)
    if stats and stats.get("bytes_limit"):
        return int(stats["bytes_limit"]), "device"
    return None, None


# -- growth-transient forecast + capacity plan -------------------------------


def transient_block(spec_fn: Callable, before: dict, after: dict) -> dict:
    """The growth transient from capacities ``before`` to ``after``: the
    buffers of both live together (module docstring), in tensor bytes and
    in the allocator's bound (:func:`alloc_bytes`)."""
    a, b = spec_fn(before), spec_fn(after)
    return {"transient_bytes": total_bytes(a) + total_bytes(b),
            "transient_alloc_bytes": alloc_bytes(a) + alloc_bytes(b)}


def next_rung_block(spec_fn: Callable, caps: dict) -> dict:
    """The analytic forecast for the NEXT table-doubling rung: steady
    bytes and the growth transient."""
    nxt = dict(caps)
    nxt["cap"] = int(caps["cap"]) * 2
    return {
        "capacity": int(nxt["cap"]),
        "total_bytes": total_bytes(spec_fn(nxt)),
        **transient_block(spec_fn, caps, nxt),
    }


def capacity_plan(
    spec_fn: Callable, caps: dict, *, budget: Optional[int] = None,
    rungs: int = 24, spill: bool = False,
    spill_host_bytes: Optional[int] = None,
) -> dict:
    """The capacity ladder from ``caps`` upward: per rung, steady bytes,
    the growth transient (previous rung + this rung live), and — when a
    ``budget`` is known — whether it fits.  ``max_unique`` is the planning
    headline: the largest rung whose TRANSIENT fits holds at most
    ``capacity / 4`` unique states before the next (unfitting) growth.

    ``spill=True`` plans with the spill tier armed (JAX
    ``telemetry/memory.py:309-372``): the ladder still caps the HOT tier
    at the largest affordable rung, and ``max_unique`` extends by the host
    tier's reach (``spill_host_bytes``, else ``STATERIGHT_TPU_HOST_BYTES``,
    else half the host's RAM, at 16 bytes a spilled state), with the
    mmap'd disk tier unbounded behind it, in the ``spill`` block."""
    ladder = []
    cur = dict(caps)
    prev_total = None
    max_unique = None
    for _ in range(rungs):
        total = total_bytes(spec_fn(cur))
        transient = total if prev_total is None else prev_total + total
        fits = None if budget is None else transient <= budget
        ladder.append({
            "capacity": int(cur["cap"]),
            "total_bytes": total,
            "transient_bytes": transient,
            **({} if fits is None else {"fits": fits}),
        })
        if fits:
            max_unique = int(cur["cap"]) // GROWTH_LOAD_DENOM
        if fits is False:
            break
        prev_total = total
        cur = dict(cur)
        cur["cap"] = int(cur["cap"]) * 2
    out = {
        "v": MEMORY_V,
        "rungs": ladder,
        "budget_bytes": budget,
    }
    if max_unique is not None:
        out["max_unique"] = max_unique
    if spill and budget is not None and max_unique is not None:
        from ..spill.store import BYTES_PER_ENTRY, default_host_budget

        hb = (int(spill_host_bytes) if spill_host_bytes is not None
              else default_host_budget())
        block: dict = {
            "hot_max_unique": max_unique,
            "bytes_per_spilled": BYTES_PER_ENTRY,
            "host_budget_bytes": hb,
            "disk": "unbounded (mmap tier; bounded by disk capacity)",
        }
        if hb:
            block["host_max_unique"] = hb // BYTES_PER_ENTRY
            out["max_unique"] = max_unique + block["host_max_unique"]
        out["spill"] = block
    return out


def fmt_bytes(n: Optional[int]) -> str:
    """Human bytes (``1.5GB``); '-' for unknown."""
    if n is None:
        return "-"
    n = float(n)
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(n) < 1024 or unit == "TB":
            return (f"{n:.0f}{unit}" if unit == "B"
                    else f"{n:.1f}{unit}")
        n /= 1024
    return f"{n:.1f}TB"  # pragma: no cover - unreachable


# -- the ledger --------------------------------------------------------------


class MemoryLedger:
    """Host-side memory accounting for one engine run.

    ``spec_fn(caps) -> [BufferSpec]`` is the engine's analytic model;
    ``caps`` dicts must carry at least ``cap`` (table slots — the
    doubling edge the growth forecast walks).  The ledger recomputes the
    footprint only when the capacity rung changes, pushes every snapshot
    into the flight recorder (``rec.set_memory`` — which also feeds the
    health model's ``growth_oom_risk`` guard), and emits ``memory`` ring
    records at growth boundaries plus periodic watermark samples
    (``every`` host syncs; live ``peak_bytes_in_use`` is the watermark).
    Zero device ops — everything here is host arithmetic over shapes the
    engine already knows (the live readings are allocator counters)."""

    def __init__(
        self,
        engine: str,
        spec_fn: Callable,
        recorder=None,
        *,
        every: int = 0,
        extra: Optional[dict] = None,
    ) -> None:
        self.engine = engine
        self.spec_fn = spec_fn
        self.recorder = recorder
        self.every = int(every)
        # engine-shape annotations for the snapshot (queue_capacity,
        # candidate_budget), refreshed per observe
        self.extra = dict(extra or {})
        self._caps: Optional[dict] = None
        self._snap: Optional[dict] = None
        self._observes = 0
        budget, src = device_budget()
        self._budget, self._budget_src = budget, src
        # bytes of the current engine's block-graph pool (CUDA only)
        self.graph_pool_bytes: Optional[int] = None

    def note_graph_pool(self, nbytes: int) -> None:
        """The private pool of the engine's block graph
        (``ops/block_loop.py``): the step's intermediates, which stay
        reserved as long as the engine lives.  Each later record's
        ``device`` block gives it beside the allocator's counters."""
        self.graph_pool_bytes = int(nbytes)

    # -- feeding -------------------------------------------------------------

    def observe(self, caps: dict, *, at: Optional[str] = None,
                extra: Optional[dict] = None) -> dict:
        """One host-sync observation.  Recomputes the analytic block when
        the capacity rung changed (emitting a ``memory`` ring record
        tagged ``growth`` unless ``at`` overrides), else emits only the
        periodic watermark sample when due.  Returns the live snapshot."""
        caps = dict(caps)
        if extra:
            self.extra.update(extra)
        self._observes += 1
        rung_changed = caps != self._caps
        if rung_changed:
            self._caps = caps
            self._snap = self._build_snapshot(caps)
            if self.recorder is not None:
                self.recorder.set_memory(self._snap)
        due = self.every and self._observes % self.every == 0
        if at is not None or rung_changed or due:
            tag = at
            if tag is None:
                tag = "growth" if self._observes > 1 else "init"
                if not rung_changed:
                    tag = f"sample{self._observes}"
            self._record(tag)
        return self._snap

    def finalize(self) -> Optional[dict]:
        """Close the memory time series with a ``final`` record (fresh
        live stats — the run's peak watermark)."""
        if self._caps is None:
            return None
        self._record("final")
        return self.snapshot()

    # -- reading -------------------------------------------------------------

    def snapshot(self) -> Optional[dict]:
        """The latest full block (analytic + live device fields), or
        None before the first observe."""
        return dict(self._snap) if self._snap else None

    def analytic_block(self) -> Optional[dict]:
        """The DETERMINISTIC subset for the run report: analytic bytes
        only — no live device stats, no machine-local budget (the report
        body must stay byte-stable across runs and machines)."""
        snap = self.snapshot()
        if snap is None:
            return None
        return {
            k: snap[k]
            for k in ("v", "engine", "capacity", "queue_capacity",
                      "candidate_budget", "buffers", "total_bytes",
                      "next_rung")
            if k in snap
        }

    # -- internals -----------------------------------------------------------

    def _build_snapshot(self, caps: dict) -> dict:
        specs = self.spec_fn(caps)
        snap: dict = {
            "v": MEMORY_V,
            "engine": self.engine,
            "capacity": int(caps["cap"]),
            **self.extra,
            "buffers": buffers_dict(specs),
            "total_bytes": total_bytes(specs),
            "next_rung": next_rung_block(self.spec_fn, caps),
        }
        if self._budget is not None:
            snap["budget_bytes"] = self._budget
            snap["budget_src"] = self._budget_src
        return snap

    def _record(self, at: str) -> None:
        if self.recorder is None or self._snap is None:
            return
        rec_fields = {
            k: v for k, v in self._snap.items() if k != "v"
        }
        live = device_memory_stats()
        if live is not None:
            if self.graph_pool_bytes is not None:
                live["graph_pool_bytes"] = self.graph_pool_bytes
            rec_fields["device"] = live
            # refresh the live view consumers poll (watch/Explorer)
            self._snap = dict(self._snap)
            self._snap["device"] = live
            self.recorder.set_memory(self._snap)
        self.recorder.record("memory", v=MEMORY_V, at=at, **rec_fields)


# -- preflight capacity guard ------------------------------------------------


def guard_mode() -> str:
    """``warn`` (default) | ``error`` | ``off`` from
    ``STATERIGHT_TPU_CAPACITY_GUARD``."""
    mode = os.environ.get(ENV_CAPACITY_GUARD, "").strip().lower()
    if mode in ("error", "raise"):
        return "error"
    if mode in ("0", "off", "skip"):
        return "off"
    return "warn"


class CapacityError(RuntimeError):
    """Raised by the preflight guard (``STATERIGHT_TPU_CAPACITY_GUARD=
    error``) when the requested capacities analytically exceed device
    memory — before any compile is paid."""


def preflight_guard(
    context: str, total: int, *, warn_once_obj=None
) -> None:
    """Warn (flag-gated error) when an analytic STEADY footprint exceeds
    the device budget — the requested capacities cannot even sit on the
    device.  (Whether future growth TRANSIENTS fit is a forecast, not a
    precondition — a space that fits the first rung may never grow — so
    that lives in the runtime ``growth_oom_risk`` signal and the
    ``capacity`` plan, not here.)  Silent when no budget is known (CPU)
    or the guard is off; ``warn_once_obj`` suppresses repeated prints
    per model (the audit-warning discipline)."""
    mode = guard_mode()
    if mode == "off":
        return
    budget, src = device_budget()
    if budget is None or total <= budget:
        return
    msg = (
        f"stateright-tpu-torch: capacity guard: {context}: analytic "
        f"steady footprint {fmt_bytes(total)} exceeds the device budget "
        f"{fmt_bytes(budget)} ({src}); shrink capacity=/queue_capacity= "
        "or run the `capacity` verb for a plan (docs/telemetry.md)"
    )
    if mode == "error":
        raise CapacityError(msg)
    if warn_once_obj is not None:
        if getattr(warn_once_obj, "_capacity_warn_printed", False):
            return
        try:
            object.__setattr__(warn_once_obj, "_capacity_warn_printed", True)
        except Exception:  # noqa: BLE001 - __slots__ models
            pass
    print(msg, file=sys.stderr)


def snapshot_fits_guard(snap: dict, context: str) -> None:
    """Resume-time guard (rides ``_check_snapshot_sig``): the snapshot's
    recorded analytic footprint (``footprint_bytes``, written by the
    manifest satellite; summed array bytes for older snapshots) must fit
    the target device — warn/flag-gated-error BEFORE any compile."""
    mode = guard_mode()
    if mode == "off":
        return
    budget, src = device_budget()
    if budget is None:
        return
    total = snap.get("footprint_bytes")
    if total is None:
        # the hot tier only: the spill_* arrays are host-resident tier
        # contents and never compete for device memory
        total = sum(
            int(v.nbytes) for k, v in snap.items()
            if isinstance(v, np.ndarray) and not str(k).startswith("spill_")
        )
    total = int(total)
    if total <= budget:
        return
    msg = (
        f"stateright-tpu-torch: capacity guard: {context}: the resume "
        f"snapshot's footprint {fmt_bytes(total)} exceeds this device's "
        f"budget {fmt_bytes(budget)} ({src}) — the resumed run cannot "
        "hold the snapshot"
    )
    if mode == "error":
        raise CapacityError(msg)
    print(msg, file=sys.stderr)
