"""The sweep wavefront engine: one GPU BFS per shape cohort, every
instance at once, over a shared visited table namespaced per instance.

The port's counterpart of ``stateright_tpu/sweep/engine.py``
(``_build_sweep_engine`` :94, ``SweepChecker`` :457, ``SweepInstanceView``
:1265).  A sibling of ``parallel/wavefront.py::_Engine``: the same FIFO
queue, bucketized table, clean-boundary growth and one stats read a block,
and the same insert (``cand_prep``, one stable sort, ``bucket_plan``,
``insert_commit``), with three differences:

 - every queue row carries an **instance tag** (the ``q_tag`` buffer,
   beside ``q_ebits``); successors inherit their parent's tag
   (``insert_commit``'s tag column), and the cohort kernels gather each
   row's per-instance constants by it (``cohort.py``);
 - fingerprints are **namespaced** per instance before they meet the
   table: ``cand_prep``'s namespace mode puts the instance's global tag in
   the LOW bits of the sort key ``mix64(fp)`` and inverts the mixer
   (``fingerprint.ns_fingerprint``), so instances never collide and parent
   chains stay inside one instance;
 - every counter is **per instance**: unique and state counts and maximum
   depth (``index_add_`` and ``scatter_reduce``), a ``[K, P]`` discovery
   matrix with per-instance first hits, and per-instance termination (all
   properties discovered, or the instance's target reached): a finished
   instance's rows are popped but not expanded, without stalling the
   cohort.

Exactness (JAX :23-36): queue appends are in table order, and the
namespace keeps an instance's key order (its tag lands in the low bits),
so a seed-0 instance's rows keep the FIFO order of its own sequential run
at the same capacities and batch, and its counts, first-hit states
(discovery traces) and parent pointers are that run's.  A nonzero seed
scrambles the high key bits: counts and verdicts are the sequential
run's, table order and traces may differ.  The per-instance depth
histogram is an exact bincount of the queue at extraction.

Like the plain engine, a block runs ``steps_per_call`` steps and every
step computes the JAX loop's ``cond`` on the device (a step after the stop
is a no-op); the host reads one packed stats tensor a block.  The cohort
kernels are either member 0's own kernels (a singleton, or a seed-only
family) or the unified graph under ``vmap``.

Deliberate differences from the JAX engine: ``engine_compiles`` (kept for
the JAX surfaces' names: the verb's summary line, the ``sweep`` records)
counts engine builds per ``(cohort, cap, qcap, batch, cand)``, since the
port compiles no step program; a lifted cohort is held to each member's
sequential run (the JAX unifier does not run on this jax).
"""

from __future__ import annotations

import json
import sys
import threading
import time
from typing import Optional

import numpy as np
import torch

from .. import convert
from ..checker.base import Checker, CheckerBuilder
from ..checker.path import Path
from ..convert import (
    S_DISC, S_HEAD, S_MAXDK, S_QDEPTH, S_QEBITS, S_QFP, S_QROWS, S_QTAG,
    S_SCNTK, S_STATUS, S_TAIL, S_TFP, S_TPL, S_UNIQK, SWEEP_QUEUE,
)
from ..core import Expectation
from ..fingerprint import MASK64, ns_fingerprint
from ..ops import _cuda
from ..ops.buckets import (
    SLOTS, PlanBuffers, bucket_insert, bucket_plan_fused, host_bucket_rehash,
)
from ..ops.cand_prep import Namespace, PrepBuffers, cand_prep
from ..ops.hashing import EMPTY, ns_hash_plain, row_hash
from ..ops.insert_commit import QueueAppend, insert_commit
from ..parallel.prewarm import CompileWatch, build_site
from ..parallel.wavefront import _i32, _pow2, resolve_device
from .cohort import build_cohorts
from .spec import SWEEP_V

_STATUS_OK = 0
_STATUS_QUEUE_FULL = 1
_STATUS_TABLE_FULL = 2
_STATUS_CAND_FULL = 3
_STATUS_POISON = 4

_STATUS_NAMES = {
    _STATUS_OK: "ok",
    _STATUS_QUEUE_FULL: "queue_full",
    _STATUS_TABLE_FULL: "table_full",
    _STATUS_CAND_FULL: "cand_full",
    _STATUS_POISON: "poison",
}

BASE = len(convert.SWEEP_SNAPSHOT_KEYS)  # the cartography tail follows
# the builder's mxu() and this knob have no effect elsewhere in the port; a
# sweep refuses them, as the JAX sweep does
ENV_MXU = "STATERIGHT_TPU_MXU"
# a target no instance reaches (JAX's sentinel for "no target")
_NO_TARGET = 1 << 62


class _SweepEngine:
    """One cohort's device program at fixed capacities (JAX
    ``_build_sweep_engine``, :94-420): :meth:`init` builds the first
    carry, :meth:`run` advances it by up to ``steps`` steps."""

    def __init__(self, cohort, cap: int, qcap: int, batch: int, steps: int,
                 cand: Optional[int], device, cartography: bool = False):
        self.cohort, self.device = cohort, device
        self.cap, self.qcap, self.batch, self.steps = cap, qcap, batch, steps
        self.cart = cartography
        self.width, self.arity, self.K = (cohort.width, cohort.max_actions,
                                          cohort.K)
        self.m = batch * self.arity
        self.eff_cand = min(cand, self.m) if cand else self.m
        self.qalloc = qcap + self.m
        self.props = cohort.props
        self.p_dim = max(len(self.props), 1)
        self.ev_idx = [i for i, p in enumerate(self.props)
                       if p.expectation is Expectation.EVENTUALLY]
        if len(self.ev_idx) > 32:
            raise ValueError("at most 32 eventually properties are supported")
        self.ebit_of = {i: e for e, i in enumerate(self.ev_idx)}
        self.init_ebits = _i32((1 << len(self.ev_idx)) - 1)
        i64 = dict(dtype=torch.int64, device=device)
        self.lanes = torch.arange(batch, **i64)
        self.cand_lanes = torch.arange(self.eff_cand, **i64)
        self.ns_low = cohort.ns_low.to(device)
        self.ns_xor = cohort.ns_xor.to(device)
        tg = cohort.targets_np.copy()
        tg[tg < 0] = _NO_TARGET
        self.targets = torch.from_numpy(tg).to(device)
        self.no_hit = torch.full((self.K,), batch, **i64)
        self.zero_k = torch.zeros((self.K,), **i64)
        twin0 = cohort.twins[0]
        self.boundary_fn = (twin0.boundary_rows
                            if getattr(twin0, "has_boundary", False) else None)
        self.poison_fn = getattr(twin0, "poison_rows", None)
        # the insert's buffers, allocated once (the step launches unchecked)
        self.prep_out = self.plan_out = self.stream = None
        if device.type == "cuda":
            self.prep_out = PrepBuffers(self.m, self.eff_cand, device)
            self.plan_out = PlanBuffers(self.eff_cand, device)
            self.stream = _cuda.stream_of(self.plan_out.tgt)

    # -- step pieces ---------------------------------------------------------

    def done_of(self, disc, uniq):
        """bool[K]: every property discovered, or the target reached."""
        tgt = uniq >= self.targets
        if not self.props:
            return tgt
        return (disc != 0).all(1) | tgt

    def _record_first_k(self, col, hit, fps, tags):
        """First hit per instance (JAX ``record_first_k`` :148):
        ``segment_min`` of the hit lanes becomes ``scatter_reduce`` with
        ``amin`` over the sentinel ``batch``, and the hit's fingerprint an
        ``index_select``: no host read."""
        order = torch.where(hit, self.lanes, self.batch)
        first = self.no_hit.scatter_reduce(0, tags, order, "amin")
        fp_first = fps.index_select(0, first.clamp(max=self.batch - 1))
        take = (first < self.batch) & (col == 0)
        return torch.where(take, fp_first, col)

    def eval_props(self, masks, fps, act, ebits, disc, tags):
        cols = list(disc.unbind(1))
        for i, p in enumerate(self.props):
            if p.expectation is Expectation.ALWAYS:
                cols[i] = self._record_first_k(cols[i], act & ~masks[:, i],
                                               fps, tags)
            elif p.expectation is Expectation.SOMETIMES:
                cols[i] = self._record_first_k(cols[i], act & masks[:, i],
                                               fps, tags)
            else:
                clear = _i32(~(1 << self.ebit_of[i]))
                ebits = torch.where(masks[:, i], ebits & clear, ebits)
        return ebits, torch.stack(cols, 1)

    def flush_terminal(self, terminal, fps, ebits, disc, tags):
        if not self.ev_idx:
            return disc
        cols = list(disc.unbind(1))
        for i in self.ev_idx:
            bit = (ebits >> self.ebit_of[i]) & 1
            cols[i] = self._record_first_k(cols[i], terminal & (bit == 1),
                                           fps, tags)
        return torch.stack(cols, 1)

    def step(self, c: list) -> list:
        """Pop one batch of every instance's rows, expand, namespace,
        insert and append (JAX ``step``, :185-318)."""
        batch, m, width, arity = self.batch, self.m, self.width, self.arity
        head, tail, status = c[S_HEAD], c[S_TAIL], c[S_STATUS]
        uniq, disc = c[S_UNIQK], c[S_DISC]
        done_k = self.done_of(disc, uniq)
        go = (status == _STATUS_OK) & (tail > head) & ~done_k.all()
        n_avail = torch.where(go, tail - head, 0)
        pos = (head + self.lanes).clamp_(max=self.qalloc - 1)
        rows = c[S_QROWS][pos]
        fps = c[S_QFP][pos]
        tags = c[S_QTAG][pos]
        ebits = c[S_QEBITS][pos]
        depths = c[S_QDEPTH][pos]
        tags64 = tags.to(torch.int64)
        live = self.lanes < n_avail

        masks = self.cohort.property_masks(rows, tags)  # [B, P]
        # a done instance's rows are popped but neither evaluated nor
        # expanded (first hits win, so its verdicts are final)
        act = live & ~done_k[tags64]
        ebits, disc = self.eval_props(masks, fps, act, ebits, disc, tags64)
        d = torch.where(act, depths, 0).to(torch.int64)
        maxd = torch.maximum(c[S_MAXDK], self.zero_k.scatter_reduce(
            0, tags64, d, "amax"))
        elive = act & ~self.done_of(disc, uniq)[tags64]

        succ, valid = self.cohort.step_rows(rows, tags)  # [B, A, W], [B, A]
        if self.boundary_fn is not None:
            valid = valid & self.boundary_fn(succ)
        valid = valid & elive[:, None]
        terminal = elive & ~valid.any(dim=-1)
        disc = self.flush_terminal(terminal, fps, ebits, disc, tags64)

        cand_rows = succ.reshape(m, width)
        pfp, ppl, cidx, key, _, coverflow = cand_prep(
            cand_rows, valid.reshape(m), fps, arity, self.eff_cand,
            self.prep_out, check=False, stream=self.stream,
            ns=Namespace(tags, self.ns_low, self.ns_xor, self.cohort.ns_bits),
        )
        skey, order = torch.sort(key, stable=True)
        tgt, cfp, cpl, sel, n_new, toverflow = bucket_plan_fused(
            c[S_TFP], pfp, ppl, skey, order, cidx, coverflow,
            self.cap // SLOTS, self.plan_out, check=False,
            stream=self.stream,
        )
        insert_commit(
            c[S_TFP], c[S_TPL], tgt, cfp, cpl, n_new,
            QueueAppend(c[S_QROWS], c[S_QFP], c[S_QEBITS], c[S_QDEPTH], tail,
                        sel, cand_rows, ebits, depths, arity,
                        tags=c[S_QTAG], parent_tags=tags),
            check=False, stream=self.stream,
        )
        # any overflow means the batch wrote nothing (n_new is 0): cursors
        # and counters stay, so it replays after the host grows
        overflow = toverflow | coverflow
        novel = (self.cand_lanes < n_new).to(torch.int64)
        ntag = tags64.index_select(0, (sel // arity).clamp(0, batch - 1))
        uniq = uniq + self.zero_k.index_add(0, ntag, novel)
        gen = valid.sum(-1)
        scnt = c[S_SCNTK] + torch.where(
            overflow, 0, self.zero_k.index_add(0, tags64, gen))
        head = torch.where(overflow, head, head + torch.clamp(n_avail,
                                                              max=batch))
        tail = tail + n_new
        if self.cart:
            zero = torch.zeros((), dtype=torch.int64, device=self.device)
            ev = act.to(torch.int64)[:, None].expand(batch, self.p_dim)
            hits = (act[:, None] & masks).to(torch.int64)
            if hits.shape[1] != self.p_dim:
                hits = torch.zeros_like(ev)
            for i, delta in enumerate((valid.to(torch.int64), ev, hits)):
                cur = c[BASE + i]
                c[BASE + i] = cur.index_add(
                    0, tags64, torch.where(overflow, zero, delta))
        new_status = torch.where(
            toverflow | (uniq.sum() * 4 > self.cap)
            | (self.eff_cand * 4 > self.cap),
            _STATUS_TABLE_FULL,
            torch.where(coverflow, _STATUS_CAND_FULL,
                        torch.where(tail > self.qcap, _STATUS_QUEUE_FULL,
                                    status)),
        )
        if self.poison_fn is not None:
            new_status = torch.where((self.poison_fn(rows) & live).any(),
                                     _STATUS_POISON, new_status)
        c[S_HEAD], c[S_TAIL], c[S_UNIQK], c[S_SCNTK] = head, tail, uniq, scnt
        c[S_DISC], c[S_MAXDK] = disc, maxd
        c[S_STATUS] = torch.where(go, new_status, status)
        return c

    def run(self, carry: list):
        """Up to ``steps`` steps (no-ops once the cohort must stop)."""
        carry = list(carry)
        for _ in range(self.steps):
            carry = self.step(carry)
        return carry, stats_of(carry)

    def init(self):
        """The first carry: the members' init rows, namespaced, inserted
        as one batch (JAX ``init_fn`` :360)."""
        dev, cap, qalloc, K = self.device, self.cap, self.qalloc, self.K
        i64 = dict(dtype=torch.int64, device=dev)
        i32 = dict(dtype=torch.int32, device=dev)
        tfp = torch.full((cap,), EMPTY, **i64)
        tpl = torch.zeros((cap,), **i64)
        qrows = torch.zeros((qalloc, self.width), **i64)
        qfp = torch.full((qalloc,), EMPTY, **i64)
        qtag = torch.zeros((qalloc,), **i32)
        qebits = torch.zeros((qalloc,), **i32)
        qdepth = torch.zeros((qalloc,), **i32)
        init_np, itags_np = self.cohort.init_data()
        n_init = init_np.shape[0]
        irows = torch.from_numpy(init_np.view(np.int64).copy()).to(dev)
        itags = torch.from_numpy(itags_np.astype(np.int64)).to(dev)
        ifp = ns_hash_plain(row_hash(irows), self.ns_low[itags],
                            self.ns_xor[itags], self.cohort.ns_bits)
        tfp, tpl, sel, n_new, overflow, _ = bucket_insert(
            tfp, tpl, ifp, torch.zeros((n_init,), **i64))
        qrows[:n_init] = irows[sel]
        qfp[:n_init] = ifp[sel]
        qtag[:n_init] = itags[sel].to(torch.int32)
        qebits[:n_init] = self.init_ebits
        novel = (torch.arange(n_init, **i64) < n_new).to(torch.int64)
        uniq = torch.zeros((K,), **i64).index_add(0, itags[sel], novel)
        scnt = torch.bincount(itags, minlength=K).to(torch.int64)
        status = torch.where(
            overflow | (n_new * 4 > cap) | (self.eff_cand * 4 > cap),
            _STATUS_TABLE_FULL,
            torch.where(n_new > self.qcap, _STATUS_QUEUE_FULL, _STATUS_OK),
        )
        zero = torch.zeros((), **i64)
        carry = [tfp, tpl, qrows, qfp, qtag, qebits, qdepth, zero, n_new,
                 uniq, scnt, torch.zeros((K, self.p_dim), **i64),
                 torch.zeros((K,), **i64), status]
        if self.cart:
            carry += cart_zeros(self.cohort, dev)
        return carry, stats_of(carry)


def cart_zeros(cohort, device) -> list:
    """The per-instance cartography counters, zeroed: action histogram
    ``[K, A]``, property evaluations and hits ``[K, P]``."""
    i64 = dict(dtype=torch.int64, device=device)
    p_dim = max(cohort.n_props, 1)
    return [torch.zeros((cohort.K, max(cohort.max_actions, 1)), **i64),
            torch.zeros((cohort.K, p_dim), **i64),
            torch.zeros((cohort.K, p_dim), **i64)]


def stats_of(carry: list) -> torch.Tensor:
    """Every value the host loop reads, packed into one int64 tensor (JAX
    ``stats_of`` :327): ``[head, tail, status, unique_k, scount_k,
    maxdepth_k, disc, cartography...]``; the cartography counters are the
    carry's tail past :data:`BASE`, when it has one."""
    parts = [torch.stack([carry[S_HEAD], carry[S_TAIL], carry[S_STATUS]]),
             carry[S_UNIQK], carry[S_SCNTK], carry[S_MAXDK],
             carry[S_DISC].reshape(-1)]
    parts += [t.reshape(-1) for t in carry[BASE:]]
    return torch.cat(parts)


class InstanceResult:
    """One instance's outcome in a joined sweep (JAX :426): JSON-safe
    scalars, the discovery fingerprints and their walked chains."""

    def __init__(self, instance, global_index, cohort_index):
        self.key = instance.key
        self.params = dict(instance.params)
        self.seed = instance.seed
        self.target = instance.target
        self.global_index = int(global_index)
        self.cohort = int(cohort_index)
        self.unique = 0
        self.states = 0
        self.max_depth = 0
        self.disc = np.zeros(0, np.uint64)
        self.chains: dict = {}  # property name -> namespaced fp chain
        self.cartography: Optional[dict] = None


class SweepChecker(Checker):
    """One GPU run checking a whole model family (JAX :457).

    Spawned by ``CheckerBuilder.sweep(SPEC).spawn_gpu(...)``: the cohorts
    run one after the other, each as one engine; every instance's counts,
    verdicts and traces are extracted at its cohort's end; with a run
    registry, one record per instance goes in under this sweep's
    ``sweep_id``.  ``device=None`` means ``cuda`` and raises without one.
    ``sync=True`` runs the cohorts on the caller's thread (JAX :478).
    """

    _engine_tag = "sweep"  # the snapshot's engine word, as JAX writes it
    _telemetry_tag = _report_engine = "gpu-sweep"

    def __init__(self, options: CheckerBuilder, spec,
                 capacity: int = 1 << 17, batch: Optional[int] = None,
                 queue_capacity: Optional[int] = None,
                 steps_per_call: int = 64, cand: Optional[int] = None,
                 device=None, resume: Optional[dict] = None,
                 sync: bool = False):
        self._reject_unsupported(options)
        self.device = resolve_device(device)
        self.model = options.model
        self.spec = spec
        self._options = options
        self._cap = max(_pow2(capacity), 4 * SLOTS)
        self._batch = max(8, batch or (1 << 11))
        self._cand = cand or max(4 * self._batch, 4096)
        self._qcap = queue_capacity or max(self._cap // 2, 4 * self._batch)
        self._steps = steps_per_call
        self._resume = resume
        self._telemetry_opts = options.telemetry_opts or {}
        self._cartography = bool(self._telemetry_opts.get("cartography"))
        self._report_path = options.report_path
        self._run_dir = options.run_dir
        self._span_parent = getattr(options, "_span_ctx", None)
        self.flight_recorder = options._make_recorder(self._telemetry_tag)
        t0 = time.monotonic()
        self.cohorts = build_cohorts(spec, self.device)
        self.cohort_build_secs = time.monotonic() - t0
        self.results: dict = {}
        for ci, cohort in enumerate(self.cohorts):
            for t, inst in enumerate(cohort.instances):
                self.results[inst.key] = InstanceResult(
                    inst, cohort.global_index[t], ci)
        self.engine_compiles = 0
        self._pending_compile = None  # the compile event a call may amend
        self.growth_events: list = []
        self.steps_run = 0  # device steps issued, post-stop no-ops included
        self._instance_run_ids: dict = {}
        self._done = threading.Event()
        self._stop = threading.Event()
        self._ckpt_req = threading.Event()
        self._ckpt_ready = threading.Event()
        self._ckpt_out: Optional[dict] = None
        self._ckpt_lock = threading.Lock()
        self._live = (0, 0)
        self._timed_out = False
        self._run_error: Optional[BaseException] = None
        self._cart_depth_base: Optional[np.ndarray] = None
        if resume is not None:
            self._check_resume_sig(resume)
        if options.timeout_secs is not None:
            timer = threading.Timer(options.timeout_secs, self._deadline_stop)
            timer.daemon = True
            timer.start()
        self._thread: Optional[threading.Thread] = None
        if sync:  # JAX :526-531: the caller's thread, report before return
            self._run_guarded()
            if self._run_error is not None:
                err, self._run_error = self._run_error, None
                raise err
            self._maybe_write_report()
        else:
            self._thread = threading.Thread(target=self._run_guarded,
                                            daemon=True)
            self._thread.start()

    # -- configuration fences ------------------------------------------------

    @staticmethod
    def _reject_unsupported(options: CheckerBuilder) -> None:
        """The modes a sweep does not compose with yet (JAX :541)."""
        from ..parallel._base import (
            ENV_POR, ENV_PREDEDUP, ENV_SPILL, resolve_flag,
        )

        rejects = []
        if options.checked_mode:
            rejects.append("checked()")
        if resolve_flag(getattr(options, "por_mode", None), ENV_POR):
            rejects.append("por()")
        if resolve_flag(getattr(options, "spill_mode", None), ENV_SPILL):
            rejects.append("spill()")
        if resolve_flag(getattr(options, "prededup_mode", None),
                        ENV_PREDEDUP):
            rejects.append("prededup()")
        if resolve_flag(getattr(options, "mxu_mode", None), ENV_MXU):
            rejects.append("mxu()")
        if options.symmetry_fn is not None:
            rejects.append("symmetry()")
        if options.visitor_obj is not None:
            rejects.append("visitor()")
        if getattr(options, "autosave_opts", None) is not None:
            rejects.append("autosave()")
        if rejects:
            raise NotImplementedError(
                "sweep mode does not compose with " + "/".join(rejects)
                + " yet: run those per instance on the plain GPU engine")

    def _deadline_stop(self) -> None:
        if not self._done.is_set():
            self._timed_out = True
        self._stop.set()

    @property
    def timed_out(self) -> bool:
        return self._timed_out

    # -- resume protocol -----------------------------------------------------

    def _sweep_sig(self) -> np.ndarray:
        """The sweep's identity for resume (JAX ``_sweep_sig`` :589, the
        same digest for the same spec): per instance its key, namespace,
        init fingerprints and twin shape."""
        import hashlib

        src = []
        for cohort in self.cohorts:
            for t, inst in enumerate(cohort.instances):
                fps = sorted(int(inst.model.fingerprint_state(s))
                             for s in inst.model.init_states())
                src.append([inst.key, cohort.global_index[t], inst.seed,
                            cohort.ns_bits, fps, cohort.width,
                            cohort.max_actions, cohort.n_props])
        digest = hashlib.sha256(
            json.dumps(src, sort_keys=True).encode()).digest()[:8]
        return np.frombuffer(digest, np.uint64).copy()

    def _check_resume_sig(self, snap: dict) -> None:
        tag = str(np.asarray(snap.get("engine", "single")).item())
        if tag != self._engine_tag:
            raise ValueError(
                f"resume snapshot was taken by the {tag!r} engine; this is "
                "the sweep engine")
        if not np.array_equal(self._sweep_sig(),
                              np.asarray(snap["model_sig"]).reshape(-1)):
            raise ValueError(
                "resume snapshot was taken from a different sweep (instance "
                "keys / namespaces / layouts disagree)")
        rid = snap.get("run_id")
        if rid is not None and self.parent_run_id is None:
            self.parent_run_id = str(np.asarray(rid).item())

    # -- snapshots -----------------------------------------------------------

    def _carry_to_snapshot(self, carry, ci, cap, qcap, cand) -> dict:
        """The JAX sweep snapshot (:636): the carry in the JAX layout,
        capacities, the cohort index, the sweep's identity, and the
        finished cohorts' results as a JSON manifest."""
        snap = dict(zip(convert.SWEEP_SNAPSHOT_KEYS,
                        convert.sweep_carry_to_arrays(carry)))
        snap["cap"], snap["qcap"] = cap, qcap
        snap["batch"], snap["cand"] = self._batch, cand
        snap["cohort"] = np.int64(ci)
        snap["engine"] = "sweep"
        snap["model_sig"] = self._sweep_sig()
        snap["run_id"] = self.run_id
        done = {}
        for ck in range(ci):
            for inst in self.cohorts[ck].instances:
                r = self.results[inst.key]
                done[inst.key] = {
                    "unique": int(r.unique), "states": int(r.states),
                    "max_depth": int(r.max_depth),
                    "disc": [int(x) for x in np.asarray(r.disc)],
                    "chains": {k: [int(f) for f in v]
                               for k, v in r.chains.items()},
                    "cartography": r.cartography,
                }
        snap["sweep_done"] = json.dumps(done)
        if self._cartography and self._cart_depth_base is not None:
            snap["cart_depth_base"] = self._cart_depth_base.copy()
        return snap

    def checkpoint(self, timeout: Optional[float] = 60.0) -> dict:
        """A snapshot, taken at the next host sync mid-run, or the final
        one; resume with ``sweep(spec).spawn_gpu(resume=...)`` or the JAX
        sweep's ``spawn_tpu(resume=...)``."""
        if self._done.is_set():
            return self.final_snapshot()
        with self._ckpt_lock:
            self._ckpt_ready.clear()
            self._ckpt_req.set()
            deadline = None if timeout is None else time.monotonic() + timeout
            while not self._ckpt_ready.wait(0.2):
                if self._done.is_set():
                    self._ckpt_req.clear()
                    return self.final_snapshot()
                if deadline is not None and time.monotonic() > deadline:
                    self._ckpt_req.clear()
                    raise TimeoutError("checkpoint request not served")
            out, self._ckpt_out = self._ckpt_out, None
        return out

    def stop(self) -> "SweepChecker":
        self._stop.set()
        return self

    # -- run loop ------------------------------------------------------------

    def _run_guarded(self) -> None:
        from ..telemetry.spans import start_span

        rec = self.flight_recorder
        sp = None
        if rec is not None:
            sp = start_span("engine_run", parent=self._span_parent)
            rec.bind_span(sp.ctx.span_id)
        try:
            self._run()
        except BaseException as e:  # noqa: BLE001 - re-raised at join()
            self._run_error = e
        finally:
            if sp is not None:
                sp.end(rec, engine=self._telemetry_tag,
                       error=(type(self._run_error).__name__
                              if self._run_error else None))
                rec.bind_span(None)
            self._done.set()

    def _restore_done(self, snap: dict) -> None:
        done = json.loads(str(np.asarray(snap["sweep_done"]).item()))
        for key, d in done.items():
            r = self.results[key]
            r.unique, r.states = d["unique"], d["states"]
            r.max_depth = d["max_depth"]
            r.disc = np.asarray(d["disc"], np.uint64)
            r.chains = {k: list(v) for k, v in d["chains"].items()}
            r.cartography = d.get("cartography")

    def _run(self) -> None:
        rec = self.flight_recorder
        start_ci = 0
        resume = None
        if self._resume is not None:
            resume = self._resume
            start_ci = int(np.asarray(resume["cohort"]))
            self._restore_done(resume)
            self._batch = int(resume.get("batch", self._batch))
        for ci in range(start_ci, len(self.cohorts)):
            if self._stop.is_set():
                break
            self._run_cohort(ci, resume=resume if ci == start_ci else None)
        if rec is not None:
            rec.record("sweep", v=SWEEP_V, event="summary",
                       instances=len(self.spec), cohorts=len(self.cohorts),
                       engine_compiles=int(self.engine_compiles))
            rec.close_run(done=not self._timed_out)

    def _engine(self, ci, cap, qcap, batch, cand,
                kind: str = "growth") -> _SweepEngine:
        key = (ci, cap, qcap, batch, cand)
        eng = self._engine_cache.get(key)
        if eng is not None:
            return eng
        cohort = self.cohorts[ci]
        rec = self.flight_recorder
        self.engine_compiles += 1
        ev = None
        if rec is not None:
            ev = rec.record("compile", cap=cap, qcap=qcap, batch=batch,
                            cand=cand, rung=kind, source="fresh",
                            cache_hit=False, prewarm_ready=False,
                            duration=0.0, build_secs=0.0)
            rec.record("sweep", v=SWEEP_V, event="cohort_compile", cohort=ci,
                       instances=cohort.K, width=cohort.width,
                       arity=cohort.max_actions,
                       unified=bool(cohort.unified and cohort.K > 1))
        t0 = time.perf_counter()
        with build_site():
            eng = _SweepEngine(cohort, cap, qcap, batch, self._steps, cand,
                               self.device, cartography=self._cartography)
        secs = round(time.perf_counter() - t0, 6)
        if rec is not None:
            # the measured build (JAX :777); the first block that pays the
            # kernel library's build or load amends it (:meth:`_call`)
            rec.amend(ev, duration=secs, build_secs=secs)
            rec.add("stage_compile_secs", secs)
        self._pending_compile = ev
        self._engine_cache[key] = eng
        return eng

    def _call(self, fn, *args):
        """``fn(*args)`` (an engine's ``init`` or ``run``) with the stats
        on the host; the kernel library's build or load paid inside it
        amends the pending ``compile`` event (JAX ``_timed_call``)."""
        watch = CompileWatch()
        carry, stats = fn(*args)
        d = watch.delta()
        prev, rec = self._pending_compile, self.flight_recorder
        if prev is not None and rec is not None:
            comp = max(d["compile_secs"], 0.0)
            rec.add("stage_compile_secs", comp)
            if comp > 0:
                hit = d["persistent_hits"] > 0
                rec.amend(prev,
                          duration=round(prev["duration"] + comp, 6),
                          build_secs=round(prev["build_secs"] + comp, 6),
                          cache_hit=hit,
                          source="persistent" if hit else "fresh")
            else:
                self._pending_compile = None
        return carry, stats.cpu().numpy()

    def _grow(self, carry_np, ci, cap, qcap, batch, status, cand):
        """Clean-boundary growth (JAX ``_grow`` :827): rehash the table on
        table-full, reclaim the popped queue prefix (its per-instance depth
        lanes banked when cartography is on) and double the queue while
        still needed; ``carry_np`` is the JAX-layout numpy carry."""
        cohort = self.cohorts[ci]

        def table_small():
            return int(np.sum(carry_np[S_UNIQK])) * 4 > cap or cand * 4 > cap

        if table_small() or status == _STATUS_TABLE_FULL:
            if table_small():
                while table_small():
                    cap *= 2
            else:
                cap *= 2
            carry_np[S_TFP], carry_np[S_TPL] = host_bucket_rehash(
                carry_np[S_TFP], carry_np[S_TPL], cap // SLOTS)
        head, tail = int(carry_np[S_HEAD]), int(carry_np[S_TAIL])
        pending = tail - head
        self._bank_depth(carry_np[S_QDEPTH], carry_np[S_QTAG], head)
        for i in SWEEP_QUEUE:
            carry_np[i] = np.asarray(carry_np[i])[head:tail].copy()
        carry_np[S_HEAD] = np.int32(0)
        carry_np[S_TAIL] = np.int32(pending)
        while pending * 2 > qcap:
            qcap *= 2
        carry_np[S_STATUS] = np.int32(_STATUS_OK)
        convert.repad_queue(carry_np, qcap + batch * cohort.max_actions,
                            SWEEP_QUEUE, S_QFP)
        return cap, qcap, carry_np

    def _bank_depth(self, qdepth, qtag, n: int) -> None:
        """Bank the popped prefix's per-instance depth lanes (cartography
        only): the final histograms are queue-derived, and a growth drops
        that prefix."""
        if not self._cartography or n <= 0:
            return
        from ..ops.cartography import DEPTH_BINS

        dep = np.minimum(np.asarray(qdepth[:n], np.int64), DEPTH_BINS - 1)
        tag = np.asarray(qtag[:n], np.int64)
        np.add.at(self._cart_depth_base, (tag, dep), 1)

    def _run_cohort(self, ci: int, resume: Optional[dict] = None) -> None:
        """One cohort from its init rows (or a snapshot) to its end (JAX
        ``_run_cohort`` :893)."""
        cohort = self.cohorts[ci]
        rec = self.flight_recorder
        cap, qcap, batch = self._cap, self._qcap, self._batch
        arity = cohort.max_actions
        cand = min(self._cand, batch * arity)
        while cand * 4 > cap:
            cap *= 2
        n_init = cohort.init_data()[0].shape[0]
        while n_init > qcap:
            qcap *= 2
        self._engine_cache: dict = {}
        if self._cartography:
            from ..ops.cartography import DEPTH_BINS

            self._cart_depth_base = np.zeros((cohort.K, DEPTH_BINS), np.int64)
        stats = None
        if resume is not None:
            cap, qcap = int(resume["cap"]), int(resume["qcap"])
            cand = int(resume.get("cand", cand))
            if self._cartography and "cart_depth_base" in resume:
                self._cart_depth_base = np.array(
                    resume["cart_depth_base"], np.int64)
            carry_np = [np.asarray(resume[k])
                        for k in convert.SWEEP_SNAPSHOT_KEYS]
            st = int(carry_np[S_STATUS])
            if st != _STATUS_OK:
                if st == _STATUS_CAND_FULL:
                    cand = min(cand * 2, batch * arity)
                cap, qcap, carry_np = self._grow(carry_np, ci, cap, qcap,
                                                 batch, st, cand)
            carry = convert.sweep_carry_from_arrays(
                carry_np, self.device, qcap + batch * arity)
            if self._cartography:
                # the step tallies restart at a resume (JAX :932-941)
                carry += cart_zeros(cohort, self.device)
        else:
            while True:
                carry, stats = self._call(self._engine(
                    ci, cap, qcap, batch, cand, kind="init").init)
                if int(stats[2]) != _STATUS_TABLE_FULL:
                    break
                prev = cap
                while n_init * 4 > cap or cand * 4 > cap:
                    cap *= 2
                if cap == prev:
                    cap *= 2
        k_dim, p_dim = cohort.K, max(cohort.n_props, 1)
        while True:
            if stats is None:
                stats = stats_of(carry).cpu().numpy()
            head, tail, status = (int(x) for x in stats[:3])
            o = 3
            uniq_k = stats[o:o + k_dim].astype(np.int64)
            o += k_dim
            scnt_k = stats[o:o + k_dim].astype(np.int64)
            o += k_dim
            maxd_k = stats[o:o + k_dim].astype(np.int64)
            o += k_dim
            disc2 = stats[o:o + k_dim * p_dim].view(np.uint64).reshape(
                k_dim, p_dim)
            others = [r for r in self.results.values() if r.cohort != ci]
            tot_u = int(uniq_k.sum()) + sum(r.unique for r in others)
            tot_s = int(scnt_k.sum()) + sum(r.states for r in others)
            self._live = (tot_s, tot_u)
            if rec is not None:
                rec.add_bytes(d2h=stats.nbytes)
                rec.step(engine=self._telemetry_tag, states=tot_s,
                         unique=tot_u, status=status,
                         queue=max(tail - head, 0), cap=cap, cand=cand,
                         load_factor=round(int(uniq_k.sum()) / cap, 6))
            if self._ckpt_req.is_set():
                self._ckpt_out = self._carry_to_snapshot(carry, ci, cap, qcap,
                                                         cand)
                self._ckpt_req.clear()
                self._ckpt_ready.set()
            if status == _STATUS_POISON:
                raise RuntimeError(
                    "poisoned rows reached by a sweep instance: a compiled "
                    "transition crossed its compile-time state_bound/"
                    "env_bound; loosen the bounds")
            if status != _STATUS_OK:
                self.growth_events.append((status, tot_u))
                if rec is not None:
                    rec.record("growth",
                               status=_STATUS_NAMES.get(status, str(status)),
                               unique=tot_u, cap=cap, qcap=qcap, cand=cand)
                cart_tail = list(carry[BASE:])
                carry_np = convert.sweep_carry_to_arrays(carry)
                if status == _STATUS_CAND_FULL:
                    cand = min(cand * 2, batch * arity)
                    carry_np[S_STATUS] = np.int32(_STATUS_OK)
                    while cand * 4 > cap:
                        cap, qcap, carry_np = self._grow(
                            carry_np, ci, cap, qcap, batch,
                            _STATUS_TABLE_FULL, cand)
                else:
                    cap, qcap, carry_np = self._grow(carry_np, ci, cap, qcap,
                                                     batch, status, cand)
                carry = convert.sweep_carry_from_arrays(
                    carry_np, self.device) + cart_tail
                stats = None
                continue
            if self._stop.is_set():
                break
            if tail <= head or bool(np.all(self._done_k_np(
                    cohort, disc2, uniq_k))):
                break
            # the block's one host sync
            carry, stats = self._call(
                self._engine(ci, cap, qcap, batch, cand).run, carry)
            self.steps_run += self._steps
        self._extract_cohort(ci, carry, uniq_k, scnt_k, maxd_k, disc2, cap,
                             qcap, cand)

    @staticmethod
    def _done_k_np(cohort, disc2, uniq_k) -> np.ndarray:
        tgt = cohort.targets_np.copy()
        tgt[tgt < 0] = _NO_TARGET
        done = uniq_k >= tgt
        if cohort.n_props:
            done = done | np.all(disc2 != 0, axis=1)
        return done

    def _extract_cohort(self, ci, carry, uniq_k, scnt_k, maxd_k, disc2, cap,
                        qcap, cand) -> None:
        """Per-instance results at the cohort's end (JAX
        ``_extract_cohort`` :1061): counters, discovery chains (walked now,
        while the table exists) and, with cartography, each instance's
        counters with the exact depth bincount of its queue lanes."""
        cohort = self.cohorts[ci]
        rec = self.flight_recorder
        arrs = convert.sweep_carry_to_arrays(carry)
        tfp, tpl = arrs[S_TFP], arrs[S_TPL]
        occ = tfp != np.uint64(MASK64)
        parents = dict(zip(tfp[occ].tolist(), tpl[occ].tolist()))
        self._last_cohort = (arrs, ci, cap, qcap, cand)
        if self._cartography:
            from ..ops.cartography import DEPTH_BINS, snapshot

            tail = int(arrs[S_TAIL])
            dep = np.minimum(arrs[S_QDEPTH][:tail].astype(np.int64),
                             DEPTH_BINS - 1)
            tag = arrs[S_QTAG][:tail].astype(np.int64)
            dh = self._cart_depth_base.copy()
            np.add.at(dh, (tag, dep), 1)
            act_hist, p_evals, p_hits = (t.cpu().numpy()
                                         for t in carry[BASE:BASE + 3])
        p_dim = max(cohort.n_props, 1)
        for t, inst in enumerate(cohort.instances):
            r = self.results[inst.key]
            r.unique, r.states = int(uniq_k[t]), int(scnt_k[t])
            r.max_depth = int(maxd_k[t])
            r.disc = disc2[t].astype(np.uint64).copy()
            for i, p in enumerate(cohort.props):
                fp = int(r.disc[i])
                if fp != 0:
                    chain = [fp]
                    while True:
                        par = parents.get(chain[-1], 0)
                        if par == 0:
                            break
                        chain.append(par)
                    chain.reverse()
                    r.chains[p.name] = chain
            if self._cartography:
                r.cartography = snapshot(
                    depth_hist=dh[t], action_hist=act_hist[t],
                    prop_evals=p_evals[t][:p_dim],
                    prop_hits=p_hits[t][:p_dim],
                    prop_names=[p.name for p in cohort.props],
                    states=r.states, unique=r.unique)
            if rec is not None:
                rec.record("sweep", v=SWEEP_V, event="instance_done",
                           key=inst.key, unique=r.unique, states=r.states,
                           depth=r.max_depth)

    # -- result surface ------------------------------------------------------

    def is_done(self) -> bool:
        return self._done.is_set()

    def join(self) -> "SweepChecker":
        if self._thread is not None:
            self._thread.join()
        if self._run_error is not None:
            raise self._run_error
        self._maybe_write_report()
        return self

    def state_count(self) -> int:
        if self._done.is_set():
            return sum(r.states for r in self.results.values())
        return self._live[0]

    def unique_state_count(self) -> int:
        if self._done.is_set():
            return sum(r.unique for r in self.results.values())
        return self._live[1]

    def max_depth(self) -> int:
        if not self._done.is_set():
            return 0
        return max((r.max_depth for r in self.results.values()), default=0)

    def discoveries(self) -> dict:
        """Every instance's discoveries, keyed ``"<instance key>:
        <property>"``; one instance's: :meth:`instance_discoveries`."""
        self.join()
        out = {}
        for key in self.results:
            for name, path in self.instance_discoveries(key).items():
                out[f"{key}: {name}"] = path
        return out

    def instance_result(self, key: str) -> InstanceResult:
        self.join()
        return self.results[key]

    def _ns_key(self, key: str):
        """The host fingerprint of a state as the instance's namespaced
        device fingerprint (``Path.from_fingerprints(key=...)``)."""
        r = self.results[key]
        inst = self.spec.instances[r.global_index]
        bits = self.cohorts[r.cohort].ns_bits
        model, tag, seed = inst.model, r.global_index, inst.seed
        return lambda s: ns_fingerprint(model.fingerprint_state(s), tag, seed,
                                        bits)

    def instance_discoveries(self, key: str) -> dict:
        self.join()
        r = self.results[key]
        inst = self.spec.instances[r.global_index]
        return {name: Path.from_fingerprints(inst.model, list(chain),
                                             key=self._ns_key(key))
                for name, chain in r.chains.items()}

    def instance_view(self, key: str) -> "SweepInstanceView":
        """A checker-shaped view of one instance: what the report, the run
        registry and the diff read."""
        self.join()
        return SweepInstanceView(self, key)

    def final_snapshot(self) -> dict:
        """The last finished cohort's final state (the JAX
        ``_final_snapshot``)."""
        if not hasattr(self, "_last_cohort"):
            if self._run_error is not None:
                raise self._run_error
            raise RuntimeError("sweep has no snapshot: the run failed before "
                               "completing a cohort")
        arrs, ci, cap, qcap, cand = self._last_cohort
        carry = convert.sweep_carry_from_arrays(arrs, "cpu")
        return self._carry_to_snapshot(carry, ci, cap, qcap, cand)

    def instance_run_id(self, key: str) -> str:
        rid = self._instance_run_ids.get(key)
        if rid is None:
            import uuid

            rid = self._instance_run_ids[key] = uuid.uuid4().hex[:16]
        return rid

    def _maybe_record_run(self, body=None) -> None:
        """One registry record PER INSTANCE, tagged with this sweep's
        ``sweep_id`` and the member's ``instance_key`` (JAX :1222)."""
        if self._run_recorded or self._report_reentry:
            return
        from ..telemetry.registry import resolve_run_dir

        root = resolve_run_dir(self._run_dir)
        if not root:
            return
        self._run_recorded = True
        try:
            from ..telemetry.registry import RunRegistry
            from ..telemetry.report import build_report, identity_doc

            reg = RunRegistry(root)
            for key in self.results:
                view = self.instance_view(key)
                doc = identity_doc(view, build_report(view))
                doc["sweep_id"] = self.run_id
                doc["instance_key"] = key
                # a fleet-packed cohort (``fleet/``) tags its members with
                # the campaign; the instance key is the tenant's job key
                cid = getattr(self, "_campaign_id", None)
                if cid:
                    doc["campaign_id"] = str(cid)
                    doc["job_key"] = key
                reg.record_doc(doc)
        except Exception as e:  # noqa: BLE001 - the ledger never breaks a join
            print("stateright-tpu-torch: sweep registry write failed: "
                  f"{type(e).__name__}: {e}", file=sys.stderr)


class SweepInstanceView:
    """A checker-shaped view of one instance of a joined sweep (JAX
    :1265): the surface ``telemetry/report.build_report`` and
    ``build_config`` read, so an instance archives and diffs like a run of
    its own (``config.instance.sig`` is the same model's sequential run's;
    the ``sweep`` flag and the engine are deltas of class identical)."""

    _report_engine = "gpu-sweep"
    _is_sweep_instance = True
    flight_recorder = None
    parent_run_id = None
    timed_out = False

    def __init__(self, sweep: SweepChecker, key: str):
        self._sweep = sweep
        self._result = sweep.results[key]
        inst = sweep.spec.instances[self._result.global_index]
        self.model = inst.model
        self.tensor = inst.model._tensor_cached()
        self.device = sweep.device
        self._target = inst.target
        self.key = key
        # the archived config says cartography iff the sweep carried it
        self._cartography = bool(sweep._cartography)

    @property
    def run_id(self) -> str:
        return self._sweep.instance_run_id(self.key)

    def is_done(self) -> bool:
        return self._sweep.is_done()

    def state_count(self) -> int:
        return self._result.states

    def unique_state_count(self) -> int:
        return self._result.unique

    def max_depth(self) -> int:
        return self._result.max_depth

    def discoveries(self) -> dict:
        return self._sweep.instance_discoveries(self.key)

    def cartography(self) -> Optional[dict]:
        c = self._result.cartography
        return dict(c) if c else None
