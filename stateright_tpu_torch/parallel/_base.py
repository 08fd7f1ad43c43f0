"""Host-side surface shared by the port's device wavefront engines.

The port's counterpart of ``stateright_tpu/parallel/_base.py``
(``WavefrontChecker``), shared by the single-device and the sharded
engines (the sharded one refuses ``.spill()``, as JAX's does): resolve the
model's tensor twin (and, under ``symmetry()``, check that it has a
vectorized canonicalizer), resolve ``prededup()``, ``por()`` (its plan,
or the fallback) and ``spill()`` against their env knobs and arm the
spill tier, take ``checked()``,
check that host and device fingerprints agree,
run the engine on a background thread (exceptions re-raise at
:meth:`join`), or with ``sync=True`` on the caller's thread (JAX
``parallel/_base.py:354-361``: the report is written before the spawn
returns, and an exception raises there), honour the CheckerBuilder's
``timeout`` and :meth:`stop` with a cooperative stop at the next host
sync, serve a live :meth:`checkpoint` (the Explorer's
:meth:`live_discoveries` asks for one) and the autosave cadence there
(``checkpoint.py``), and rebuild discovery
traces on the host from the table's parent fingerprints, replayed through
the object model (``Path.from_fingerprints``, with the class-matching key
under symmetry).

**Telemetry** (JAX ``parallel/_base.py:196-335``): the builder's
``telemetry()`` options attach a flight recorder
(``checker.flight_recorder``), the memory ledger (``memory()``), the
cartography counters (``cartography()``) and the scoped profiler; the run
executes inside an ``engine_run`` span; the run report and the run
registry are written at the first :meth:`join` after completion
(``Checker._maybe_write_report``).  None of it adds a device operation
to a block, and cartography's few reductions ride the same stats read.

**The checkpoint protocol** (JAX ``parallel/_base.py:606-772``): the
caller thread raises a request and waits on an event; the engine thread
serves it at its next host sync, right after the block's one stats read
and before a growth event, by building the snapshot itself (the caller
never reads a device tensor).  A snapshot taken at a growth boundary
carries ``status != OK``, and resume re-applies the growth.  With no
request and autosave off, the sync adds no device read.

**Supervision** (JAX ``parallel/_base.py:231-268``, :686-695): the
supervisor (``supervisor.py``) hands its trail to the run through the
builder (``_supervise_restarts``, ``_supervise_degradations``: the
durability block and the autosave manifests carry them) and parents the
``engine_run`` span under its ``attempt`` span (``_span_ctx``).  With
autosave armed, a :class:`~..checkpoint.ProgressHeartbeat` beats at every
host sync that reaches the autosave seam, and once more with the run's
end (``done`` or ``failed``).  An injected fault at the autosave seam
(``snapshot_write``) is manufactured process death, not a failed write:
it reaches the supervisor instead of being accounted as a failure.
"""

from __future__ import annotations

import datetime
import os
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..checker.base import Checker, CheckerBuilder
from ..checker.path import Path
from ..checkpoint import (
    CKPT_V,
    AutosaveService,
    ProgressHeartbeat,
    resolve_autosave,
)
from ..fingerprint import MASK64
from ..ops.hashing import row_hash
from ..telemetry.spans import span, start_span
from ..testing.faults import InjectedFault

ENV_PREDEDUP = "STATERIGHT_TPU_PREDEDUP"
ENV_POR = "STATERIGHT_TPU_POR"
ENV_SPILL = "STATERIGHT_TPU_SPILL"


def resolve_flag(mode: Optional[bool], env: str) -> bool:
    """A builder flag: an explicit setting wins, else the env knob ``=1``
    decides (JAX ``parallel/prewarm.py:226``)."""
    if mode is not None:
        return bool(mode)
    return os.environ.get(env, "") == "1"


class WavefrontChecker(Checker):
    """Common host-side surface for device wavefront engines."""

    _engine_tag = "single"

    def _init_common(self, options: CheckerBuilder, sync: bool = False) -> None:
        self.model = options.model
        cached = getattr(self.model, "_tensor_cached", None)
        tensor = cached() if cached is not None else None
        if tensor is None:
            raise TypeError(
                f"{type(self.model).__name__} has no tensor form: implement "
                "tensor_model() (see parallel/tensor_model.py) or use "
                "spawn_bfs()/spawn_dfs()"
            )
        self._symmetry = options.symmetry_fn
        if options.symmetry_fn is not None:
            if not hasattr(tensor, "representative_rows"):
                raise NotImplementedError(
                    f"{type(tensor).__name__} has no representative_rows(): "
                    "device symmetry reduction needs a vectorized "
                    "canonicalizer (see TwoPhaseTensor.representative_rows); "
                    "use spawn_dfs()"
                )
            if not options.symmetry_is_default:
                # representative_rows mirrors state.representative(); a
                # custom symmetry_with fn would silently disagree with the
                # device dedup and break trace reconstruction
                raise NotImplementedError(
                    "the GPU engine supports .symmetry() (the "
                    "representative() protocol) only; custom symmetry_with "
                    "functions require spawn_dfs()"
                )
        if options.visitor_obj is not None:
            raise NotImplementedError(
                "per-state visitors require host materialization; use "
                "spawn_bfs() (the GPU engine never materializes states)"
            )
        self.tensor = tensor
        self._props = list(self.model.properties())
        self._target = options.target_state_count
        # JAX ``parallel/_base.py:100-108``: the builder wins over the env
        self._prededup = resolve_flag(options.prededup_mode, ENV_PREDEDUP)
        # checked mode (the sanitizer's dynamic guard) and the spill tier
        # (JAX ``parallel/_base.py:145-170``), both resolved before the
        # memory ledger, whose buffers they add to
        self._checked = bool(options.checked_mode)
        self._resolve_por(options)
        self._spill = resolve_flag(options.spill_mode, ENV_SPILL)
        if self._spill:
            if self._engine_tag != "single":
                raise NotImplementedError(
                    "spill mode (CheckerBuilder.spill()) is single-device "
                    f"only for now: the {self._engine_tag} engine's visited "
                    "table is split over its devices (ROADMAP).  Drop the "
                    "devices argument or .mesh(), or drop "
                    ".spill()/--spill/STATERIGHT_TPU_SPILL."
                )
            if self._por:
                raise NotImplementedError(
                    "spill mode does not compose with partial-order "
                    "reduction yet (the POR two-phase insert and the "
                    "Bloom deferral conflict).  Drop one of "
                    ".spill()/.por()."
                )
            self._init_spill()
        # engine prewarm and the compile cache (JAX ``parallel/_base.py:
        # 183-194``): the cache directory is process-wide (the kernel
        # library and the native module build there); the prewarmer is the
        # single-device engine's only
        from .prewarm import ENV_PREWARM, enable_persistent_compile_cache

        self._prewarm = resolve_flag(
            getattr(options, "prewarm_mode", None), ENV_PREWARM)
        self._compile_cache_dir = enable_persistent_compile_cache(
            getattr(options, "compile_cache_dir", None))
        self._prewarmer = None
        self._pending_compile_rec = None
        self._verify_fingerprint_bridge()
        self._results: Optional[dict] = None
        self._live = (0, 0, 0)  # states, unique, maxdepth at the last sync
        # the discovery fingerprints of the last sync's one stats read
        # (host numpy), which :meth:`live_discoveries` reads from another
        # thread; the lock pairs them with ``_live``
        self._live_disc: Optional[np.ndarray] = None
        self._live_lock = threading.Lock()
        self._live_cart: Optional[dict] = None
        self._parent_map: Optional[dict[int, int]] = None
        self._run_error: Optional[BaseException] = None
        self._done = threading.Event()
        # builder ``timeout()`` and :meth:`stop`: a cooperative stop at the
        # next host sync
        self._stop = threading.Event()
        # a live checkpoint request, served by the engine thread; the lock
        # serializes concurrent callers, which share the request, ready
        # and result slots
        self._ckpt_req = threading.Event()
        self._ckpt_ready = threading.Event()
        self._ckpt_out: Optional[dict] = None
        self._ckpt_lock = threading.Lock()
        self._init_telemetry(options)
        # the supervision trail (supervisor.py), when a supervisor drives
        # the run
        self._restarts = int(getattr(options, "_supervise_restarts", 0) or 0)
        self._degradations = list(
            getattr(options, "_supervise_degradations", None) or [])
        self._autosave: Optional[AutosaveService] = None
        self._autosave_config: Optional[dict] = None  # build_config, cached
        self._heartbeat: Optional[ProgressHeartbeat] = None
        aopts = resolve_autosave(options.autosave_opts)
        if aopts is not None:
            self._autosave = AutosaveService(
                aopts["dir"], aopts["every_secs"], aopts["keep"],
                recorder=self.flight_recorder)
            self._heartbeat = ProgressHeartbeat(aopts["dir"], meta={
                "engine": self._telemetry_tag,
                "model": type(self.model).__name__, "pid": os.getpid()})
        self._refresh_durability()
        # (snapshot seconds, write seconds) of each autosave generation
        self.autosave_secs: list = []
        self._timed_out = False
        if options.timeout_secs is not None:
            timer = threading.Timer(options.timeout_secs, self._deadline_stop)
            timer.daemon = True
            timer.start()
        # caller errors (a snapshot from another model) raise here, in the
        # caller's thread, not inside the worker
        self._pre_run_validate()
        if self._prewarm and self._engine_tag == "single":
            # made once nothing above can refuse the spawn: the worker
            # thread lives until the run closes it
            from .prewarm import EnginePrewarmer

            self._prewarmer = EnginePrewarmer()
        self._thread: Optional[threading.Thread] = None
        if sync:
            self._run_guarded()
            if self._run_error is not None:
                err, self._run_error = self._run_error, None
                raise err
            self._maybe_write_report()
        else:
            self._thread = threading.Thread(target=self._run_guarded,
                                            daemon=True)
            self._thread.start()

    def _resolve_por(self, options: CheckerBuilder) -> None:
        """Partial-order reduction (JAX ``parallel/_base.py:110-143``): the
        builder wins over ``STATERIGHT_TPU_POR``; the plan
        (``analysis/independence.por_plan``) is resolved here, and an
        unusable one (liveness properties, no independent pair, every
        action visible, a boundary filter) falls back to full expansion,
        so the step never pays for the ample-set selection.  The fallback
        prints once per model."""
        import sys

        self._por_plan = None
        self._por_fallback: Optional[str] = None
        self._live_por: Optional[dict] = None
        self._por = resolve_flag(getattr(options, "por_mode", None), ENV_POR)
        if not self._por:
            return
        from ..analysis.independence import por_plan

        plan = por_plan(self.tensor, self._props)
        if plan.usable:
            self._por_plan = plan
            return
        self._por = False
        self._por_fallback = plan.fallback_reason
        if not getattr(self.model, "_por_warn_printed", False):
            try:
                object.__setattr__(self.model, "_por_warn_printed", True)
            except Exception:  # noqa: BLE001 - __slots__ models
                pass
            print("stateright-tpu-torch: por(): falling back to full "
                  f"expansion -- {plan.fallback_reason}", file=sys.stderr)

    def por_status(self) -> Optional[dict]:
        """Partial-order-reduction status of this run, or None when
        ``por()`` was never asked for (JAX ``parallel/_base.py:830-855``):
        whether reduction is active, the fallback reason when not, the
        twin's network packing, and the reduced-vs-full tallies (rows
        expanded with a reduced ample set, proviso-forced full expansions,
        candidates never generated)."""
        if not (self._por or self._por_fallback is not None):
            return None
        out = {
            "enabled": bool(self._por),
            "fallback": self._por_fallback,
            "encoding": getattr(self.tensor, "network_encoding", None),
        }
        if self._results and "por" in self._results:
            out.update(self._results["por"])
        elif self._live_por is not None:
            out.update(self._live_por)
        return out

    @staticmethod
    def _por_stats_dict(arr) -> dict:
        """The packed POR tallies as the JSON-facing dict."""
        arr = np.asarray(arr).astype(np.int64).reshape(-1)
        return {
            "rows_reduced": int(arr[0]),
            "rows_full_proviso": int(arr[1]),
            "candidates_masked": int(arr[2]),
        }

    def _init_telemetry(self, options: CheckerBuilder) -> None:
        """The builder's telemetry options (JAX ``parallel/_base.py:
        196-335``): the recorder, the cartography flag, the report and
        registry targets, the memory ledger, the preflight capacity guard
        and the scoped profiler."""
        opts = self._telemetry_opts = options.telemetry_opts or {}
        # the one option that adds device work (ops/cartography.py)
        self._cartography = bool(opts.get("cartography"))
        # depth lanes banked from the queue prefixes growth reclaims
        self._cart_depth_base: Optional[np.ndarray] = None
        self._report_path = options.report_path
        self._run_dir = options.run_dir
        # the supervisor's attempt span parents the engine_run span
        self._span_parent = getattr(options, "_span_ctx", None)
        self._run_span_ctx = None
        self.flight_recorder = options._make_recorder(self._telemetry_tag)
        if self._spill and self.flight_recorder is not None:
            # the health model's growth_oom_risk becomes the informational
            # spill forecast: the run will evict, not fail
            self.flight_recorder.set_spill_armed(True)
        self._mem_ledger = None
        if self.flight_recorder is not None and opts.get("memory"):
            from ..telemetry.memory import MemoryLedger

            self._mem_ledger = MemoryLedger(
                self._telemetry_tag, self._memory_spec_fn(),
                recorder=self.flight_recorder,
                every=int(opts.get("memory_every") or 0),
            )
        # the roofline cost ledger (telemetry/roofline.py over
        # analysis/costmodel.py): host-side analysis of the captured
        # kernels and the kernels' counts, built here at spawn so the
        # snapshot exists before the first poll; the step dispatches the
        # same operations either way
        self._roofline_ledger = None
        if self.flight_recorder is not None and opts.get("roofline"):
            from ..telemetry.roofline import RooflineLedger

            try:
                self._roofline_ledger = RooflineLedger(
                    self._telemetry_tag, self._roofline_cost_fn(),
                    recorder=self.flight_recorder,
                    device=getattr(self, "device", None))
            except Exception:  # noqa: BLE001 - accounting never breaks
                self._roofline_ledger = None  # a run
        self._preflight_capacity_guard()
        self._profiler = None
        if self.flight_recorder is not None and opts.get("profile_steps"):
            import tempfile

            from ..telemetry.profile import ScopedProfiler

            self._profiler = ScopedProfiler(
                opts.get("profile_dir")
                or tempfile.mkdtemp(prefix="stateright-tpu-torch-profile-"),
                int(opts["profile_steps"]), self.flight_recorder,
            )

    def _run_guarded(self) -> None:
        """The run inside its ``engine_run`` span (JAX
        ``parallel/_base.py:374-416``): the span closes, with ``error``
        set on the exception path, the prewarmer closes and the profiler
        stops either way, and the heartbeat lands one forced last beat with the run's end (``done``
        or ``failed``), so ``status`` tells a finished run from a killed
        one."""
        rec = self.flight_recorder
        sp = None
        if rec is not None:
            sp = start_span("engine_run", parent=self._span_parent)
            self._run_span_ctx = sp.ctx
            rec.bind_span(sp.ctx.span_id)
        error: Optional[BaseException] = None
        try:
            self._run()
        except BaseException as e:  # noqa: BLE001 - re-raised at join()
            self._run_error = error = e
        finally:
            if self._prewarmer is not None:
                # the background builder stops with the run (JAX
                # wavefront.py:2038-2044); an in-flight build finishes
                self._prewarmer.close()
            if self._profiler is not None:
                self._profiler.stop()
            if sp is not None:
                sp.end(rec, engine=self._telemetry_tag,
                       error=type(error).__name__ if error else None)
                rec.bind_span(None)
            if self._heartbeat is not None:
                self._heartbeat.beat(rec, status="failed" if error else "done",
                                     force=True)
            self._done.set()

    def _deadline_stop(self) -> None:
        """The builder ``timeout()`` fired: flag the cut (unless the run
        already finished) and ask for a cooperative stop."""
        if not self._done.is_set():
            self._timed_out = True
        self._stop.set()

    @property
    def timed_out(self) -> bool:
        """True when the builder ``timeout()`` cut the run short: the run
        report must not present such a run as complete."""
        return self._timed_out

    # -- telemetry (JAX parallel/_base.py:435-603) ---------------------------

    def _memory_spec_fn(self):  # engine-specific
        """``caps -> [BufferSpec]``, the engine's analytic memory model."""
        raise NotImplementedError

    def _memory_caps(self) -> dict:  # engine-specific
        """The engine's configured capacities as a spec-fn caps dict."""
        raise NotImplementedError

    def _analytic_footprint_bytes(self, caps: Optional[dict] = None):
        """Total analytic device bytes at ``caps`` (default: the
        configured capacities); None when the model cannot be built
        (accounting never breaks a run)."""
        from ..telemetry.memory import total_bytes

        try:
            return int(total_bytes(
                self._memory_spec_fn()(caps or self._memory_caps())))
        except Exception:  # noqa: BLE001 - accounting only
            return None

    def _preflight_capacity_guard(self) -> None:
        from ..telemetry.memory import preflight_guard

        total = self._analytic_footprint_bytes()
        if total is not None:
            preflight_guard(f"spawn_gpu({type(self.model).__name__})", total,
                            warn_once_obj=self.model)

    def _stage(self, name: str, secs: float) -> None:
        """Accumulate one per-stage wall-time counter (the recorder's
        ``stages()`` view); host-side only."""
        if self.flight_recorder is not None and secs >= 0:
            self.flight_recorder.add(f"stage_{name}_secs", secs)

    def _telemetry_occupancy(self, table_fp, *, at: str,
                             transferred: bool = False) -> None:
        """One visited-table occupancy sample (``ops/buckets.
        occupancy_stats``); ``transferred`` prices a device table's pull
        into the recorder's byte counters (growth boundaries pass a host
        table)."""
        rec = self.flight_recorder
        if rec is None:
            return
        from ..ops.buckets import occupancy_stats

        if isinstance(table_fp, torch.Tensor):
            table_fp = table_fp.cpu().numpy()
        if transferred:
            rec.add_bytes(d2h=table_fp.nbytes)
        rec.record("occupancy", at=at, **occupancy_stats(table_fp))

    def _roofline_cost_fn(self):  # engine-specific
        """``() -> CostReport | None``, the engine's cost model at its
        capacities."""
        raise NotImplementedError

    def roofline(self, live: bool = True) -> Optional[dict]:
        """The roofline ledger's block (``telemetry/roofline.py``; JAX
        ``parallel/_base.py:478``), or None without
        ``.telemetry(roofline=True)`` (or when a kernel did not capture).
        ``live=False`` is the deterministic static block the run report
        embeds; the default adds the reconciliation, the card's spec and
        verdicts and, once the recorder attributes device seconds, the
        achieved share."""
        led = getattr(self, "_roofline_ledger", None)
        if led is None or not led.ok:
            return None
        if not live:
            return led.static_block()
        rec = self.flight_recorder
        stages = rec.stages() if rec is not None else None
        return led.live_block(stages, self.unique_state_count())

    def memory(self, live: bool = True) -> Optional[dict]:
        """Latest memory-ledger snapshot (``telemetry/memory.py``), or None
        without ``.telemetry(memory=True)``.  ``live=False`` is the
        deterministic analytic subset the run report embeds."""
        if self._mem_ledger is None:
            return None
        return (self._mem_ledger.snapshot() if live
                else self._mem_ledger.analytic_block())

    def cartography(self) -> Optional[dict]:
        """Latest search-cartography snapshot (``ops/cartography.py``), or
        None without ``.cartography()``: mid-run the last host sync's,
        after completion the final one."""
        if self._results and "cartography" in self._results:
            return dict(self._results["cartography"])
        live = self._live_cart
        return dict(live) if live else None

    def occupancy_stats(self) -> Optional[dict]:
        """Bucket-occupancy counters of the finished run's table
        (``ops/buckets.occupancy_stats``), or None while it runs."""
        if not self._results:
            return None
        cached = getattr(self, "_occupancy_cache", None)
        if cached is None or cached[0] is not self._results:
            from ..ops.buckets import occupancy_stats

            cached = (self._results, occupancy_stats(self._table_np()[0]))
            self._occupancy_cache = cached
        return cached[1]

    def _run(self) -> None:  # engine-specific
        raise NotImplementedError

    def _init_spill(self) -> None:  # engine-specific
        raise NotImplementedError

    def _pre_run_validate(self) -> None:  # engine-specific, optional
        pass

    def _verify_fingerprint_bridge(self) -> None:
        """The host fingerprint must equal the device row hash, else traces
        cannot be reconstructed."""
        for s in self.model.init_states():
            host_fp = self.model.fingerprint_state(s)
            row = np.asarray([self.tensor.encode_state(s)], np.uint64)
            dev_fp = int(row_hash(torch.from_numpy(row.view(np.int64)))[0])
            if host_fp != dev_fp & MASK64:
                raise RuntimeError(
                    "model.fingerprint_state disagrees with the device row "
                    "hash; tensor-backed models must fingerprint via their "
                    "row encoding (mix in TensorBackedModel)"
                )
            break

    def _model_sig(self) -> np.ndarray:
        """Model identity guard for resume, the JAX engine's layout: sorted
        init fingerprints, then width, arity and property count."""
        fps = [self.model.fingerprint_state(s) for s in self.model.init_states()]
        return np.asarray(
            sorted(fps)
            + [self.tensor.width, self.tensor.max_actions, len(self._props)],
            np.uint64,
        )

    def _check_snapshot_sig(self, snap: dict) -> None:
        tag = str(snap.get("engine", "single"))
        if tag != self._engine_tag:
            raise ValueError(
                f"resume snapshot was taken by the {tag!r} engine; this is "
                f"the {self._engine_tag!r} engine"
            )
        sig = snap.get("model_sig")
        if sig is not None and not np.array_equal(self._model_sig(), sig):
            raise ValueError(
                "resume snapshot was taken from a different model "
                "(init fingerprints / tensor signature disagree)"
            )
        # lineage: the snapshot's run becomes this run's parent (npz keeps
        # a string as a 0-d unicode array)
        rid = snap.get("run_id")
        if rid is not None and self.parent_run_id is None:
            self.parent_run_id = str(np.asarray(rid).item())
        if not self._spill and (
                int(snap.get("spill_base", 0) or 0) > 0
                or any(k in snap for k in ("spill_fp", "spill_q_fp",
                                           "spill_pend_fp"))):
            # part of the visited set lives in the snapshot's host tier:
            # resuming without the tier would count every spilled state
            # as fresh (JAX parallel/_base.py:548-561)
            raise ValueError(
                "resume snapshot carries spill-tier contents (host/disk "
                "visited overflow); resume with CheckerBuilder.spill() / "
                "--spill / STATERIGHT_TPU_SPILL=1"
            )
        from ..telemetry.memory import snapshot_fits_guard

        snapshot_fits_guard(snap, f"resume({type(self.model).__name__})")

    # -- stop, checkpoint and autosave ---------------------------------------

    def final_snapshot(self) -> dict:  # engine-specific
        raise NotImplementedError

    def stop(self) -> "WavefrontChecker":
        """Ask the engine to stop at the next host sync (with autosave on,
        it writes one last generation there)."""
        self._stop.set()
        return self

    def checkpoint(self, timeout: Optional[float] = 60.0) -> dict:
        """Snapshot the run state (numpy arrays, serializable with
        ``np.savez``).  Mid-run the snapshot is taken at the next host
        sync; after completion it is the final state.  Continue with
        ``spawn_gpu(resume=snapshot)``, or the JAX engine's
        ``spawn_tpu(resume=snapshot)``."""
        if self._done.is_set():
            return self.final_snapshot()
        with self._ckpt_lock:
            self._ckpt_ready.clear()
            self._ckpt_req.set()
            # poll: the run can finish between the request and its next
            # sync, and then the final snapshot is the answer
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

    def _at_host_sync(self, snap_fn: Callable[[], dict]) -> bool:
        """The engine thread's seam at each host sync: serve a pending
        :meth:`checkpoint` and write an autosave generation when one is
        due.  ``snap_fn`` builds the snapshot, at most once per sync, and
        only when one is asked for.  Returns whether a generation was
        written."""
        snap = None
        if self._ckpt_req.is_set():
            snap = snap_fn()
            # the caller's own dict: it may edit keys while the autosave
            # below writes this snapshot
            self._ckpt_out = dict(snap)
            self._ckpt_req.clear()
            self._ckpt_ready.set()
        return self._maybe_autosave(snap_fn if snap is None else lambda: snap)

    def _maybe_autosave(self, snap_fn: Callable[[], dict],
                        force: bool = False) -> bool:
        """Write one autosave generation when the cadence is due (or
        ``force``: the stop path saves unless this sync already has, so a
        stopped run loses at most the current block); returns whether one
        was written.  A failure never kills the run: ``OSError`` is
        accounted inside ``save()``, anything else here, except an
        injected fault, which reaches the supervisor.  The heartbeat beats
        here at every sync (it throttles itself), due or not."""
        if self._heartbeat is not None:
            self._heartbeat.beat(self.flight_recorder)
        svc = self._autosave
        if svc is None or not (force or svc.due()):
            return False
        t0 = time.monotonic()
        written = False
        try:
            with span("autosave", self.flight_recorder,
                      parent=self._run_span_ctx, gen=svc._gen):
                snap = snap_fn()
                t1 = time.monotonic()
                if svc.save(snap, self._autosave_manifest(snap)) is not None:
                    self.autosave_secs.append((t1 - t0,
                                               time.monotonic() - t1))
                    written = True
        except Exception as e:  # noqa: BLE001 - see the docstring
            if isinstance(e, InjectedFault):
                raise  # manufactured process death, not a write failure
            svc._clock = time.monotonic()  # a failing path must not turn
            # every later sync into a fresh attempt
            svc.note_failure(svc._gen, e)
        self._stage("checkpoint", time.monotonic() - t0)
        self._refresh_durability()
        return written

    def _autosave_manifest(self, snap: dict) -> dict:
        """The generation manifest: the run's identity and canonical
        config (``telemetry/report.build_config``), the model, the engine,
        the progress at the checkpoint and each property's discovery flag,
        so resume picks a generation without loading its npz."""
        if self._autosave_config is None:
            from ..telemetry.report import build_config

            try:
                self._autosave_config = build_config(self)
            except Exception:  # noqa: BLE001 - identity never breaks a save
                self._autosave_config = {}
        disc = np.asarray(snap.get("disc", np.zeros(0))).reshape(-1)
        man = {
            "run_id": self.run_id,
            "model": type(self.model).__name__,
            "engine": ("wavefront" if self._engine_tag == "single"
                       else self._engine_tag),
            "totals": {
                "states": int(np.asarray(snap.get("scount", 0))),
                "unique": int(np.asarray(snap.get("unique", 0))),
                "max_depth": int(np.asarray(snap.get("maxdepth", 0))),
            },
            "properties": [
                {"name": p.name,
                 "expectation": p.expectation.name.lower(),
                 "discovery": bool(i < disc.size and int(disc[i]) != 0)}
                for i, p in enumerate(self._props)
            ],
            "config": self._autosave_config,
            "restarts": self._restarts,
            "written_at": datetime.datetime.now(datetime.timezone.utc)
            .isoformat(timespec="seconds"),
        }
        if self.parent_run_id:
            man["parent_run_id"] = self.parent_run_id
        return man

    def durability_status(self, live: bool = True) -> Optional[dict]:
        """The durability block (the supervised restarts and degradations;
        the cadence, the generations written and failed, the age of the
        last one), or None when the run has neither autosave nor a
        supervision trail (JAX ``parallel/_base.py:698-722``).
        ``live=False`` is the deterministic subset the run report embeds:
        the restarts, the degradations, the cadence and the kept count."""
        svc = self._autosave
        if svc is None and not self._restarts and not self._degradations:
            return None
        out: dict = {"v": CKPT_V, "restarts": self._restarts}
        if self._degradations:
            out["degradations"] = list(self._degradations)
        if svc is not None:
            out["autosave"] = (svc.status() if live else
                               {"every_secs": svc.every_secs, "keep": svc.keep})
        return out

    def _refresh_durability(self) -> None:
        if self.flight_recorder is not None:
            self.flight_recorder.set_durability(self.durability_status())

    # -- Checker surface -----------------------------------------------------

    def is_done(self) -> bool:
        return self._done.is_set()

    def join(self) -> "WavefrontChecker":
        if self._thread is not None:
            self._thread.join()
        if self._run_error is not None:
            raise self._run_error
        self._maybe_write_report()
        return self

    def state_count(self) -> int:
        return self._results["states"] if self._results else self._live[0]

    def unique_state_count(self) -> int:
        return self._results["unique"] if self._results else self._live[1]

    def max_depth(self) -> int:
        return self._results["depth"] if self._results else self._live[2]

    def _table_np(self):
        """(fingerprints, parents) of the final visited table, numpy uint64."""
        raise NotImplementedError

    @staticmethod
    def _parents_from_table(tfp: np.ndarray, tpl: np.ndarray) -> dict[int, int]:
        """fp -> parent fp map from uint64 table arrays."""
        tfp = np.asarray(tfp).reshape(-1)
        tpl = np.asarray(tpl).reshape(-1)
        occupied = tfp != np.uint64(MASK64)
        return dict(zip(tfp[occupied].tolist(), tpl[occupied].tolist()))

    @staticmethod
    def _walk(parents: dict[int, int], fp: int) -> list[int]:
        """Parent chain from an init state down to ``fp`` (0 marks "is an
        init state")."""
        fps = [fp]
        while True:
            parent = parents.get(fps[-1], 0)
            if parent == 0:
                break
            fps.append(parent)
        fps.reverse()
        return fps

    def _parents(self) -> dict[int, int]:
        if self._parent_map is None:
            self._parent_map = self._parents_from_table(*self._table_np())
        return self._parent_map

    def _trace(self, fp: int) -> list[int]:
        return self._walk(self._parents(), fp)

    def discovery_fps(self) -> dict[str, int]:
        """Property name -> discovery fingerprint (unsigned)."""
        self.join()
        disc = self._results["disc"]
        return {
            prop.name: int(disc[i])
            for i, prop in enumerate(self._props)
            if int(disc[i]) != 0
        }

    def _symmetry_key(self):
        """None, or under symmetry the host key of a state's class: the
        twin's own ``representative_key`` where it has one (a compiled
        twin hashes a virtual canonical row, not an encodable state), else
        the fingerprint of the representative."""
        if self._symmetry is None:
            return None
        tkey = getattr(self.tensor, "representative_key", None)
        if tkey is not None:
            return tkey
        sym, model = self._symmetry, self.model
        return lambda s: model.fingerprint_state(sym(s))

    def discoveries(self) -> dict[str, Path]:
        key = self._symmetry_key()
        return {
            name: Path.from_fingerprints(self.model, self._trace(fp), key=key)
            for name, fp in self.discovery_fps().items()
        }

    def live_discoveries(self, skip: frozenset = frozenset(),
                         timeout: float = 5.0) -> dict[str, Path]:
        """The discoveries found so far, without joining (JAX
        ``parallel/_base.py:973-1030``): the Explorer polls this while the
        run is in flight.  The discovery fingerprints ride each block's one
        stats read (``_live_disc``); a discovery's parent chain never
        changes once written, so one :meth:`checkpoint`, served by the
        engine thread at its next host sync, gives a table to walk.  The
        caller never touches a device tensor.  ``skip`` names the
        properties the caller has rebuilt already (a first discovery never
        changes): when every recorded one is in it, no checkpoint is taken.
        ``timeout`` bounds the wait for that checkpoint: a poll that lands
        in a long block returns ``{}`` and the next poll retries."""
        if self._done.is_set():
            return {n: p for n, p in self.discoveries().items()
                    if n not in skip}
        with self._live_lock:
            disc = self._live_disc
        if disc is None:
            return {}
        wanted = [(i, prop) for i, prop in enumerate(self._props)
                  if prop.name not in skip and int(disc[i]) != 0]
        if not wanted:
            return {}
        try:
            snap = self.checkpoint(timeout=timeout)
        except (TimeoutError, RuntimeError):
            return {}
        if self._done.is_set():  # finished while the snapshot was taken
            return {n: p for n, p in self.discoveries().items()
                    if n not in skip}
        parents = self._parents_from_table(snap["table_fp"],
                                           snap["table_parent"])
        key = self._symmetry_key()
        out = {}
        for i, prop in wanted:
            try:
                out[prop.name] = Path.from_fingerprints(
                    self.model, self._walk(parents, int(disc[i])), key=key)
            except RuntimeError:
                continue  # the chain raced a growth; the next poll retries
        return out
