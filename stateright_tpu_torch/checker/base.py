"""Checker result surface + builder (reference ``src/checker.rs``).

The port's counterpart of ``stateright_tpu/checker/base.py``:
``CheckerBuilder`` carries ``symmetry``, ``target_states``, ``threads``,
``visitor``, ``timeout``, ``autosave``, the telemetry options
(``telemetry``, ``cartography``, ``memory_ledger``, ``report``, ``runs``)
and the GPU engine's ``prededup``, ``por``, ``checked`` and ``spill`` (``mxu`` is
accepted for parity and has no effect), the static audit (``audit``,
``skip_audit``: the preflight that ``spawn_gpu`` runs), and spawns the
host checkers (:meth:`CheckerBuilder.spawn_bfs`, :meth:`CheckerBuilder.spawn_dfs`,
:meth:`CheckerBuilder.spawn_mp_bfs`), the GPU wavefront engine
(:meth:`CheckerBuilder.spawn_gpu`) and the engine chosen by a bounded host
probe (:meth:`CheckerBuilder.spawn_auto`); ``Checker`` is the result
surface (counts, discoveries, assertions, and the ``Done. states=..``
report line, the flight recorder, the run identity and the run report).
``sweep`` (JAX :521) routes ``spawn_gpu`` to the sweep engine
(``sweep/engine.py``) for a whole model family, and ``serve`` (JAX
:833-845) spawns a check and serves the Explorer over it
(``explorer.py``).  The builder is also what the fleet's job factories
return (``fleet/``).
"""

from __future__ import annotations

import os
import sys
import time
from typing import Callable, Optional, Sequence

from ..core import Expectation, Model, Property
from .path import Path
from .visitor import CheckerVisitor, FnVisitor

# the process-wide switch of the spawn preflight audit
ENV_SKIP_AUDIT = "STATERIGHT_TPU_SKIP_AUDIT"

# States processed per lock round, as in the reference's job market
# (reference ``bfs.rs:120``, ``dfs.rs:126``).
JOB_BLOCK_SIZE = 1500


class CheckerBuilder:
    """Fluent checker configuration (reference ``checker.rs:35-179``)."""

    def __init__(self, model: Model):
        self.model = model
        self.symmetry_fn: Optional[Callable] = None
        self.symmetry_is_default = False
        self.target_state_count: Optional[int] = None
        self.thread_count: int = 1
        self.visitor_obj: Optional[CheckerVisitor] = None
        self.timeout_secs: Optional[float] = None
        self.autosave_opts: Optional[dict] = None
        # the GPU engine's pre-dedup and spill tier; None = the env knob
        # decides
        self.prededup_mode: Optional[bool] = None
        self.spill_mode: Optional[bool] = None
        # engine prewarm (None = the env knob decides) and the compile
        # cache directory (None = the env knob, else the default)
        self.prewarm_mode: Optional[bool] = None
        self.compile_cache_dir: Optional[str] = None
        # partial-order reduction; None = the env knob decides
        self.por_mode: Optional[bool] = None
        # the GPU engine's checked execution mode
        self.checked_mode = False
        # mxu() is accepted without effect; a sweep refuses it, as JAX's
        self.mxu_mode: Optional[bool] = None
        # a hyper-batched instance sweep (sweep/); None = the env knob
        # STATERIGHT_TPU_SWEEP decides, on models with a sweep_family
        self.sweep_spec = None
        # telemetry (telemetry/): None = off
        self.telemetry_opts: Optional[dict] = None
        self.report_path: Optional[str] = None
        # the run registry's root; None = the STATERIGHT_TPU_RUN_DIR knob
        self.run_dir: Optional[str] = None
        # skip_audit(): no preflight audit on spawn_gpu
        self._audit_skip = False
        # the mesh engine; None = the env knob STATERIGHT_TPU_MESH decides
        self.mesh_mode: Optional[bool] = None
        self.mesh_devices = None

    def symmetry(self) -> "CheckerBuilder":
        """Dedup on symmetry-class representatives; states must define
        ``representative()`` (reference ``checker.rs:150-154``).  The host
        DFS and the GPU engine honour it; the host BFS ignores it, as the
        reference's does."""
        self.symmetry_fn = lambda s: s.representative()
        self.symmetry_is_default = True
        return self

    def symmetry_with(self, fn: Callable) -> "CheckerBuilder":
        """Dedup on ``fn(state)``: the host DFS only (the GPU engine refuses
        it, since its canonicalizer mirrors ``representative()``)."""
        self.symmetry_fn = fn
        self.symmetry_is_default = False
        return self

    def target_states(self, count: int) -> "CheckerBuilder":
        """Stop after roughly ``count`` unique states
        (reference ``checker.rs:163-167``)."""
        self.target_state_count = count
        return self

    def threads(self, count: int) -> "CheckerBuilder":
        """Worker threads of the host checkers."""
        self.thread_count = max(1, count)
        return self

    def visitor(self, v) -> "CheckerBuilder":
        """Call ``v`` (a :class:`CheckerVisitor` or a plain callable of
        ``(model, path)``) on every state the host checkers evaluate."""
        self.visitor_obj = v if isinstance(v, CheckerVisitor) else FnVisitor(v)
        return self

    def timeout(self, secs: float) -> "CheckerBuilder":
        self.timeout_secs = secs
        return self

    def autosave(self, path: str, every_secs: float = 60.0,
                 keep: int = 3) -> "CheckerBuilder":
        """Autosave a GPU engine run to rotating snapshot generations under
        ``path`` (``checkpoint.py``): at a host sync, once ``every_secs``
        has passed since the last save (``0`` = every host sync), the
        engine writes its resume snapshot as ``gen-NNNNNN/snapshot.npz``
        and then a ``MANIFEST.json``, both atomically (temp file, fsync,
        ``os.replace``), so a crash mid-save leaves a torn generation that
        resume skips.  The newest ``keep`` complete generations are kept,
        and a stopped run (``stop()``, ``timeout()``) writes one last
        generation.  Resume with ``spawn_gpu(resume=
        checkpoint.latest_generation(path)[0])``; the JAX engine resumes
        from the same files.  Env equivalent:
        ``STATERIGHT_TPU_AUTOSAVE=DIR`` (cadence and keep through
        ``STATERIGHT_TPU_AUTOSAVE_SECS``/``_KEEP``).  With autosave off a
        block still makes exactly one host read."""
        self.autosave_opts = {
            "dir": str(path),
            "every_secs": float(every_secs),
            "keep": int(keep),
        }
        return self

    def telemetry(
        self,
        enabled: bool = True,
        *,
        capacity: int = 4096,
        occupancy_every: int = 0,
        profile_steps: int = 0,
        profile_dir: Optional[str] = None,
        cartography: bool = False,
        memory: bool = False,
        memory_every: int = 32,
        roofline: bool = False,
        metrics: bool = False,
    ) -> "CheckerBuilder":
        """Attach a flight recorder to the spawned checker
        (``stateright_tpu_torch/telemetry/``; JAX ``checker/base.py:
        103-228``).

        Every strategy then streams structured records into a bounded ring
        (``capacity`` records) exposed as ``checker.flight_recorder``: the
        GPU engine one ``step`` per host sync (one per ``steps_per_call``
        block) plus ``growth``, ``occupancy``, ``memory``,
        ``cartography``, ``checkpoint``, ``profile`` and ``span`` records;
        the host checkers one per job block or mp round.

        ``occupancy_every=N`` samples the visited table's bucket occupancy
        every N host syncs on the GPU engine (each a device-to-host table
        pull), plus a closing ``final`` sample; growth boundaries are
        always sampled, free.  ``profile_steps=N`` traces the first N
        blocks of a GPU run with ``torch.profiler`` into ``profile_dir``
        (a Chrome trace).  ``memory=True`` attaches the memory ledger
        (``telemetry/memory.py``: analytic bytes per device buffer, the
        growth-transient forecast, ``torch.cuda.memory_stats`` readings,
        a ``memory`` record at each rung change and every
        ``memory_every`` syncs; on ``cuda`` it also measures each
        growth's allocation peak from the process's peak counters, which
        it reads and never resets).  ``metrics=True`` attaches the
        process-wide metrics bus (``telemetry/metrics.py``): the recorder
        publishes the engine families (states/s, frontier size, table load,
        dedup rate, step-time histogram) from the values each host sync
        already read, and the Explorer serves them as Prometheus text on
        ``GET /metrics``.  ``STATERIGHT_TPU_METRICS=1`` is the env form.
        Host-side only: the step dispatches the same operations and the
        step records are the same.
        ``cartography=True`` folds the search-cartography counters into
        the device step (``ops/cartography.py``): the one option that adds
        device work, a few reductions a step riding the same stats read.
        ``roofline=True`` attaches the roofline cost ledger
        (``telemetry/roofline.py`` over ``analysis/costmodel.py``): each
        stage's FLOPs and bytes (the twin's captured kernels walked, the
        hand-written kernels' counts), the kernels' counts beside the walks
        of their plain versions, memory- or compute-bound verdicts where
        the card has a spec, and the JX4xx candidates.  Host-side only:
        the step dispatches the same operations.  It surfaces as
        ``checker.roofline()``, the run report's ``roofline`` block and
        the ``costmodel`` verb.

        Telemetry off (the default) is exactly the engine without it: no
        recorder, and the step dispatches the same operations.  Flags
        implied earlier (``report()``, ``cartography()``,
        ``memory_ledger()``, ``roofline()``) stay on when this is called
        again."""
        if not enabled:
            self.telemetry_opts = None
            return self
        prev = self.telemetry_opts or {}
        implied_mem = bool(prev.get("memory"))
        every = (prev.get("memory_every")
                 if implied_mem and memory_every == 32 else None)
        self.telemetry_opts = {
            "capacity": capacity,
            "occupancy_every": occupancy_every,
            "profile_steps": profile_steps,
            "profile_dir": profile_dir,
            "cartography": bool(cartography) or bool(prev.get("cartography")),
            "memory": bool(memory) or implied_mem,
            "memory_every": int(every if every is not None else memory_every),
            "roofline": bool(roofline) or bool(prev.get("roofline")),
            "metrics": bool(metrics) or bool(prev.get("metrics")),
        }
        return self

    def cartography(self, enabled: bool = True) -> "CheckerBuilder":
        """Fold the search-cartography counters into the run: a
        ``.telemetry(cartography=True)`` shorthand that keeps an existing
        telemetry config.  ``report()`` and ``--watch`` imply it."""
        if not enabled:
            return self
        if self.telemetry_opts is None:
            self.telemetry()
        self.telemetry_opts["cartography"] = True
        return self

    def memory_ledger(self, enabled: bool = True) -> "CheckerBuilder":
        """Attach the memory ledger (``telemetry/memory.py``): a
        ``.telemetry(memory=True)`` shorthand that keeps an existing
        telemetry config.  ``report()`` and ``--watch`` imply it."""
        if not enabled:
            return self
        if self.telemetry_opts is None:
            self.telemetry()
        self.telemetry_opts["memory"] = True
        self.telemetry_opts.setdefault("memory_every", 32)
        return self

    def roofline(self, enabled: bool = True) -> "CheckerBuilder":
        """Attach the roofline cost ledger (``telemetry/roofline.py``): a
        ``.telemetry(roofline=True)`` shorthand that keeps an existing
        telemetry config (JAX ``checker/base.py:256``)."""
        if not enabled:
            return self
        if self.telemetry_opts is None:
            self.telemetry()
        self.telemetry_opts["roofline"] = True
        return self

    def report(self, path: str) -> "CheckerBuilder":
        """Write a post-run report to ``path`` (JSON, with a sibling
        ``.md`` rendering) at the first ``join()`` after the run completes
        (``telemetry/report.py``).  Implies telemetry with cartography and
        the memory ledger.  The JSON body is deterministic for a fixed
        model and configuration; the volatile fields are exactly
        ``telemetry.report.VOLATILE_KEYS`` (``generated_at``, ``run_id``,
        ``parent_run_id``)."""
        if os.path.splitext(str(path))[1] == ".md":
            raise ValueError(
                f"report path {path!r} ends in .md — pass the JSON path; "
                "the markdown rendering lands next to it as <path-stem>.md"
            )
        self.report_path = str(path)
        return self.cartography().memory_ledger()

    def runs(self, path: str) -> "CheckerBuilder":
        """Archive this run into the run registry rooted at ``path``
        (``telemetry/registry.py``): at the first ``join()`` after
        completion the report body lands under ``<path>/runs/<run_id>.json``
        and one index record appends to ``<path>/index.jsonl``.  Host-side
        post-run I/O only.  Env equivalent: ``STATERIGHT_TPU_RUN_DIR=DIR``
        (archives every run in the process)."""
        self.run_dir = str(path)
        return self

    def _make_recorder(self, engine: str):
        """A FlightRecorder per the telemetry options (None when telemetry
        is off), shared by every spawn path."""
        if self.telemetry_opts is None:
            return None
        from ..telemetry import FlightRecorder

        metrics = None
        if self.telemetry_opts.get("metrics"):
            from ..telemetry import default_bus

            metrics = default_bus()
        return FlightRecorder(
            capacity=self.telemetry_opts["capacity"],
            meta={"engine": engine, "model": type(self.model).__name__},
            metrics=metrics,
        )

    def prewarm(self, enabled: bool = True) -> "CheckerBuilder":
        """Growth-stall elision for the single-device GPU engine
        (``parallel/prewarm.py``; JAX ``checker/base.py:310``): the growth
        ladder's next capacity rungs are built AHEAD OF TIME on a
        background thread (``stateright-prewarm``): each rung's engine,
        its device buffers and, under ``.por()``/``.checked()``, its
        kernel captures, on the run thread's stream, so a growth boundary
        swaps in a ready engine instead of blocking the run on a cold
        build.  Wrong predictions cost one wasted background build and
        nothing else; the per-boundary wait is recorded in the flight
        recorder (``compile`` events: ``source="prewarm"``,
        ``duration``).  Default off (env override
        ``STATERIGHT_TPU_PREWARM=1``); the search is untouched: the
        prewarmed engine is the SAME engine, built earlier, and the step
        dispatches the same operations.  The other engines ignore it."""
        self.prewarm_mode = bool(enabled)
        return self

    def compile_cache(self, path: str) -> "CheckerBuilder":
        """Build the kernel library (``nvcc``) and the native module
        (``g++``) into, and load them from, ``path`` (``parallel/prewarm.
        enable_persistent_compile_cache``; JAX ``checker/base.py:341``),
        so repeated runs in fresh processes skip the compilers.  Applies
        process-wide at the engine's spawn (last caller wins); a library
        the process already loaded stays loaded.  Engines are not cached:
        each owns mutable buffers.  Default ``stateright_tpu_torch/
        _build/``; env equivalent ``STATERIGHT_TPU_COMPILE_CACHE=DIR``.
        The first block's ``compile`` event says ``source="persistent"``
        when the library was loaded from the directory."""
        self.compile_cache_dir = str(path)
        return self

    def prededup(self, enabled: bool = True) -> "CheckerBuilder":
        """Intra-window candidate pre-dedup on the GPU engine
        (``ops/buckets.window_unique``; JAX ``checker/base.py:325``): within
        one step, every later occurrence of a successor's fingerprint is
        masked off before the insert, the first kept, so the candidate
        budget sees only the step's unique successors.  Counts, verdicts,
        traces and table bytes are the run's without the flag at the same
        capacities (the budget's overflow can only come later, so growth
        may differ); the state count still counts duplicates.  Under the
        flag the step hashes its candidates once more (the ``row_hash``
        kernel).  Default off; env override
        ``STATERIGHT_TPU_PREDEDUP=1``."""
        self.prededup_mode = bool(enabled)
        return self

    def por(self, enabled: bool = True) -> "CheckerBuilder":
        """Partial-order reduction on the GPU engine (JAX
        ``checker/base.py:353-377``): the static independence analysis
        (``analysis/independence.py``) derives a per-model action x action
        conflict matrix from footprints at packed-field granularity, read
        off the twin's captured step graph; the engine then masks each
        state's enabled-action set down to a minimal conflict-closed
        **ample subset** (a stubborn-set closure computed on the device,
        ``ops/por.py``), with a conservative cycle proviso: a state whose
        ample successors are all duplicates is fully expanded in the same
        step, as is the first batch after every growth or resume boundary.

        Soundness contract: property verdicts are IDENTICAL to full
        expansion.  The analysis falls back to full expansion whenever
        reduction could be unsound: ``eventually`` properties,
        property-visible actions (an ample set may not hold one),
        undecidable footprints (conservatively dependent), or a
        boundary-filtered twin.  Off (the default), or falling back, the
        step dispatches the same operations as without the flag.  Env
        override ``STATERIGHT_TPU_POR=1``.  Composes with ``symmetry()``
        and ``prededup()``; rejected with ``spill()``, as in JAX.  The host
        checkers ignore the flag."""
        self.por_mode = bool(enabled)
        return self

    def mxu(self, enabled: bool = True, *, coalesce: bool = True,
            slim_queue: bool = True, probe: bool = True) -> "CheckerBuilder":
        """Accepted for parity with the JAX builder (``checker/base.py:379``)
        and without effect in the port, as is ``STATERIGHT_TPU_MXU``: every
        twin always assembles its packed words with the coalesced
        :class:`~stateright_tpu_torch.parallel.tensor_model.FieldWriter`
        (``coalesce``), the queue append already writes only the novel rows
        (``slim_queue``), and ``csrc/bucket_plan.cu``'s ballots give the
        probe's two counts without a product (``probe``)."""
        self.mxu_mode = bool(enabled)
        return self

    def sweep(self, spec) -> "CheckerBuilder":
        """Check a whole model family in one GPU run (``sweep/``; JAX
        ``checker/base.py:521``): ``spec`` is a
        :class:`~stateright_tpu_torch.sweep.SweepSpec` of instances
        (lossiness flags, bounds, table seeds), and :meth:`spawn_gpu`
        returns a :class:`~stateright_tpu_torch.sweep.engine.SweepChecker`.
        Instances group into shape cohorts, each one program over a shared
        visited table whose fingerprints are namespaced per instance, so
        each instance's counts, verdicts and traces are those of its own
        sequential run.  With no sweep asked for, ``spawn_gpu`` builds
        exactly the plain engine.  Env: ``STATERIGHT_TPU_SWEEP=N`` on
        models that define ``sweep_family(N)``.  A sweep takes telemetry,
        cartography, report, runs, timeout and per-instance targets; it
        refuses checked, por, spill, mxu, symmetry, prededup and autosave."""
        self.sweep_spec = spec
        return self

    def checked(self, enabled: bool = True) -> "CheckerBuilder":
        """Checked execution mode on the GPU engine, the sanitizer's
        dynamic guard (``analysis/sanitizer.py``; JAX ``checker/base.py:
        547-565``): the twin's ``property_masks`` and ``step_rows`` run
        under a ``TorchDispatchMode`` that flags an out-of-range index, an
        integer or float division by zero and a NaN on the device, clamps
        the index (divides by 1) and runs the operation, so the step never
        trips a CUDA device-side assert.  The block stops at the first
        failing step, and the run raises a
        :class:`~stateright_tpu_torch.analysis.CheckedExecutionError`
        naming the offending row (its index in the replayed window, its
        words, the decoded state).  A debugging mode: the guard adds
        operations to every step; off (the default) the step dispatches
        the same operations as before.  The host checkers ignore the flag
        (Python raises eagerly there)."""
        self.checked_mode = bool(enabled)
        return self

    # -- the static preflight audit (analysis/; JAX checker/base.py:
    # 589-640) -----------------------------------------------------------------

    def audit(self, *, deep: bool = True):
        """Run the static auditor over the model and return its
        :class:`~stateright_tpu_torch.analysis.AuditReport`: the
        actor-handler lint, the kernel audit, the static sanitizer and the
        config-drift checks (``analysis/audit.py``).  ``deep=True`` adds
        the bounded closure-domain probe, the second capture of
        ``property_masks`` and the fresh-twin drift re-resolve."""
        from ..analysis import audit_model

        return audit_model(self.model, deep=deep)

    def skip_audit(self) -> "CheckerBuilder":
        """Turn off the preflight audit that :meth:`spawn_gpu` runs, for
        this builder (to reproduce a flagged defect on the card, or when a
        rule misfires); ``STATERIGHT_TPU_SKIP_AUDIT=1`` turns it off for
        the process."""
        self._audit_skip = True
        return self

    def _preflight_audit(self) -> None:
        """The light audit before any buffer is allocated: errors abort
        (:class:`~stateright_tpu_torch.analysis.AuditError`), warnings
        print once per model.  Cached by configuration signature, so a
        respawn pays a dictionary lookup.  An exception inside the audit
        never masks the engine's own, more specific, error."""
        if self._audit_skip or os.environ.get(ENV_SKIP_AUDIT) == "1":
            return
        from ..analysis import AuditError, Severity, audit_model

        try:
            report = audit_model(self.model, deep=False)
        except Exception:  # noqa: BLE001 - see the docstring
            return
        if report.errors:
            raise AuditError(
                report, context=f"spawn_gpu({type(self.model).__name__})")
        if report.warnings and not getattr(self.model,
                                           "_audit_warn_printed", False):
            try:
                object.__setattr__(self.model, "_audit_warn_printed", True)
            except Exception:  # noqa: BLE001 - __slots__ models
                pass
            print(report.format(min_severity=Severity.WARNING),
                  file=sys.stderr)

    def mesh(self, enabled: bool = True, *,
             devices=None) -> "CheckerBuilder":
        """Run ``spawn_gpu`` on the mesh engine (``parallel/mesh.py``;
        JAX ``checker/base.py:432``): the single-device wavefront program
        with the visited table and the queue held as row pieces over a
        device mesh (the table in bucket ranges, so a bucket's owner is a
        layout fact), counters whole on the lead device.  Counts, verdicts,
        discovery traces, the final table and queue, and snapshots equal
        the single-device engine's.  ``devices=N`` bounds the mesh to the
        first ``N`` visible devices (default: all of them; on
        ``device="cpu"`` 8 pieces); ``devices=[...]``, a list of devices,
        places one piece on each and may repeat a device.  Env override
        ``STATERIGHT_TPU_MESH=1`` (or ``=N``).  The sharded engine keeps
        its spelling, ``spawn_gpu(devices=N)``, and wins when both are
        given."""
        self.mesh_mode = bool(enabled)
        if devices is None or isinstance(devices, int):
            self.mesh_devices = devices
        else:
            self.mesh_devices = list(devices)
        return self

    def spill(self, enabled: bool = True) -> "CheckerBuilder":
        """Arm the spill tier on the GPU engine (``spill/``; JAX
        ``checker/base.py:457-484``): the visited set becomes a tiered
        store, the device table as the hot tier, a host-RAM fingerprint
        store behind a hash index, and an mmap'd disk tier behind that.
        When the memory ledger's forecast says the next table rung's
        growth does not fit the device's memory (``torch.cuda``'s, or
        ``STATERIGHT_TPU_DEVICE_BYTES``), the engine evicts the hot table
        to the host tier instead of growing it, and a device Bloom filter
        over the spilled fingerprints defers only the candidates that may
        have been spilled, to be resolved against the host index at the
        next host sync.  Counts, verdicts and traces are the run's without
        the tier; snapshots carry the host tiers, so a run resumes in the
        middle of a spill.  Env override ``STATERIGHT_TPU_SPILL=1``.
        ``spawn_gpu``'s ``spill_bloom_bits``, ``spill_dir`` and
        ``spill_host_bytes`` (env ``STATERIGHT_TPU_HOST_BYTES``) size it.
        The host checkers ignore the flag."""
        self.spill_mode = bool(enabled)
        return self

    # -- strategies ----------------------------------------------------------

    def spawn_bfs(self) -> "Checker":
        """Breadth-first search on host threads (``checker/bfs.py``)."""
        from .bfs import BfsChecker

        return BfsChecker(self)

    def spawn_dfs(self) -> "Checker":
        """Depth-first search on host threads (``checker/dfs.py``); the
        host checker that honours ``symmetry()``."""
        from .dfs import DfsChecker

        return DfsChecker(self)

    def spawn_mp_bfs(self, processes: Optional[int] = None) -> "Checker":
        """Process-parallel BFS: real multi-core checking (the thread pool
        is GIL-bound).  Fingerprint-ownership sharding over forked workers,
        with symmetry and visitors (``checker/mp.py``).  ``processes``
        defaults to ``threads(N)`` if set above 1, else all cores."""
        from .mp import MpBfsChecker

        return MpBfsChecker(self, processes=processes)

    def spawn_auto(self, probe_secs: float = 2.0, **gpu_kw) -> "Checker":
        """Pick the engine by *measured* space size: the GPU engine pays a
        fixed cost per run (kernel builds, table setup, a host sync per
        block) that a small space never earns back on the host BFS.

        (1) A host probe runs first, bounded by ``probe_secs``: if the
        space exhausts within the budget, the finished checker IS the
        result.  (2) A space that outlives the probe escalates to
        :meth:`spawn_gpu` (``gpu_kw`` passes through; with no CUDA device
        and no ``device="cpu"`` that raises, as ``spawn_gpu`` does: the
        probe's partial result is never returned in its place), with the
        probe's wall-clock deducted from any ``timeout()``.  With a
        visitor, which the GPU engine rejects, the heavier engine is
        :meth:`spawn_mp_bfs`, where ``fork`` exists and there is more
        than one core.  A model with no twin (or whose twin fails to
        build) checks on the host engines outright.  With ``symmetry()``
        the probe is the host DFS, the host engine that honours it
        (JAX ``checker/base.py:660-749``)."""
        import time as _time

        cpu_spawn = self.spawn_dfs if self.symmetry_fn else self.spawn_bfs

        def probe_then(escalate, small=None):
            """A visitor-free sizing probe on the host engine, then either
            the ``small`` outcome (default: the finished probe itself) or
            ``escalate``.  Without a visitor the probe's wall-clock is
            deducted from the user ``timeout()``; with one the final
            engine gets the full timeout, so callbacks fire exactly once,
            on a fully budgeted run."""
            if (self.timeout_secs is not None
                    and self.timeout_secs <= probe_secs):
                return cpu_spawn()  # the whole run fits in the probe budget
            saved = self.timeout_secs
            vis, self.visitor_obj = self.visitor_obj, None
            self.timeout_secs = probe_secs
            t0 = _time.monotonic()
            try:
                probe = cpu_spawn().join()
            finally:
                self.timeout_secs = saved
                self.visitor_obj = vis
            if not probe.timed_out:
                return probe if small is None else small()
            if saved is None or vis is not None:
                return escalate()
            remaining = saved - (_time.monotonic() - t0)
            if remaining <= 0:
                return probe  # budget gone: the partial probe result is it
            self.timeout_secs = remaining
            try:
                return escalate()
            finally:
                self.timeout_secs = saved

        if self.visitor_obj is not None:
            # the GPU engine rejects visitors (it never materializes
            # states), so a big space escalates to the process-parallel
            # BFS (visitors by replay), where there are cores to win and
            # fork exists; a small one re-runs the host engine with the
            # visitor attached
            import multiprocessing as _mp
            import os as _os

            can_mp = (_os.cpu_count() or 1) > 1 and (
                "fork" in _mp.get_all_start_methods()
            )
            if not can_mp:
                return cpu_spawn()
            return probe_then(self.spawn_mp_bfs, small=cpu_spawn)
        from ..parallel.tensor_model import twin_or_none

        if twin_or_none(self.model) is None:
            return cpu_spawn()
        return probe_then(lambda: self.spawn_gpu(**gpu_kw))

    def spawn_gpu(
        self,
        capacity: int = 1 << 17,
        batch: int = 1 << 11,
        cand: Optional[int] = None,
        steps_per_call: Optional[int] = None,
        device=None,
        resume: Optional[dict] = None,
        queue_capacity: Optional[int] = None,
        spill_bloom_bits: Optional[int] = None,
        spill_dir: Optional[str] = None,
        spill_host_bytes: Optional[int] = None,
        sync: bool = False,
        devices: Optional[int] = None,
        n_devices: Optional[int] = None,
        frontier_capacity: int = 1 << 13,
        bucket_factor: int = 2,
        cand_factor: int = 4,
    ) -> "Checker":
        """Wavefront BFS on the GPU (``parallel/wavefront.py``).

        ``device=None`` means ``cuda``: with no CUDA device this raises and
        never falls back to the CPU.  Tests pass ``device="cpu"``, which
        runs every kernel's plain PyTorch version.  ``resume`` takes a
        snapshot from either engine (``convert.py``); ``queue_capacity``
        sets the queue's first high-water mark (JAX ``spawn_tpu``'s); the
        ``spill_*`` knobs size the tier of :meth:`spill`.  The light
        preflight audit (:meth:`audit`) runs first, before any buffer is
        allocated; :meth:`skip_audit` turns it off.  ``sync=True`` runs the
        engine on the caller's thread and returns the finished checker
        (JAX ``spawn_tpu(sync=True)``).

        Under :meth:`sweep` (or ``STATERIGHT_TPU_SWEEP``) this returns the
        sweep engine instead (JAX ``spawn_tpu`` :767-813), after one audit
        per distinct shape signature of the family; the ``spill_*`` knobs
        do not apply there.

        Under :meth:`mesh` (or ``STATERIGHT_TPU_MESH``) this returns the
        mesh engine (``parallel/mesh.py``) over the builder's devices on
        ``device``'s platform (JAX ``spawn_tpu`` :764-829); the ``spill_*``
        knobs do not apply there (the engine refuses ``.spill()``), and a
        sweep refuses the mesh.

        ``devices=N`` (or ``n_devices=N``, JAX's spelling) returns the
        sharded engine (``parallel/sharded.py``) over ``N`` shards, each
        fingerprint owned by one: ``capacity`` and ``frontier_capacity``
        are split over the shards, ``bucket_factor`` and ``cand_factor``
        size the route and the owner's candidate budget, and
        ``steps_per_call`` defaults to 16 there (JAX ``spawn_tpu``'s);
        ``devices=1`` is the single-device engine, as in JAX (``n_devices=1``
        stays sharded).  Without a process group all shards live on
        ``device``; under an initialized ``torch.distributed`` group each
        rank holds ``N / ranks`` of them on its own device."""
        from ..parallel.partition import resolve_mesh_flag
        from ..parallel.wavefront import GpuChecker
        from ..sweep import resolve_sweep_spec

        mesh_on, mesh_n = resolve_mesh_flag(self.mesh_mode,
                                            self.mesh_devices)
        spec = resolve_sweep_spec(self.sweep_spec, self.model)
        if spec is not None:
            if n_devices is not None or devices:
                raise NotImplementedError(
                    "sweeps run on the single-device engine for now — "
                    "drop the devices argument")
            if mesh_on:
                raise NotImplementedError(
                    "sweep x mesh is a queued unlock (ROADMAP): sweeps "
                    "run on the single-device engine for now — drop "
                    ".mesh()/--mesh/STATERIGHT_TPU_MESH"
                )
            return self._spawn_sweep(
                spec, capacity=capacity, batch=batch, cand=cand,
                steps_per_call=steps_per_call or 64, device=device,
                resume=resume, queue_capacity=queue_capacity, sync=sync)
        self._preflight_audit()
        if devices is not None and devices != 1 and n_devices is None:
            n_devices = devices
        if n_devices is not None:
            from ..parallel.sharded import ShardedGpuChecker

            return ShardedGpuChecker(
                self, n_devices=n_devices, capacity=capacity,
                frontier_capacity=frontier_capacity,
                bucket_factor=bucket_factor, cand_factor=cand_factor,
                sync=sync, steps_per_call=steps_per_call or 16,
                device=device, resume=resume)
        steps_per_call = steps_per_call or 64
        if mesh_on:
            # an explicit devices/n_devices argument stays the sharded
            # engine, even with the mesh flag armed (above)
            from ..parallel.mesh import MeshGpuChecker
            from ..parallel.partition import build_mesh

            mesh = (build_mesh(devices=mesh_n) if isinstance(mesh_n, list)
                    else build_mesh(mesh_n, device=device))
            return MeshGpuChecker(
                self, mesh=mesh, capacity=capacity, batch=batch, cand=cand,
                steps_per_call=steps_per_call, resume=resume,
                queue_capacity=queue_capacity, sync=sync,
            )
        return GpuChecker(
            self, capacity=capacity, batch=batch, cand=cand,
            steps_per_call=steps_per_call, device=device, resume=resume,
            queue_capacity=queue_capacity, spill_bloom_bits=spill_bloom_bits,
            spill_dir=spill_dir, spill_host_bytes=spill_host_bytes,
            sync=sync,
        )

    def serve(self, addr: str = "localhost:3000", strategy: str = "bfs",
              **spawn_kw):
        """Spawn a check and serve the Explorer web UI over it (reference
        ``checker.rs:108-114``; JAX ``checker/base.py:833-845``).
        ``strategy="gpu"`` browses a GPU wavefront run (JAX's ``"tpu"``);
        with it, extra keyword arguments pass through to ``spawn_gpu``
        (``device="cpu"`` runs the plain PyTorch path).  ``block=False``
        returns the running server."""
        from ..explorer import serve

        return serve(self, addr, strategy=strategy, **spawn_kw)

    def _spawn_sweep(self, spec, **kw) -> "Checker":
        """Audit once per distinct shape of the family (the cohort key:
        twin class, row layout, properties), since same-shape members
        share kernels, then spawn the sweep engine."""
        from ..sweep.cohort import shape_signature
        from ..sweep.engine import SweepChecker

        seen = set()
        for inst in spec.instances:
            try:
                sig = shape_signature(inst)
            except Exception:  # noqa: BLE001 - a twin's failure surfaces
                sig = id(inst)  # in its own audit below
            if sig in seen:
                continue
            seen.add(sig)
            saved = self.model
            self.model = inst.model
            try:
                self._preflight_audit()
            finally:
                self.model = saved
        return SweepChecker(self, spec, **kw)


class Checker:
    """Uniform result surface (reference ``checker.rs:185-338``)."""

    model: Model
    # the flight recorder (telemetry/), when the builder asked for one
    flight_recorder = None
    # the builder's report(PATH) and runs(DIR) (or STATERIGHT_TPU_RUN_DIR),
    # honoured at the first join() after completion on every strategy
    _report_path: Optional[str] = None
    _report_written = False
    _run_dir: Optional[str] = None
    _run_recorded = False
    _report_reentry = False
    # run identity: minted lazily, stamped into the report header, the
    # snapshot manifests and the registry index; parent_run_id is set by
    # a resume from a snapshot
    _run_id: Optional[str] = None
    parent_run_id: Optional[str] = None

    @property
    def run_id(self) -> str:
        """Stable unique id of this run (16 hex chars)."""
        if self._run_id is None:
            import uuid

            self._run_id = uuid.uuid4().hex[:16]
        return self._run_id

    def _maybe_write_report(self) -> None:
        """Write the builder's run report and archive the run into the
        registry, each exactly once, at the first join() after completion
        (JAX ``checker/base.py:881-931``).  Building the report
        reconstructs discovery paths, which joins and re-enters here: the
        registry waits for the body and reuses it."""
        if not self.is_done():
            return
        body = None
        if self._report_path and not self._report_written:
            self._report_written = True  # before writing: never retry a crash
            from ..telemetry.report import write_report

            self._report_reentry = True
            try:
                body = write_report(self, self._report_path)
            finally:
                self._report_reentry = False
        self._maybe_record_run(body)

    def _maybe_record_run(self, body=None) -> None:
        """Archive the completed run into the registry when one is
        configured; exactly once, never fatal to the join."""
        if self._run_recorded or self._report_reentry:
            return
        from ..telemetry.registry import RunRegistry, resolve_run_dir

        root = resolve_run_dir(self._run_dir)
        if not root:
            return
        self._run_recorded = True  # before writing: never retry a crash
        try:
            RunRegistry(root).record(self, body=body)
        except Exception as e:  # noqa: BLE001 - the ledger never breaks a join
            print(f"stateright-tpu-torch: run-registry write failed: "
                  f"{type(e).__name__}: {e}", file=sys.stderr)

    def cartography(self) -> Optional[dict]:
        """The search-cartography snapshot; None on the host checkers."""
        return None

    def memory(self, live: bool = True) -> Optional[dict]:
        """The memory-ledger snapshot; None on the host checkers."""
        return None

    def health(self) -> Optional[dict]:
        """The live health snapshot (``telemetry/health.py``), or None
        without telemetry."""
        rec = self.flight_recorder
        return None if rec is None else rec.health()

    def occupancy_stats(self) -> Optional[dict]:
        """The visited table's bucket occupancy; None on the host
        checkers."""
        return None

    # -- strategy-provided ---------------------------------------------------

    def state_count(self) -> int:
        """Total states generated, including duplicates."""
        raise NotImplementedError

    def unique_state_count(self) -> int:
        raise NotImplementedError

    def max_depth(self) -> int:
        return 0

    def discoveries(self) -> dict[str, Path]:
        """Property name -> discovered example/counterexample path."""
        raise NotImplementedError

    def join(self) -> "Checker":
        raise NotImplementedError

    def is_done(self) -> bool:
        raise NotImplementedError

    # -- shared --------------------------------------------------------------

    def discovery(self, name: str) -> Optional[Path]:
        return self.discoveries().get(name)

    def discovery_classification(self, name: str) -> str:
        """"example" or "counterexample" (reference ``checker.rs:245-252``)."""
        exp = self.model.property_by_name(name).expectation
        return "example" if exp == Expectation.SOMETIMES else "counterexample"

    def report(self, stream=None) -> "Checker":
        """Block until done, printing 1 Hz progress then a final ``sec=`` line
        and discoveries (reference ``checker.rs:217-242``)."""
        stream = stream or sys.stdout
        start = time.monotonic()
        last = 0.0
        while not self.is_done():
            now = time.monotonic()
            if now - last >= 1.0:
                print(
                    f"Checking. states={self.state_count()}, "
                    f"unique={self.unique_state_count()}",
                    file=stream,
                )
                last = now
            time.sleep(0.05)
        self.join()
        sec = max(time.monotonic() - start, 1e-9)
        print(
            f"Done. states={self.state_count()}, "
            f"unique={self.unique_state_count()}, sec={sec:.6g}",
            file=stream,
        )
        for name, path in sorted(self.discoveries().items()):
            cls = self.discovery_classification(name)
            print(f'Discovered "{name}" {cls} {path!r}', file=stream)
        return self

    # -- assertions (reference ``checker.rs:256-338``) -----------------------

    def assert_properties(self) -> None:
        for prop in self.model.properties():
            if prop.expectation == Expectation.SOMETIMES:
                self.assert_any_discovery(prop.name)
            else:
                self.assert_no_discovery(prop.name)

    def assert_any_discovery(self, name: str) -> Path:
        path = self.discovery(name)
        if path is None:
            raise AssertionError(f"Missing discovery for {name!r}.")
        return path

    def assert_no_discovery(self, name: str) -> None:
        path = self.discovery(name)
        if path is not None:
            raise AssertionError(
                f"Unexpected \"{name}\" "
                f"{self.discovery_classification(name)} {path!r}"
            )

    def assert_discovery(self, name: str, actions: Sequence) -> None:
        """Assert a discovery exists and that ``actions`` is one valid witness
        trace, by re-executing the model (reference ``checker.rs:293-338``)."""
        self.assert_any_discovery(name)
        prop = self.model.property_by_name(name)
        model = self.model
        last_err = f"no init state admits the action sequence {list(actions)!r}"
        for init in model.init_states():
            path = Path.from_actions(model, init, actions)
            if path is None:
                continue
            final = path.final_state()
            if prop.expectation == Expectation.ALWAYS:
                if prop.condition(model, final):
                    raise AssertionError(
                        f"path does not violate always property {name!r}")
                return
            if prop.expectation == Expectation.SOMETIMES:
                if not prop.condition(model, final):
                    raise AssertionError(
                        f"path does not satisfy sometimes property {name!r}")
                return
            # an EVENTUALLY counterexample: no state along the maximal path
            # satisfies the condition, and the path ends in a terminal state
            if any(prop.condition(model, s) for s in path.states()):
                raise AssertionError(
                    f"path satisfies eventually property {name!r}")
            if model.next_steps(final):
                raise AssertionError(
                    f"path for eventually property {name!r} does not end "
                    "terminal")
            return
        raise AssertionError(last_err)


class ParentPointerTrace:
    """Path reconstruction for checkers whose visited map stores
    ``child_fp -> parent_fp`` with root sentinel 0 (the host BFS;
    reference ``bfs.rs:314-342``).  Requires ``self.model``,
    ``self._generated`` (the parent-pointer map) and ``self._discoveries``
    (property name -> discovery fp)."""

    def _trace(self, fp: int) -> list[int]:
        fps = [fp]
        while True:
            parent = self._generated.get(fps[-1], 0)
            if parent == 0:
                break
            fps.append(parent)
        fps.reverse()
        return fps

    def discoveries(self) -> dict[str, Path]:
        return {
            name: Path.from_fingerprints(self.model, self._trace(fp))
            for name, fp in dict(self._discoveries).items()
        }


def evaluate_properties(
    model, props: Sequence[Property], discoveries: dict, state, ebits, token
):
    """Per-state property evaluation (reference ``bfs.rs:192-227``): record
    always-counterexamples and sometimes-examples under ``token`` (first
    writer wins), clear satisfied eventually bits.  Returns the updated
    ebits."""
    for i, prop in enumerate(props):
        if prop.expectation is Expectation.ALWAYS:
            if prop.name not in discoveries and not prop.condition(model, state):
                discoveries.setdefault(prop.name, token)
        elif prop.expectation is Expectation.SOMETIMES:
            if prop.name not in discoveries and prop.condition(model, state):
                discoveries.setdefault(prop.name, token)
        elif i in ebits and prop.condition(model, state):
            ebits = ebits - {i}
    return ebits


def flush_terminal_ebits(
    props: Sequence[Property], discoveries: dict, ebits, token
) -> None:
    """Liveness bits still set at a terminal state are counterexamples
    (reference ``bfs.rs:265-272``)."""
    for i in ebits:
        discoveries.setdefault(props[i].name, token)


def init_ebits(properties: Sequence[Property]) -> frozenset[int]:
    """Initial liveness bits: one per ``eventually`` property, set at path
    start, cleared when satisfied; bits still set at a terminal state flush
    as counterexamples (reference ``checker.rs:341-348``).  As in the
    reference, the bits are not part of the fingerprint, which can miss
    counterexamples on DAG joins and cycles (``bfs.rs:239-257``)."""
    return frozenset(
        i for i, p in enumerate(properties)
        if p.expectation == Expectation.EVENTUALLY
    )
