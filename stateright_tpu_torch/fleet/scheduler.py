"""The fleet multiplexer: many tenants' checks over one card.

The port's own copy of ``stateright_tpu/fleet/scheduler.py``.  One
:class:`FleetScheduler` takes a :class:`~stateright_tpu_torch.fleet.spec.
FleetSpec` and drives every job to a terminal state through four moves:

 1. **place** — admission control prices each job's engine footprint
    with the memory ledger's ``capacity_plan`` ladder (the port's own
    analytic buffers, ``parallel/wavefront.memory_spec_fn``) against the
    per-slot byte budget: a job whose ladder cannot reach its demand is
    REFUSED, or, with ``spill=True``, routed through the host spill tier
    (``admitted_spill``) instead;
 2. **pack** — admitted small jobs marked ``packable`` group by the
    sweep layer's ``shape_signature`` into sweep cohorts: one sweep engine
    serves the whole group (``engine_compiles`` strictly below the member
    count); jobs that cannot unify, or a cohort that fails at run time,
    fall back to singleton runs LOUDLY (a stderr line and a
    ``pack_fallback`` reason on the ring record), never silently;
 3. **supervise** — every singleton runs under ``supervise()``: retry
    with backoff on classified transient failures, graceful OOM
    degradation, autosave generations under ``<root>/jobs/<slug>``, where
    the job's ``progress.json`` heartbeat lands too;
 4. **preempt** — a per-slot monitor watches the running job's health
    ring EDGE-triggered (``stall`` / ``growth_oom_risk`` transitions;
    the tracker recomputes ``stalled`` per step, so a level probe would
    miss the pulse): when a signal fires and other work is queued, the
    monitor sets the supervision ``yield_event``; the engine stops at
    its next host sync, writing one final autosave generation, the slot
    drains to the next queued unit, and the preempted job re-queues.  Its
    next run resumes from that generation with ``parent_run_id`` lineage,
    as a crash-resume would (``_cli compare parent child
    --expect=IDENTICAL`` is the exactly-once gate).

Scheduling is priority-ordered (max-heap on ``Job.priority``, FIFO
within a priority) with ``slots`` concurrent workers: threads, each
driving its own engine on the one card (engines share no buffers; the
kernel wrappers' launch counters are exact under threads).  Every job
runs on ``cuda`` unless the scheduler's ``device`` or the job's
``spawn_kw`` says ``"cpu"``; with no card a ``cuda`` job fails, it never
falls back.  The scheduler narrates itself on its own flight recorder:
versioned ``fleet`` / ``job`` ring records (submit/place/pack/preempt/
resume/done) and a live pool/queue snapshot (``rec.set_fleet``) that the
Explorer's ``/.metrics`` serves.

Nothing here is imported by the engines: with no fleet in play the step
dispatches exactly the operations it would without this package (pinned
by tests/test_torch_fleet.py).
"""

from __future__ import annotations

import heapq
import os
import re
import sys
import tempfile
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

from .spec import (
    ADMITTED,
    ADMITTED_SPILL,
    COMPLETED,
    FAILED,
    FLEET_V,
    REFUSED,
    FleetSpec,
    JobResult,
)

#: the health transitions that trigger a preemption:
#: a stalled run is not making progress, a growth_oom_risk run is about
#: to pay a transient the slot may not survive — both are better
#: snapshot-and-yielded while other tenants wait.
PREEMPT_EVENTS = ("stall", "growth_oom_risk")


def _slug(key: str) -> str:
    """Filesystem-safe job directory name."""
    return re.sub(r"[^A-Za-z0-9._-]+", "-", str(key)) or "job"


@dataclass
class FleetResult:
    """Every job's terminal outcome plus the pool-level accounting."""

    results: dict  # key -> JobResult, spec order
    slots: int
    secs: float = 0.0
    packed: list = field(default_factory=list)
    # engine-compile accounting: exact for cohort-packed units (the
    # sweep engine counts its compiles), a LOWER BOUND for singletons
    # (one per spawn; growth rungs within a run are not re-counted here)
    engine_compiles: int = 0
    preemptions: int = 0
    recorder: object = None

    def __getitem__(self, key: str) -> JobResult:
        return self.results[key]

    @property
    def completed(self) -> int:
        return sum(
            1 for r in self.results.values() if r.status == COMPLETED
        )

    @property
    def failed(self) -> int:
        return sum(1 for r in self.results.values() if r.status == FAILED)

    @property
    def refused(self) -> int:
        return sum(1 for r in self.results.values() if r.status == REFUSED)

    def to_json(self) -> dict:
        return {
            "v": FLEET_V,
            "slots": self.slots,
            "secs": round(self.secs, 3),
            "completed": self.completed,
            "failed": self.failed,
            "refused": self.refused,
            "preemptions": self.preemptions,
            "engine_compiles": self.engine_compiles,
            "packed": [dict(p) for p in self.packed],
            "jobs": [r.to_json() for r in self.results.values()],
        }


class _Unit:
    """One schedulable queue entry (a singleton job or a packed cohort).
    Heap order: highest priority first, submit order within a
    priority.  A re-queued preempted unit takes a FRESH sequence — it
    lands behind already-queued work of equal priority, which is the
    whole point of yielding the slot."""

    def __init__(self, priority: int, seq: int):
        self._sort = (-int(priority), int(seq))
        self._span = None  # open job span for the current episode

    def __lt__(self, other: "_Unit") -> bool:
        return self._sort < other._sort


class _Singleton(_Unit):
    def __init__(self, job, decision: str, reason: Optional[str],
                 seq: int):
        super().__init__(job.priority, seq)
        self.job = job
        self.decision = decision
        self.reason = reason
        self.label = job.key
        self.preemptions = 0
        self.secs = 0.0
        self.compiles = 0
        self.live = None  # the attempt's checker, for the slot monitor
        self.slot: Optional[int] = None


class _Packed(_Unit):
    def __init__(self, jobs, cohort_id: str, seq: int):
        super().__init__(max(j.priority for j in jobs), seq)
        self.jobs = jobs
        self.cohort_id = cohort_id
        self.label = cohort_id
        self.secs = 0.0


class FleetScheduler:
    """Drive a :class:`FleetSpec` to completion; see the module doc for
    the policy.  ``root`` holds per-job autosave generations
    (``<root>/jobs/<slug>``); ``recorder`` receives the fleet/job ring
    records (a fresh one is allocated when omitted — read it back off
    :attr:`FleetResult.recorder`); ``preemption`` is the deterministic
    stall-injection plan (tests/smokes;
    :class:`~stateright_tpu_torch.fleet.spec.PreemptionPlan`);
    ``every_secs`` is the per-job autosave cadence (0 = every host
    sync, the chaos-test cadence: preemption needs a recent
    generation to be cheap); ``device`` is every job's ``spawn_gpu``
    device unless the job's ``spawn_kw`` names one (None: ``cuda``)."""

    def __init__(
        self,
        spec: FleetSpec,
        *,
        root: Optional[str] = None,
        recorder=None,
        preemption=None,
        every_secs: float = 0.0,
        backoff_base: float = 0.05,
        backoff_max: float = 0.5,
        stream=None,
        device=None,
    ):
        if not isinstance(spec, FleetSpec):
            raise TypeError(f"FleetScheduler wants a FleetSpec: {spec!r}")
        self.spec = spec
        self.root = root or tempfile.mkdtemp(
            prefix="stateright-tpu-torch-fleet-")
        if recorder is None:
            from ..telemetry import FlightRecorder

            recorder = FlightRecorder(
                capacity=4096, meta={"engine": "fleet"}
            )
        self.rec = recorder
        self.preemption = preemption
        self.every_secs = float(every_secs)
        self.backoff_base = float(backoff_base)
        self.backoff_max = float(backoff_max)
        self.stream = stream if stream is not None else sys.stderr
        self.device = device
        self._cv = threading.Condition()
        self._heap: list = []
        self._seq = 0
        self._pending = 0
        self._results: dict = {}
        self._running: dict = {}
        self._preemptions = 0
        self._engine_compiles = 0
        self._packed_summary: list = []
        self._ran = False
        # span-trace root (telemetry/spans.py): minted at run() — every
        # job span (and its attempt/engine_run descendants) parents
        # under it, so one Chrome-trace load shows the whole campaign
        self._span_root_ctx = None
        # pool-level heartbeat (checkpoint.ProgressHeartbeat): an atomic
        # <root>/progress.json the status CLI tails — including after a
        # SIGKILL of the whole fleet process
        from ..checkpoint import ProgressHeartbeat

        # an uncreatable root (e.g. a file squatting on the path) is the
        # ledger's loud-degradation case, not a heartbeat crash — run
        # without the pool heartbeat and let the ledger report it
        try:
            os.makedirs(self.root, exist_ok=True)
            self._pool_hb = ProgressHeartbeat(
                self.root, meta={"engine": "fleet", "pid": os.getpid()},
            )
        except OSError:
            self._pool_hb = None

    # -- plumbing ------------------------------------------------------------

    def _say(self, msg: str) -> None:
        if self.stream is not None:
            print(f"stateright-tpu-torch: fleet: {msg}", file=self.stream)

    def _record_job(self, key: str, event: str, **fields) -> None:
        clean = {k: v for k, v in fields.items() if v is not None}
        self.rec.record("job", v=FLEET_V, event=event, key=str(key),
                        **clean)

    def _job_dir(self, job) -> str:
        return os.path.join(self.root, "jobs", _slug(job.key))

    def _push(self, unit: _Unit, fresh: bool) -> None:
        with self._cv:
            heapq.heappush(self._heap, unit)
            if fresh:
                self._pending += 1
            self._cv.notify_all()

    def _finish_unit(self) -> None:
        with self._cv:
            self._pending -= 1
            self._cv.notify_all()

    def _work_waiting(self) -> bool:
        with self._cv:
            return bool(self._heap)

    def _publish(self, final: bool = False) -> None:
        """The live pool/queue snapshot behind ``/.metrics``'s fleet
        block and the Explorer's pool panel.  Also publishes the fleet
        metric families (the recorder's ``set_fleet`` hook) and beats
        the pool heartbeat (throttled; ``final`` forces a terminal
        write)."""
        with self._cv:
            snap = {
                "v": FLEET_V,
                "slots": int(self.spec.slots),
                "jobs": len(self.spec.jobs),
                "running": sorted(self._running.values()),
                "queued": [u.label for u in sorted(self._heap)],
                "completed": sum(
                    1 for r in self._results.values()
                    if r.status == COMPLETED
                ),
                "preemptions": int(self._preemptions),
            }
        self.rec.set_fleet(snap)
        if self._pool_hb is None:
            return
        self._pool_hb.beat(
            None,
            status="done" if final else "running",
            force=final,
            slots=snap["slots"],
            jobs=snap["jobs"],
            running=len(snap["running"]),
            queued=len(snap["queued"]),
            completed=snap["completed"],
            preemptions=snap["preemptions"],
        )

    def _count_admission(self, decision: str) -> None:
        """One admission-outcome tick on the fleet metrics bus (when one
        is attached to the fleet recorder); decisions are a tiny closed
        vocabulary, so the label stays under the cardinality cap."""
        bus = getattr(self.rec, "metrics_bus", None)
        if bus is None:
            return
        try:
            from ..telemetry.metrics import fleet_families

            fleet_families(bus)["admissions"].inc(
                1, decision=str(decision)
            )
        except Exception:  # noqa: BLE001 - metrics never crash the pool
            pass

    # -- admission (place) ---------------------------------------------------

    def _admit(self, job) -> tuple:
        """``(decision, reason, builder)``: the capacity ladder priced
        against the slot budget (JAX :319).  No budget known ⇒ admit
        (the capacity verb's degrade rule: analytic admission needs a
        wall to check against); plan failure ⇒ admit loudly (admission is
        a gatekeeper, not a new crash surface)."""
        from ..parallel.tensor_model import twin_or_none

        builder = job.build()
        twin = twin_or_none(builder.model)
        if twin is None:
            # host checkers hold states in host RAM: no HBM ladder to
            # price, nothing for the slot budget to refuse
            return ADMITTED, "no device twin (host-side check)", builder
        kw = self._engine_kw(job)
        device = str(kw.get("device") or "cuda")
        cuda = device.startswith("cuda")
        budget = self.spec.slot_budget_bytes
        if budget is None:
            from ..telemetry.memory import device_budget

            budget = device_budget(device if cuda else "cpu")[0]
        if budget is None:
            return ADMITTED, "no device budget known", builder
        from ..parallel.wavefront import default_caps, memory_spec_fn
        from ..telemetry.memory import GROWTH_LOAD_DENOM, capacity_plan

        cap = int(kw.get("capacity", 1 << 12))
        caps = default_caps(cap, int(kw.get("batch", 256)), kw.get("cand"),
                            kw.get("queue_capacity"))
        spec_fn = memory_spec_fn(
            twin, len(list(builder.model.properties())), cuda=cuda)

        try:
            plan = capacity_plan(spec_fn, caps, budget=int(budget),
                                 rungs=24)
        except Exception as e:  # noqa: BLE001 - admission never crashes
            return (
                ADMITTED,
                f"capacity plan failed ({type(e).__name__}); admitted "
                "unpriced",
                builder,
            )
        rungs = plan.get("rungs") or []
        if rungs and rungs[0].get("fits") is False:
            return (
                REFUSED,
                f"start rung ({rungs[0]['transient_bytes']}B transient) "
                f"exceeds the slot budget ({int(budget)}B)",
                builder,
            )
        demand = builder.target_state_count or cap // GROWTH_LOAD_DENOM
        reach = plan.get("max_unique")
        if reach is not None and demand > reach:
            if self.spec.spill:
                return (
                    ADMITTED_SPILL,
                    f"hot ladder reaches {reach} < demand {demand}: "
                    "routed through the host spill tier",
                    builder,
                )
            return (
                REFUSED,
                f"ladder reach {reach} below demand {demand} "
                "(FleetSpec(spill=True) would route it --spill)",
                builder,
            )
        return ADMITTED, None, builder

    # -- packing (pack) ------------------------------------------------------

    def _engine_kw(self, job) -> dict:
        """The job's spawn keywords with the scheduler's ``device``
        filled in where the job names none."""
        kw = job.engine_kw()
        if self.device is not None:
            kw.setdefault("device", self.device)
        return kw

    def _pack(self, admitted: list) -> tuple:
        """Group admitted ``packable`` jobs by the sweep layer's
        ``shape_signature`` (JAX :397); ``(packed_units,
        leftover_jobs)``.  Only
        plain-admitted jobs pack (the sweep engine rejects spill), and a
        signature failure demotes to singleton LOUDLY."""
        from ..sweep.cohort import shape_signature
        from ..sweep.spec import SweepInstance

        groups: dict = {}
        leftover = []
        for job, decision, reason in admitted:
            if not (self.spec.pack and job.packable
                    and decision == ADMITTED):
                leftover.append((job, decision, reason))
                continue
            try:
                b = job.build()
                sig = shape_signature(
                    SweepInstance(job.key, b.model, params=job.params)
                )
            except Exception as e:  # noqa: BLE001 - loud singleton
                self._say(
                    f"job {job.key!r} cannot cohort-pack "
                    f"({type(e).__name__}: {e}); running as a singleton"
                )
                leftover.append((job, decision, "pack_fallback"))
                continue
            groups.setdefault(sig, []).append((job, decision, reason))
        units = []
        for i, (_sig, members) in enumerate(groups.items()):
            if len(members) < 2:
                leftover.extend(members)
                continue
            jobs = [m[0] for m in members]
            cid = f"pack-{i}"
            units.append((jobs, cid))
        return units, leftover

    # -- the drive -----------------------------------------------------------

    def run(self) -> FleetResult:
        if self._ran:
            raise RuntimeError(
                "a FleetScheduler drives its spec once; build a new one"
            )
        self._ran = True
        t0 = time.monotonic()
        from ..telemetry.spans import start_span

        # the trace root: one fleet campaign = one trace; every job /
        # attempt / engine_run span below parents into it
        fleet_span = start_span("fleet")
        self._span_root_ctx = fleet_span.ctx
        self.rec.record(
            "fleet", v=FLEET_V, event="start",
            slots=int(self.spec.slots), jobs=len(self.spec.jobs),
        )
        admitted = []
        for job in self.spec.jobs:
            self._record_job(job.key, "submit", priority=job.priority)
            decision, reason, _builder = self._admit(job)
            self._count_admission(decision)
            if decision == REFUSED:
                self._say(f"job {job.key!r} refused: {reason}")
                self._results[job.key] = JobResult(
                    key=job.key, status=REFUSED, decision=REFUSED,
                    reason=reason, params=job.params,
                )
                self._record_job(job.key, "done", status=REFUSED,
                                 reason=reason)
                continue
            self._record_job(job.key, "place", decision=decision,
                             reason=reason)
            admitted.append((job, decision, reason))
        packed, singles = self._pack(admitted)
        for jobs, cid in packed:
            for j in jobs:
                self._record_job(j.key, "pack", cohort=cid,
                                 jobs=len(jobs))
            self._push(_Packed(jobs, cid, self._next_seq()), fresh=True)
        for job, decision, reason in singles:
            self._push(
                _Singleton(job, decision, reason, self._next_seq()),
                fresh=True,
            )
        self._publish()
        n_workers = min(int(self.spec.slots), max(self._pending, 1))
        workers = [
            threading.Thread(
                target=self._worker, args=(slot,), daemon=True,
                name=f"fleet-slot-{slot}",
            )
            for slot in range(n_workers)
        ]
        for w in workers:
            w.start()
        for w in workers:
            w.join()
        secs = time.monotonic() - t0
        # spec order, refused included — the ledger reads like the spec
        ordered = {
            j.key: self._results[j.key]
            for j in self.spec.jobs if j.key in self._results
        }
        self.rec.record(
            "fleet", v=FLEET_V, event="done",
            slots=int(self.spec.slots), jobs=len(self.spec.jobs),
            completed=sum(1 for r in ordered.values()
                          if r.status == COMPLETED),
            failed=sum(1 for r in ordered.values()
                       if r.status == FAILED),
            refused=sum(1 for r in ordered.values()
                        if r.status == REFUSED),
            preemptions=int(self._preemptions),
            engine_compiles=int(self._engine_compiles),
            packed=len(self._packed_summary),
        )
        fleet_span.end(
            self.rec, jobs=len(self.spec.jobs),
            slots=int(self.spec.slots),
        )
        self._publish(final=True)
        return FleetResult(
            results=ordered, slots=int(self.spec.slots), secs=secs,
            packed=list(self._packed_summary),
            engine_compiles=int(self._engine_compiles),
            preemptions=int(self._preemptions), recorder=self.rec,
        )

    def _next_seq(self) -> int:
        with self._cv:
            self._seq += 1
            return self._seq

    def _worker(self, slot: int) -> None:
        from ..telemetry.spans import start_span

        while True:
            with self._cv:
                while not self._heap and self._pending > 0:
                    self._cv.wait(0.05)
                if not self._heap:
                    return
                unit = heapq.heappop(self._heap)
                self._running[slot] = unit.label
                # one job span per SCHEDULING EPISODE on a slot: a
                # preempted job re-queues and gets a fresh span next time —
                # the trace shows each residency separately, gaps included.
                # The slot closes its own handle: the unit re-queues before
                # this episode ends, and an idle slot may take it (and
                # open the next episode) at once (JAX :553-554 closes
                # whatever span the unit holds, which can be the next
                # episode's, and that slot's thread then dies)
                span = unit._span = start_span(
                    "job", parent=self._span_root_ctx)
            self._publish()
            try:
                if isinstance(unit, _Packed):
                    self._run_packed(unit, slot)
                else:
                    self._run_singleton(unit, slot)
            finally:
                span.end(self.rec, key=unit.label, slot=slot)
                with self._cv:
                    if unit._span is span:
                        unit._span = None
                    self._running.pop(slot, None)
                    self._cv.notify_all()
                self._publish()

    # -- singleton runs (supervise + preempt) --------------------------------

    def _run_singleton(self, unit: _Singleton, slot: int) -> None:
        from ..checkpoint import latest_gen_number
        from ..supervisor import supervise

        job = unit.job
        unit.slot = slot
        job_dir = self._job_dir(job)
        if unit.preemptions:
            self._record_job(
                job.key, "resume", slot=slot,
                gen=latest_gen_number(job_dir),
            )
        builder = job.build()
        if unit._span is not None:
            # the supervisor's attempt spans (and through them the
            # engine_run spans) parent under this episode's job span
            builder._span_ctx = unit._span.ctx
        from ..parallel.tensor_model import twin_or_none

        if twin_or_none(builder.model) is None \
                and hasattr(builder, "spawn_bfs"):
            # no device twin: serve the check on the host engine when
            # the builder offers one (doubles without a host strategy
            # keep the device path they stand in for)
            self._run_host(unit, slot, builder)
            return
        if unit.decision == ADMITTED_SPILL:
            builder.spill()
        if builder.telemetry_opts is None:
            # the slot monitor reads the job's health ring; a job with
            # no recorder could never be preempted by signal
            builder.telemetry()
        yield_event = threading.Event()
        mon_stop = threading.Event()
        unit.live = None

        def _spawn(b, resume=None, **kw):
            c = b.spawn_gpu(resume=resume, **kw)
            unit.compiles += 1
            if self.spec.campaign_id:
                c._campaign_id = self.spec.campaign_id
                c._job_key = job.key
            rec = getattr(c, "flight_recorder", None)
            if rec is not None and self.preemption is not None:
                # in-band injection: a due stall lands its health record
                # on the step that crosses the threshold, while the run
                # is still going — a polling injector can lose that race
                # against a short run (the monitor then preempts off the
                # record, exactly as it would for a detected stall)
                key = job.key
                rec.arm_stall_injection(
                    lambda n: "injected"
                    if self.preemption.due(key, n) else None
                )
            unit.live = c
            return c

        mon = threading.Thread(
            target=self._monitor, args=(unit, yield_event, mon_stop),
            daemon=True, name=f"fleet-monitor-{slot}",
        )
        mon.start()
        t0 = time.monotonic()
        try:
            sup = supervise(
                builder, autosave_dir=job_dir,
                every_secs=self.every_secs,
                max_restarts=self.spec.max_restarts,
                backoff_base=self.backoff_base,
                backoff_max=self.backoff_max,
                yield_event=yield_event, spawn=_spawn,
                **self._engine_kw(job),
            )
        except Exception as e:  # noqa: BLE001 - a job failure is a
            # ledger row, never the fleet's crash
            unit.secs += time.monotonic() - t0
            reason = f"{type(e).__name__}: {e}"
            self._say(f"job {job.key!r} failed: {reason}")
            self._results[job.key] = JobResult(
                key=job.key, status=FAILED, decision=unit.decision,
                slot=slot, preemptions=unit.preemptions,
                secs=unit.secs, reason=reason, params=job.params,
            )
            with self._cv:
                self._engine_compiles += unit.compiles
            self._record_job(job.key, "done", status=FAILED, slot=slot,
                             reason=reason)
            self._finish_unit()
            return
        finally:
            mon_stop.set()
        unit.secs += time.monotonic() - t0
        if sup.yielded:
            unit.preemptions += 1
            with self._cv:
                self._preemptions += 1
            self._record_job(
                job.key, "preempt", slot=slot,
                gen=latest_gen_number(job_dir),
                unique=int(sup.unique_state_count()),
            )
            self._say(
                f"job {job.key!r} preempted on slot {slot} "
                f"(snapshot gen {latest_gen_number(job_dir)}); re-queued"
            )
            unit.live = None
            # fresh sequence: the preempted job queues BEHIND waiting
            # work of equal priority — that is what the yield bought
            unit._sort = (-int(job.priority), self._next_seq())
            self._push(unit, fresh=False)
            return
        checker = sup.checker
        res = JobResult(
            key=job.key, status=COMPLETED, decision=unit.decision,
            unique=int(sup.unique_state_count()),
            states=int(sup.state_count()),
            max_depth=int(sup.max_depth()),
            discoveries=sorted(sup.discoveries().keys()),
            run_id=checker.run_id,
            parent_run_id=getattr(checker, "parent_run_id", None),
            slot=slot, preemptions=unit.preemptions,
            restarts=int(sup.restarts), secs=unit.secs,
            reason=unit.reason, params=job.params,
        )
        self._results[job.key] = res
        with self._cv:
            self._engine_compiles += unit.compiles
        self._record_job(
            job.key, "done", status=COMPLETED, slot=slot,
            unique=res.unique, states=res.states, run_id=res.run_id,
            parent_run_id=res.parent_run_id,
        )
        self._finish_unit()

    def _run_host(self, unit: _Singleton, slot: int, builder) -> None:
        """Twin-less jobs run the HOST BFS engine in their slot,
        unsupervised (the packed-cohort rule): there is no HBM engine
        to autosave/resume and no health ring to preempt by — the slot
        is still accounted, and a failure stays a ledger row."""
        job = unit.job
        unit.slot = slot
        t0 = time.monotonic()
        try:
            # async spawn, tag, THEN join (the _run_packed rule): the
            # worker thread registers the run at join
            checker = builder.spawn_bfs()
            if self.spec.campaign_id:
                checker._campaign_id = self.spec.campaign_id
                checker._job_key = job.key
            checker.join()
            res = JobResult(
                key=job.key, status=COMPLETED, decision=unit.decision,
                unique=int(checker.unique_state_count()),
                states=int(checker.state_count()),
                max_depth=int(checker.max_depth()),
                discoveries=sorted(checker.discoveries().keys()),
                run_id=checker.run_id, slot=slot,
                secs=time.monotonic() - t0,
                reason=unit.reason, params=job.params,
            )
            self._record_job(
                job.key, "done", status=COMPLETED, slot=slot,
                unique=res.unique, states=res.states, run_id=res.run_id,
            )
        except Exception as e:  # noqa: BLE001 - a job failure is a
            # ledger row, never the fleet's crash
            reason = f"{type(e).__name__}: {e}"
            self._say(f"job {job.key!r} failed: {reason}")
            res = JobResult(
                key=job.key, status=FAILED, decision=unit.decision,
                slot=slot, secs=time.monotonic() - t0, reason=reason,
                params=job.params,
            )
            self._record_job(job.key, "done", status=FAILED, slot=slot,
                             reason=reason)
        self._results[job.key] = res
        self._finish_unit()

    def _monitor(self, unit: _Singleton, yield_event, mon_stop) -> None:
        """The slot's preemption monitor: EDGE-triggered on the job
        recorder's ``health`` ring (stall/growth_oom_risk transitions),
        per-attempt watermarked (each resume spawns a fresh recorder,
        restarting ``seq``).  Fires the yield only when other work is
        actually queued — preempting into an idle pool would pay the
        snapshot for nothing.  Deterministic injections arrive through
        the same ring: ``_spawn`` arms ``rec.arm_stall_injection`` with
        the plan, the due step emits a real stall record in-band, and
        this edge path preempts — injection never bypasses the
        machinery it tests."""
        marks: dict = {}
        while not mon_stop.is_set() and not yield_event.is_set():
            c = unit.live
            rec = getattr(c, "flight_recorder", None) \
                if c is not None else None
            if rec is not None:
                wm = marks.get(id(rec), -1)
                fired = False
                for r in rec.records("health"):
                    seq = int(r.get("seq", 0))
                    if seq <= wm:
                        continue
                    wm = max(wm, seq)
                    if r.get("event") not in PREEMPT_EVENTS:
                        continue
                    # an INJECTED stall always preempts (the chaos
                    # harness must exercise the yield path even when
                    # the queue happens to be drained); organic signals
                    # preempt only when other work actually waits
                    if (r.get("reason") == "injected"
                            or self._work_waiting()):
                        fired = True
                        break
                marks[id(rec)] = wm
                if fired:
                    yield_event.set()
                    return
            mon_stop.wait(0.01)

    # -- packed cohort runs --------------------------------------------------

    def _run_packed(self, unit: _Packed, slot: int) -> None:
        from ..sweep.spec import SweepInstance, SweepSpec

        jobs = unit.jobs
        t0 = time.monotonic()
        try:
            builder = jobs[0].build()
            if unit._span is not None:
                builder._span_ctx = unit._span.ctx
            if builder.telemetry_opts is None:
                builder.telemetry()
            insts = []
            for j in jobs:
                b = j.build()
                insts.append(SweepInstance(
                    j.key, b.model, params=j.params,
                    target=b.target_state_count,
                ))
            builder.sweep(SweepSpec(insts))
            cap = max(int(j.capacity) for j in jobs)
            batch = max(int(j.batch) for j in jobs)
            devices = {self._engine_kw(j).get("device") for j in jobs}
            if len(devices) > 1:
                raise ValueError(
                    f"members ask for devices {sorted(map(str, devices))}")
            # async spawn, tag, THEN join: the sweep engine registers
            # its per-instance runs at join() in async mode; a sync
            # spawn would register them before the campaign tag lands
            checker = builder.spawn_gpu(capacity=cap, batch=batch,
                                        device=devices.pop())
            if self.spec.campaign_id:
                checker._campaign_id = self.spec.campaign_id
            checker.join()
        except Exception as e:  # noqa: BLE001 - the loud singleton
            # fallback: a cohort that cannot run must not sink its
            # members with it
            secs = time.monotonic() - t0
            self._say(
                f"cohort {unit.cohort_id} fell back to singletons "
                f"({type(e).__name__}: {e}); re-queueing "
                f"{len(jobs)} jobs"
            )
            with self._cv:
                self._pending += len(jobs) - 1
            for j in jobs:
                self._record_job(j.key, "place", decision=ADMITTED,
                                 reason="pack_fallback")
                u = _Singleton(j, ADMITTED, "pack_fallback",
                               self._next_seq())
                u.secs = secs / len(jobs)
                self._push(u, fresh=False)
            return
        secs = time.monotonic() - t0
        unit.secs += secs
        compiles = int(getattr(checker, "engine_compiles", 0) or 0)
        with self._cv:
            self._engine_compiles += compiles
        self._packed_summary.append({
            "cohort": unit.cohort_id,
            "jobs": [j.key for j in jobs],
            "engine_compiles": compiles,
            "secs": round(secs, 3),
        })
        for j in jobs:
            r = checker.results[j.key]
            res = JobResult(
                key=j.key, status=COMPLETED, decision=ADMITTED,
                unique=int(r.unique), states=int(r.states),
                max_depth=int(r.max_depth),
                discoveries=sorted(
                    checker.instance_discoveries(j.key).keys()
                ),
                run_id=checker.instance_run_id(j.key), slot=slot,
                cohort=unit.cohort_id, secs=secs, params=j.params,
            )
            self._results[j.key] = res
            self._record_job(
                j.key, "done", status=COMPLETED, slot=slot,
                cohort=unit.cohort_id, unique=res.unique,
                states=res.states, run_id=res.run_id,
            )
        self._finish_unit()


def run_fleet(spec: FleetSpec, **kw) -> FleetResult:
    """One-call form: schedule ``spec`` and return the
    :class:`FleetResult` (``FleetScheduler(spec, **kw).run()``)."""
    return FleetScheduler(spec, **kw).run()
