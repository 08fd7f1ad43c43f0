"""The flight recorder: bounded ring of structured records + aggregates.

The port's own copy of ``stateright_tpu/telemetry/recorder.py``.  The
schema keeps every record kind and feature block of the JAX package (the
sweep engine, ``sweep/engine.py``, writes the ``sweep`` records
``cohort_compile``, ``instance_done`` and ``summary``; the fleet scheduler,
``fleet/scheduler.py``, the ``fleet`` and ``job`` records and the pool
snapshot of :meth:`FlightRecorder.set_fleet`), so a JSONL written by either
package reads in the other.

Record schema (every record):

 - ``seq``  — monotone sequence number (never reset; ``seq - len(records)``
   is how many old records the ring evicted)
 - ``t``    — seconds since the recorder was created (monotonic clock)
 - ``kind`` — ``"step"`` | ``"growth"`` | ``"occupancy"`` | ``"compile"``
   | ``"profile"`` | ``"health"`` | ``"cartography"`` | ``"memory"``
   | ``"roofline"`` | ``"checkpoint"`` | ``"fault"`` | ``"restart"``
   | ``"sweep"`` | ``"fleet"`` | ``"job"`` | ``"span"`` | ``"spill"``
   | ``"note"``

``step`` records additionally carry the engine tag and cumulative counters
(``states``, ``unique``) plus derived per-step deltas (``d_states``,
``d_unique``, ``dedup``, ``dt``) computed against the previous step record
— so each record is self-contained for streaming consumers (the Explorer's
``/.metrics`` sparkline reads them directly).

Aggregate counters (transfer bytes, compile-cache hits, growth/compaction
events) live OUTSIDE the ring so eviction never loses totals; they fold
into :meth:`FlightRecorder.summary`.

Thread safety: engines record from their run thread while the Explorer
polls from HTTP handler threads — every mutation and snapshot takes the
internal lock.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Optional

from .health import HealthTracker

# Growth-record status vocabulary: the port's GPU engine's status words
# (``parallel/wavefront.py``, which maps its numeric codes onto these
# names next to their definitions).  The JAX package's sharded words
# (``frontier_full``, ``bucket_full``) come with that engine.
STATUS_NAMES = frozenset({
    "ok", "queue_full", "table_full", "cand_full", "poison", "spill_sync",
})


class FlightRecorder:
    """Bounded, thread-safe run-telemetry recorder.

    ``capacity`` bounds the ring buffer (oldest records evicted); aggregate
    counters are unbounded scalars.  ``meta`` is carried verbatim into
    :meth:`summary` and the JSONL header (engine tag, model name, run
    configuration).
    """

    def __init__(self, capacity: int = 4096, meta: Optional[dict] = None,
                 metrics=None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self.meta = dict(meta or {})
        # live metrics bus (telemetry/metrics.py): None (the default)
        # detaches publication entirely — step() adds nothing, the
        # parity pin.  ``metrics=`` attaches a bus explicitly;
        # STATERIGHT_TPU_METRICS=1 attaches the process default bus.
        if metrics is None:
            import os as _os

            if _os.environ.get("STATERIGHT_TPU_METRICS") == "1":
                from .metrics import default_bus

                metrics = default_bus()
        self._bus = metrics
        self._bus_fams: Optional[dict] = None
        self._fleet_fams: Optional[dict] = None
        # monotone-counter baselines for fleet snapshots (set_fleet
        # publishes deltas of cumulative pool tallies)
        self._fleet_pub = {"completed": 0, "preemptions": 0}
        # span-structured tracing (telemetry/spans.py): the engine binds
        # its run span here so step/profile records carry its id
        self._bound_span: Optional[str] = None
        self._records: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._t0 = time.monotonic()
        self._seq = 0
        self._counters: dict[str, float] = {}
        # per-kind totals survive ring eviction (the ring is a window, the
        # counts are the truth)
        self._kind_counts: dict[str, int] = {}
        # last step snapshot for delta derivation: (t, states, unique)
        self._last_step: Optional[tuple] = None
        # the full last step record, for O(1) live readers (--watch polls
        # several times a second; scanning the ring would hold the lock
        # across a list copy of up to ``capacity`` dicts each poll)
        self._last_step_rec: Optional[dict] = None
        # wall-clock origin for summary(): recorder creation (t=0), so
        # work done before the FIRST step record (init + first compiled
        # block) is not silently excluded from the throughput denominator.
        # JSONL replay shifts it to reproduce the exported wall time.
        self._t_offset = 0.0
        # progress/health model (health.py): fed by every step record;
        # phase/stall TRANSITIONS are emitted back into the ring as
        # ``health`` records.  JSONL replay suppresses regeneration (the
        # exported events replay verbatim instead).
        self._health = HealthTracker()
        self._replaying = False
        # latest search-cartography snapshot (ops/cartography.py); lives
        # OUTSIDE the ring like the aggregate counters, so eviction never
        # loses it.  The engines refresh it per host sync.
        self._cartography: Optional[dict] = None
        # latest HBM-ledger snapshot (telemetry/memory.py): same
        # outside-the-ring discipline; setting it also arms the health
        # model's growth_oom_risk forecast
        self._memory: Optional[dict] = None
        # latest spill-tier snapshot (stateright_tpu/spill/): same
        # discipline again; the engines refresh it per eviction /
        # resolution / sync
        self._spill: Optional[dict] = None
        # latest roofline-ledger snapshot (telemetry/roofline.py):
        # static per-stage FLOPs/bytes + reconciliation + verdicts;
        # set once at spawn (the static model cannot change mid-run)
        self._roofline: Optional[dict] = None
        # latest durability snapshot (stateright_tpu/checkpoint.py:
        # autosave cadence/generations + supervised restart count); same
        # outside-the-ring discipline
        self._durability: Optional[dict] = None
        # latest fleet pool/queue snapshot (stateright_tpu/fleet/): slot
        # occupancy, queued/running/terminal job keys; same discipline —
        # the scheduler refreshes it on every placement transition and
        # the Explorer's pool panel reads it off ``/.metrics``
        self._fleet: Optional[dict] = None
        # in-band stall-injection seam (fleet.PreemptionPlan): called with
        # the step ordinal inside step(), so a due injection lands its
        # ``health`` record on the step that crosses the threshold (a
        # polling injector can lose the race against a short run)
        self._stall_inject: Optional[Callable[[int], Optional[str]]] = None

    # -- metrics bus (telemetry/metrics.py) ----------------------------------

    @property
    def metrics_bus(self):
        """The attached live-metrics bus, or None (publication off)."""
        return self._bus

    def _engine_fams(self) -> dict:
        if self._bus_fams is None:
            from .metrics import engine_families

            self._bus_fams = engine_families(self._bus)
        return self._bus_fams

    def _engine_labels(self, engine: Optional[str] = None) -> dict:
        return {
            "engine": str(engine or self.meta.get("engine", "?")),
            "model": str(self.meta.get("model", "?")),
        }

    def _bus_drop(self, e: BaseException) -> None:
        """Publication must never break a run: detach the bus and leave
        one note in the ring saying why."""
        self._bus = None
        self._append_unlocked("note", {
            "what": "metrics bus detached",
            "error": f"{type(e).__name__}: {e}",
        })

    def _publish_step_unlocked(self, rec: dict) -> None:
        if self._bus is None:
            return
        try:
            fam = self._engine_fams()
            labels = self._engine_labels(rec.get("engine"))
            fam["states"].inc(int(rec.get("d_states") or 0), **labels)
            fam["unique"].inc(int(rec.get("d_unique") or 0), **labels)
            dt = float(rec.get("dt") or 0.0)
            if dt > 0:
                fam["sps"].set(
                    round((rec.get("d_states") or 0) / dt, 1), **labels
                )
                fam["step"].observe(dt, **labels)
            q = rec.get("queue", rec.get("frontier"))
            if isinstance(q, (int, float)):
                fam["frontier"].set(q, **labels)
            if rec.get("load_factor") is not None:
                fam["load"].set(float(rec["load_factor"]), **labels)
            if rec.get("dedup") is not None:
                fam["dedup"].set(float(rec["dedup"]), **labels)
        except Exception as e:  # noqa: BLE001 - never break the run
            self._bus_drop(e)

    def _publish_record_unlocked(self, kind: str, rec: dict) -> None:
        """Non-step families sampled off ring records that already
        happen: occupancy gauges off ``occupancy`` records, the mesh
        shard-imbalance gauge off ``mesh`` records (docs/mesh.md), the
        roofline block off the ``roofline`` record."""
        if self._bus is None or kind not in ("occupancy", "mesh",
                                             "roofline"):
            return
        try:
            if kind == "roofline":
                from .metrics import roofline_families

                rf = roofline_families(self._bus)
                labels = self._engine_labels(rec.get("engine"))
                for stage, v in (rec.get("stages") or {}).items():
                    fl, by = int(v.get("flops", 0)), int(v.get("bytes", 0))
                    rf["flops"].set(fl, stage=stage, **labels)
                    rf["bytes"].set(by, stage=stage, **labels)
                    if by:
                        rf["intensity"].set(round(fl / by, 6), stage=stage,
                                            **labels)
                return
            fam = self._engine_fams()
            labels = self._engine_labels()
            if kind == "occupancy" and rec.get("load_factor") is not None:
                fam["occupancy"].set(float(rec["load_factor"]), **labels)
            elif kind == "mesh":
                imb = rec.get("imbalance") or {}
                v = imb.get("max_over_mean", imb.get("ratio"))
                if v is not None:
                    fam["imbalance"].set(float(v), **labels)
        except Exception as e:  # noqa: BLE001 - never break the run
            self._bus_drop(e)

    # -- span binding (telemetry/spans.py) -----------------------------------

    def bind_span(self, span_id: Optional[str]) -> None:
        """Bind the engine-run span: subsequent step records (and the
        profiler's ``profile`` events) carry ``span=<id>`` so the Chrome
        exporter can nest step blocks under the run span."""
        with self._lock:
            self._bound_span = span_id

    def bound_span(self) -> Optional[str]:
        with self._lock:
            return self._bound_span

    # -- recording -----------------------------------------------------------

    def _append_unlocked(
        self, kind: str, fields: dict, t: Optional[float] = None
    ) -> dict:
        """Append one record; caller holds the lock."""
        self._seq += 1
        self._kind_counts[kind] = self._kind_counts.get(kind, 0) + 1
        rec = {
            "seq": self._seq,
            "t": round(self._now() if t is None else t, 6),
            "kind": kind,
            **fields,
        }
        self._records.append(rec)
        return rec

    def record(self, kind: str, *, t: Optional[float] = None, **fields) -> dict:
        """Append one record; returns it (the stored dict)."""
        with self._lock:
            rec = self._append_unlocked(kind, fields, t)
            if not self._replaying:
                self._publish_record_unlocked(kind, rec)
            return rec

    def step(self, *, engine: str, states: int, unique: int,
             t: Optional[float] = None, **fields) -> dict:
        """One per-step (per host-sync / per-batch) record.  ``states`` and
        ``unique`` are CUMULATIVE run counters; deltas and the dedup ratio
        (fraction of generated states that were already visited) are
        derived here against the previous step record."""
        with self._lock:
            # rounded BEFORE use so a JSONL round-trip (which stores the
            # rounded value) reproduces the summary bit-for-bit
            now = round(self._now() if t is None else t, 6)
            if self._last_step is None:
                prev_t, prev_states, prev_unique = now, 0, 0
            else:
                prev_t, prev_states, prev_unique = self._last_step
            # cumulative counters are monotone by meaning, but concurrent
            # pool workers read-then-record without a common lock, so a
            # late writer can arrive with a stale (smaller) snapshot —
            # clamp so deltas stay >= 0 and the final summary never
            # under-reports
            states = max(int(states), prev_states)
            unique = max(int(unique), prev_unique)
            d_states = states - prev_states
            d_unique = unique - prev_unique
            if (
                self._bound_span is not None
                and not self._replaying
                and "span" not in fields
            ):
                # the engine-run span's id: the Chrome exporter nests
                # this step block under its lane (telemetry/spans.py)
                fields = {**fields, "span": self._bound_span}
            self._last_step = (now, states, unique)
            self._last_step_rec = rec = self._append_unlocked(
                "step",
                {
                    "engine": engine,
                    "dt": round(max(now - prev_t, 0.0), 6),
                    "states": int(states),
                    "unique": int(unique),
                    "d_states": int(d_states),
                    "d_unique": int(d_unique),
                    "dedup": (
                        round(1.0 - d_unique / d_states, 6)
                        if d_states > 0
                        else 0.0
                    ),
                    **fields,
                },
                t=now,
            )
            if not self._replaying:
                # the health model rides the step stream; transitions
                # (phase change, stall start/end) become ``health`` records
                # so exports carry the timeline.  Replays skip this — the
                # exported events come back verbatim instead.
                for ev in self._health.update(rec):
                    self._append_unlocked("health", ev, t=now)
                # live metrics bus: the per-sync engine families sample
                # the SAME host-synced values this record already holds
                # (zero extra device round-trips; telemetry/metrics.py)
                self._publish_step_unlocked(rec)
                if self._stall_inject is not None:
                    why = self._stall_inject(self._kind_counts["step"])
                    if why:
                        for ev in self._health.force_stall(why):
                            self._append_unlocked("health", ev, t=now)
            return rec

    def add(self, counter: str, n: float = 1) -> None:
        """Bump an aggregate counter (ring-independent; never evicted)."""
        with self._lock:
            self._counters[counter] = self._counters.get(counter, 0) + n

    def amend(self, rec: dict, **fields) -> None:
        """Update a previously returned record in place (under the lock:
        the Explorer may be snapshotting concurrently).  Used for values
        that are only measurable after the record's moment — e.g. a
        ``compile`` event recorded at engine acquisition whose duration is
        the NEXT device call's measured compile time (the lazy-jit path
        pays the compile there, not at acquisition)."""
        with self._lock:
            rec.update(fields)

    def add_bytes(self, *, h2d: int = 0, d2h: int = 0) -> None:
        if h2d:
            self.add("h2d_bytes", int(h2d))
        if d2h:
            self.add("d2h_bytes", int(d2h))

    def set_cartography(self, snap: dict) -> None:
        """Replace the latest search-cartography snapshot (the engines
        call this once per host sync with cumulative counters)."""
        with self._lock:
            self._cartography = dict(snap)

    def cartography(self) -> Optional[dict]:
        """Latest search-cartography snapshot, or None when the run was
        spawned without ``.telemetry(cartography=True)``."""
        with self._lock:
            return dict(self._cartography) if self._cartography else None

    def set_memory(self, snap: dict) -> None:
        """Replace the latest memory-ledger snapshot
        (``telemetry/memory.py``) and feed its growth forecast to the
        health model (the ``growth_oom_risk`` condition evaluates on the
        next step record's table load)."""
        with self._lock:
            self._memory = dict(snap)
            self._health.set_memory_forecast(
                (snap.get("next_rung") or {}).get("transient_bytes"),
                snap.get("budget_bytes"),
            )

    def memory(self) -> Optional[dict]:
        """Latest memory-ledger snapshot, or None when the run was
        spawned without ``.telemetry(memory=True)``."""
        with self._lock:
            return dict(self._memory) if self._memory else None

    def set_spill(self, snap: dict) -> None:
        """Replace the latest spill-tier snapshot (per-tier bytes, Bloom
        load, deferral/resolution tallies — ``docs/spill.md``)."""
        with self._lock:
            self._spill = dict(snap)
            if self._bus is not None and snap.get("spilled_fps") is not None:
                try:
                    self._engine_fams()["spilled"].set(
                        int(snap["spilled_fps"]), **self._engine_labels()
                    )
                except Exception as e:  # noqa: BLE001 - never break a run
                    self._bus_drop(e)

    def spill(self) -> Optional[dict]:
        """Latest spill-tier snapshot, or None when the run was spawned
        without ``CheckerBuilder.spill()``."""
        with self._lock:
            return dict(self._spill) if self._spill else None

    def set_roofline(self, snap: dict) -> None:
        """Replace the roofline-ledger snapshot (``telemetry/roofline.py``:
        per-stage FLOPs/bytes, op classes, MXU-candidate ranking,
        XLA-reconciliation verdict)."""
        with self._lock:
            self._roofline = dict(snap)

    def roofline(self) -> Optional[dict]:
        """Latest roofline snapshot, or None when the run was spawned
        without ``.telemetry(roofline=True)``."""
        with self._lock:
            return dict(self._roofline) if self._roofline else None

    def set_spill_armed(self, armed: bool = True) -> None:
        """Tell the health model the spill tier is armed: the
        ``growth_oom_risk`` condition downgrades to the informational
        ``spill_forecast`` — the run will evict, not die."""
        with self._lock:
            self._health.spill_armed = bool(armed)

    def set_spill_degraded(self) -> None:
        """The spill store's disk tier failed (ENOSPC / dead disk,
        docs/robustness.md): emit the sticky ``spill_degraded`` health
        transition (once) — the tier is pinned in host RAM."""
        with self._lock:
            for ev in self._health.mark_spill_degraded():
                self._append_unlocked("health", ev)

    def set_durability(self, snap: Optional[dict]) -> None:
        """Replace the latest durability snapshot
        (``stateright_tpu/checkpoint.py`` autosave status + supervised
        restart count; docs/robustness.md) — the outside-the-ring
        discipline of the other feature blocks.  ``None`` clears it
        (autosave disarmed after arming, e.g. the sharded engine's
        multi-controller fence)."""
        with self._lock:
            self._durability = dict(snap) if snap else None

    def durability(self) -> Optional[dict]:
        """Latest durability snapshot, or None when the run has neither
        autosave armed nor a supervision trail."""
        with self._lock:
            return dict(self._durability) if self._durability else None

    def set_fleet(self, snap: Optional[dict]) -> None:
        """Replace the latest fleet pool/queue snapshot (``fleet/``: slot
        occupancy + queued/terminal job keys) — the outside-the-ring
        discipline of the other feature blocks — and publish the fleet
        metric families from it when a bus is attached.  ``None`` clears
        it."""
        with self._lock:
            self._fleet = dict(snap) if snap else None
            if self._bus is None or not snap:
                return
            try:
                if self._fleet_fams is None:
                    # the sibling telemetry module, not the fleet package
                    # (no engine-side module imports the fleet)
                    from . import metrics as _metrics

                    self._fleet_fams = _metrics.fleet_families(self._bus)
                fam = self._fleet_fams
                fam["queue"].set(len(snap.get("queued") or ()))
                fam["busy"].set(len(snap.get("running") or ()))
                if snap.get("slots") is not None:
                    fam["slots"].set(int(snap["slots"]))
                # cumulative pool tallies publish as monotone deltas
                for key in ("completed", "preemptions"):
                    cur = int(snap.get(key) or 0)
                    prev = self._fleet_pub[key]
                    if cur > prev:
                        fam[key].inc(cur - prev)
                        self._fleet_pub[key] = cur
            except Exception as e:  # noqa: BLE001 - never break the pool
                self._bus_drop(e)

    def fleet(self) -> Optional[dict]:
        """Latest fleet pool/queue snapshot, or None when this recorder
        does not belong to a fleet scheduler."""
        with self._lock:
            return dict(self._fleet) if self._fleet else None

    def health(self) -> dict:
        """Live progress/health snapshot (health.py): phase, stall flag,
        novelty rate, EWMA throughput, drain ETA."""
        with self._lock:
            return self._health.snapshot()

    def arm_stall_injection(
        self, fn: Optional[Callable[[int], Optional[str]]]
    ) -> None:
        """Arm the in-band injection seam: ``fn(step_ordinal)`` runs inside
        every :meth:`step` (under the lock: keep it cheap and free of
        reentry), and a truthy return forces that reason's stall
        transition on the same step."""
        with self._lock:
            self._stall_inject = fn

    def close_run(self, done: bool = True) -> None:
        """Mark the run finished: the health phase transitions to ``done``
        (emitting the closing ``health`` record)."""
        if not done:
            return
        with self._lock:
            if self._replaying:
                return
            for ev in self._health.mark_done():
                self._append_unlocked("health", ev)

    def update_meta(self, **fields) -> None:
        """Locked meta mutation (engines annotate run config mid-run while
        the Explorer may be snapshotting concurrently)."""
        with self._lock:
            self.meta.update(fields)

    def meta_snapshot(self) -> dict:
        with self._lock:
            return dict(self.meta)

    # -- reading -------------------------------------------------------------

    def _now(self) -> float:
        return time.monotonic() - self._t0

    @property
    def t0_monotonic(self) -> float:
        """The recorder's clock origin (``time.monotonic()`` at
        creation).  The JSONL header carries it so a MERGED multi-run
        export (one fleet: scheduler + jobs + attempts) can re-align
        every run's relative timestamps onto one shared timeline —
        within a process the monotonic clock is common, so the
        alignment is exact (telemetry/export.py)."""
        return self._t0

    def rel(self, monotonic_t: float) -> float:
        """Map an absolute ``time.monotonic()`` stamp onto this recorder's
        clock (used when records are replayed from another process's log,
        e.g. the mp-BFS per-round history)."""
        return monotonic_t - self._t0

    def records(self, kind: Optional[str] = None) -> list[dict]:
        """Snapshot of the ring (oldest first), optionally filtered."""
        with self._lock:
            recs = list(self._records)
        if kind is not None:
            recs = [r for r in recs if r["kind"] == kind]
        return recs

    def kind_count(self, kind: str) -> int:
        """TOTAL records of ``kind`` ever appended — unlike ``records()``,
        this survives ring eviction (the ring is a window, the counts are
        the truth).  Consumers compare it against ``len(records(kind))``
        to detect a truncated window (telemetry/report.py)."""
        with self._lock:
            return int(self._kind_counts.get(kind, 0))

    def last_step(self) -> Optional[dict]:
        """The most recent step record (a copy), without scanning the
        ring — the ``--watch`` line polls this several times a second."""
        with self._lock:
            return dict(self._last_step_rec) if self._last_step_rec else None

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)

    @property
    def dropped(self) -> int:
        """Records evicted by the ring bound."""
        with self._lock:
            return self._seq - len(self._records)

    def counters(self) -> dict:
        with self._lock:
            return dict(self._counters)

    def stages(self) -> Optional[dict]:
        """Per-stage wall-time breakdown (docs/perf.md): the ``stage_*_secs``
        aggregate counters the device engines accumulate (compile / device /
        growth), plus the host remainder, against the recorder's wall clock.
        None when no engine recorded stage counters (host checkers, or a
        recorder predating the attribution round).  ``host_secs`` is
        everything not attributed to a named stage — trace reconstruction,
        snapshot service, loop bookkeeping, and clock skew; a large value
        here is itself a finding."""
        with self._lock:
            counters = dict(self._counters)
            last_step = self._last_step
            t_offset = self._t_offset
        names = {
            k[len("stage_"):-len("_secs")]: float(v)
            for k, v in counters.items()
            if k.startswith("stage_") and k.endswith("_secs")
        }
        if not names:
            return None
        wall = None
        if last_step is not None:
            wall = max(last_step[0] - t_offset, 0.0)
        out = {f"{k}_secs": round(v, 6) for k, v in sorted(names.items())}
        if wall is not None:
            out["wall_secs"] = round(wall, 6)
            out["host_secs"] = round(max(wall - sum(names.values()), 0.0), 6)
        return out

    def summary(self) -> dict:
        """Aggregate run summary (JSON-safe scalars + small dicts): totals,
        throughput, dedup ratio, event counts, transfer volume, and the
        first/last occupancy samples when any were taken."""
        with self._lock:
            recs = list(self._records)
            counters = dict(self._counters)
            kind_counts = dict(self._kind_counts)
            seq = self._seq
            last_step = self._last_step
            t_offset = self._t_offset
            meta = dict(self.meta)
            cartography = (
                dict(self._cartography) if self._cartography else None
            )
            memory = dict(self._memory) if self._memory else None
            spill = dict(self._spill) if self._spill else None
            roofline = dict(self._roofline) if self._roofline else None
            durability = (
                dict(self._durability) if self._durability else None
            )
            fleet = dict(self._fleet) if self._fleet else None
        occ = [r for r in recs if r["kind"] == "occupancy"]
        out: dict = {
            **meta,
            "records": seq,
            "ring_len": len(recs),
            "dropped": seq - len(recs),
            "steps": kind_counts.get("step", 0),
        }
        if last_step is not None:
            t_last, states, unique = last_step
            # wall runs from recorder creation (not the first step record):
            # states found before the first host sync must pay their time
            wall = max(t_last - t_offset, 0.0)
            out["states"] = int(states)
            out["unique"] = int(unique)
            out["wall_secs"] = round(wall, 6)
            out["states_per_sec"] = (
                round(states / wall, 1) if wall > 0 else None
            )
            out["dedup_ratio"] = (
                round(1.0 - unique / states, 6) if states > 0 else 0.0
            )
        out["growth_events"] = kind_counts.get("growth", 0)
        for key in ("h2d_bytes", "d2h_bytes", "compile_cache_hits",
                    "compile_cache_misses", "compaction_hits"):
            out[key] = int(counters.get(key, 0))
        for key in ("prewarm_scheduled", "prewarm_consumed"):
            if counters.get(key):
                out[key] = int(counters[key])
        stages = self.stages()
        if stages is not None:
            out["stages"] = stages
        if cartography is not None:
            out["cartography"] = cartography
        if memory is not None:
            out["memory"] = memory
        if spill is not None:
            out["spill"] = spill
        if roofline is not None:
            out["roofline"] = roofline
        if durability is not None:
            out["durability"] = durability
        if fleet is not None:
            out["fleet"] = fleet
        if occ:
            keep = ("occupied", "load_factor", "max_bucket", "full_buckets",
                    "poisson_full_expect", "nbuckets")
            out["occupancy_samples"] = len(occ)
            out["occupancy_first"] = {
                k: occ[0].get(k) for k in keep if k in occ[0]
            }
            out["occupancy_last"] = {
                k: occ[-1].get(k) for k in keep if k in occ[-1]
            }
        return out

    def _reconcile_totals(self, summary: dict) -> None:
        """Restore totals the ring window cannot reconstruct from an
        exported summary (``export.from_jsonl``): sequence/kind counts and
        the cumulative step snapshot, so a round-trip through a file whose
        ring had evicted records still reproduces ``summary()``."""
        with self._lock:
            self._seq = max(self._seq, int(summary.get("records", 0)))
            for kind, key in (("step", "steps"),
                              ("growth", "growth_events")):
                if key in summary:
                    self._kind_counts[kind] = max(
                        self._kind_counts.get(kind, 0), int(summary[key])
                    )
            if summary.get("cartography") and self._cartography is None:
                self._cartography = dict(summary["cartography"])
            if summary.get("memory") and self._memory is None:
                self._memory = dict(summary["memory"])
            if summary.get("spill") and self._spill is None:
                self._spill = dict(summary["spill"])
            if summary.get("roofline") and self._roofline is None:
                self._roofline = dict(summary["roofline"])
            if summary.get("durability") and self._durability is None:
                self._durability = dict(summary["durability"])
            if summary.get("fleet") and self._fleet is None:
                self._fleet = dict(summary["fleet"])
            if summary.get("states") is not None and self._last_step:
                last_t = self._last_step[0]
                self._last_step = (
                    last_t, int(summary["states"]), int(summary["unique"])
                )
                if summary.get("wall_secs") is not None:
                    self._t_offset = last_t - float(summary["wall_secs"])

    def _reset_step_baseline(self) -> None:
        """Start a fresh delta baseline (JSONL replay at a run boundary:
        the next run's cumulative counters restart from zero and must not
        be clamped against the previous run's totals)."""
        with self._lock:
            self._last_step = None

    # -- export (see export.py) ----------------------------------------------

    def to_jsonl(self, path, append: bool = False) -> None:
        from .export import to_jsonl

        to_jsonl(self, path, append=append)

    def to_chrome_trace(self, path) -> None:
        from .export import to_chrome_trace

        to_chrome_trace(self, path)

    @classmethod
    def from_jsonl(cls, path) -> "FlightRecorder":
        from .export import from_jsonl

        return from_jsonl(path)
