"""Progress & run-health model: is the search converging or silently
stalling?

The port's own copy of ``stateright_tpu/telemetry/health.py``; the
``growth_oom_risk`` threshold is the port's ``memory.OOM_RISK_LOAD``.

A host-side model over the flight recorder's step stream — no device ops,
no extra transfers (the same overhead contract as the rest of telemetry).
Every :meth:`FlightRecorder.step` feeds :class:`HealthTracker.update`;
phase/stall *transitions* are emitted back into the ring as ``health``
records (so JSONL/Chrome-trace exports carry the health timeline), and
:meth:`FlightRecorder.health` returns the live snapshot (the Explorer's
``/.metrics`` and the ``--watch`` line read it).

Two kinds of signals, deliberately separated:

 - **Count-derived** (deterministic for a fixed run): the novelty rate
   (fresh inserts / generated states per step), the fresh-insert trend
   against its peak, and the coarse completion phase
   ``expanding | peaking | draining | done``.  These are safe to put in
   the deterministic run report (telemetry/report.py).
 - **Wall-clock-derived** (vary run to run): EWMA throughput and the
   drain-ETA estimate.  Live surfaces only — never in the report body.

Stall detection: ``stall_after`` consecutive steps with zero fresh inserts
while the frontier/queue is non-empty (the engine is spinning without
discovering), or the table load pinned at the growth threshold (≥25%
would have triggered growth; riding just under it for many steps means
the growth policy is thrashing).  A stall is a *flag with a reason*, not
a phase — a stalled run still has a phase.
"""

from __future__ import annotations

from typing import Optional

from .memory import OOM_RISK_LOAD

# health snapshot / event schema version
HEALTH_V = 1

PHASES = ("expanding", "peaking", "draining", "done")

# table load just under the engines' 25% growth trigger counts as "pinned"
_PINNED_LOAD = 0.245


class HealthTracker:
    """Incremental health model over step records.

    ``alpha`` is the EWMA smoothing factor for throughput;
    ``stall_after`` the number of consecutive zero-novelty steps (with a
    non-empty frontier) that flags a stall.  NOT thread-safe on its own —
    the recorder calls it under its lock."""

    def __init__(self, alpha: float = 0.3, stall_after: int = 5):
        self.alpha = alpha
        self.stall_after = stall_after
        self.steps = 0
        self.phase = "expanding"
        self.stalled = False
        self.stall_reason: Optional[str] = None
        # growth-OOM risk (telemetry/memory.py): armed by the memory
        # ledger's forecast — the next growth rung's migration transient
        # vs the device budget; flagged once the table load is close
        # enough to the growth trigger that the migration is imminent
        self.oom_risk = False
        # spill tier armed (docs/spill.md): the same forecast condition
        # is INFORMATIONAL — the run will evict to the host tier at the
        # boundary, not die — so it surfaces as ``spill_forecast``
        # instead of ``growth_oom_risk`` (recorder.set_spill_armed)
        self.spill_armed = False
        # spill disk tier lost (ENOSPC/dead disk; docs/robustness.md):
        # sticky for the run — the tier is pinned in host RAM, so
        # capacity headroom shrank (recorder.set_spill_degraded)
        self.spill_degraded = False
        self._mem_next_transient: Optional[int] = None
        self._mem_budget: Optional[int] = None
        self._zero_novel = 0  # consecutive d_unique == 0 steps
        self._pinned = 0  # consecutive load-at-threshold steps
        self._peak_d_unique = 0
        self._last = None  # last step record fields we care about
        self._ewma_sps: Optional[float] = None
        # smoothed NET queue-drain rate (rows/sec the queue actually
        # shrinks by): the drain ETA divides by this, NOT the fresh-insert
        # rate — the queue empties at the pop rate minus the insert rate,
        # and during draining the fresh rate tends to zero by definition
        # (dividing by it would overestimate the ETA without bound)
        self._ewma_drain: Optional[float] = None
        self._prev_queue: Optional[float] = None

    # -- feeding -------------------------------------------------------------

    def set_memory_forecast(
        self,
        next_transient_bytes: Optional[int],
        budget_bytes: Optional[int],
    ) -> None:
        """Arm the ``growth_oom_risk`` condition with the memory ledger's
        forecast (``telemetry/memory.py``): the next table rung's
        migration transient and the device budget.  Either value absent
        (CPU, ledger off) disarms the condition entirely."""
        self._mem_next_transient = (
            int(next_transient_bytes) if next_transient_bytes else None
        )
        self._mem_budget = int(budget_bytes) if budget_bytes else None

    def update(self, rec: dict) -> list:
        """Fold one step record in; returns the ``health`` EVENTS to emit
        (phase changes and stall transitions — transitions only, so the
        ring stays sparse)."""
        self.steps += 1
        d_states = int(rec.get("d_states") or 0)
        d_unique = int(rec.get("d_unique") or 0)
        dt = float(rec.get("dt") or 0.0)
        queue = rec.get("queue", rec.get("frontier"))
        load = rec.get("load_factor")

        if dt > 0:
            sps = d_states / dt
            self._ewma_sps = (
                sps if self._ewma_sps is None
                else self.alpha * sps + (1 - self.alpha) * self._ewma_sps
            )

        if isinstance(queue, (int, float)):
            if dt > 0 and self._prev_queue is not None:
                obs = max((self._prev_queue - queue) / dt, 0.0)
                self._ewma_drain = (
                    obs if self._ewma_drain is None
                    else self.alpha * obs + (1 - self.alpha) * self._ewma_drain
                )
            self._prev_queue = float(queue)

        self._peak_d_unique = max(self._peak_d_unique, d_unique)
        phase = self._classify(d_states, d_unique)

        # -- stall detection ------------------------------------------------
        # engines without a cheap frontier *count* (sharded: only a
        # replicated keep-going flag crosses to the host) send ``busy``
        # explicitly; otherwise an empty queue is completion-shaped
        flag = rec.get("busy")
        if flag is not None:
            busy = bool(flag)
        else:
            busy = queue is None or (
                isinstance(queue, (int, float)) and queue > 0
            )
        if d_unique == 0 and d_states > 0 and busy:
            self._zero_novel += 1
        else:
            self._zero_novel = 0
        if load is not None and float(load) >= _PINNED_LOAD:
            self._pinned += 1
        else:
            self._pinned = 0
        stalled, reason = False, None
        if self._zero_novel >= self.stall_after:
            stalled, reason = True, "no_fresh_inserts"
        elif self._pinned >= self.stall_after:
            stalled, reason = True, "load_pinned_at_growth_threshold"

        # growth-OOM risk: the table load has crossed half-way to the
        # growth trigger (the migration is imminent, not hypothetical)
        # and the ledger's forecast says the next rung's transient does
        # not fit the device.  A *flag with a forecast*, like the stall:
        # the run keeps going, but the operator should checkpoint or
        # re-plan before the growth boundary hits the wall.
        oom = bool(
            self._mem_next_transient
            and self._mem_budget
            and load is not None
            and float(load) >= OOM_RISK_LOAD
            and self._mem_next_transient > self._mem_budget
        )

        events = []
        if oom != self.oom_risk:
            self.oom_risk = oom
            if self.spill_armed:
                # informational: the next rung spills to the host tier
                name = "spill_forecast" if oom else "spill_forecast_cleared"
            else:
                name = "growth_oom_risk" if oom else "growth_oom_risk_cleared"
            events.append({"event": name, "phase": self.phase})
        if phase != self.phase:
            self.phase = phase
            events.append({"event": "phase", "phase": phase})
        # a reason SWITCH while already stalled (fresh insert clears the
        # novelty counter on a step where the load counter is already
        # over threshold) re-emits ``stall`` with the new reason — the
        # live badge and timeline must name the actual cause; a stall
        # span still closes at the next ``stall_cleared``
        if stalled != self.stalled or (
            stalled and reason != self.stall_reason
        ):
            self.stalled, self.stall_reason = stalled, reason
            events.append({
                "event": "stall" if stalled else "stall_cleared",
                "phase": self.phase,
                **({"reason": reason} if reason else {}),
            })
        self._last = {
            "d_states": d_states, "d_unique": d_unique, "dt": dt,
            "queue": queue, "load": load,
        }
        return [{"v": HEALTH_V, **e} for e in events]

    def force_stall(self, reason: str = "injected") -> list:
        """Manufacture a ``stall`` transition (JAX
        ``telemetry/health.py:206``; deterministic preemption injection,
        ``fleet.PreemptionPlan`` through the recorder's
        ``arm_stall_injection`` seam): it flips the flag as detection
        would, so everything downstream of the transition (the ring
        record, the live badge, the fleet scheduler's preemption monitor)
        runs the real path.  The next step record with fresh
        inserts recomputes the flag and emits the paired
        ``stall_cleared``, like any detected stall."""
        if self.stalled and self.stall_reason == reason:
            return []
        self.stalled, self.stall_reason = True, str(reason)
        return [{
            "v": HEALTH_V, "event": "stall", "phase": self.phase,
            "reason": str(reason),
        }]

    def mark_spill_degraded(self) -> list:
        """The spill store's disk tier failed (ENOSPC / dead disk): one
        sticky ``spill_degraded`` transition — the run continues with the
        tier pinned in host RAM, and the operator should know the
        capacity headroom shrank."""
        if self.spill_degraded:
            return []
        self.spill_degraded = True
        return [{
            "v": HEALTH_V, "event": "spill_degraded", "phase": self.phase,
        }]

    def mark_done(self) -> list:
        """The run completed: close the phase timeline.  An active stall
        is closed first with its ``stall_cleared`` transition — consumers
        pair stall/stall_cleared events, so a finished run must never
        leave one open."""
        events = []
        if self.stalled:
            self.stalled, self.stall_reason = False, None
            events.append({"event": "stall_cleared", "phase": self.phase})
        if self.oom_risk:
            # a finished run grew no further: the risk span closes with
            # the run, like an open stall
            self.oom_risk = False
            events.append({
                "event": (
                    "spill_forecast_cleared" if self.spill_armed
                    else "growth_oom_risk_cleared"
                ),
                "phase": self.phase,
            })
        if self.phase != "done":
            self.phase = "done"
            events.append({"event": "phase", "phase": "done"})
        return [{"v": HEALTH_V, **e} for e in events]

    # -- classification (count-derived: deterministic per run) ---------------

    def _classify(self, d_states: int, d_unique: int) -> str:
        if self.phase == "done":
            return "done"
        peak = self._peak_d_unique
        if peak == 0:
            return "expanding"
        novelty = (d_unique / d_states) if d_states > 0 else 0.0
        if d_unique >= 0.8 * peak and novelty >= 0.3:
            return "expanding"
        if d_unique <= 0.2 * peak or novelty < 0.1:
            return "draining"
        return "peaking"

    # -- reading -------------------------------------------------------------

    def snapshot(self) -> dict:
        """Live health view (JSON-safe).  ``eta_secs`` is a drain-phase
        heuristic — queue size over the smoothed net queue-drain rate —
        and None whenever it would be a guess."""
        last = self._last or {}
        d_states = last.get("d_states") or 0
        d_unique = last.get("d_unique") or 0
        novelty = round(d_unique / d_states, 6) if d_states > 0 else None
        queue = last.get("queue")
        eta = None
        if (
            self.phase == "draining"
            and isinstance(queue, (int, float))
            and queue
            and self._ewma_drain
        ):
            eta = round(float(queue) / self._ewma_drain, 1)
        trend = "flat"
        if self._peak_d_unique:
            if d_unique >= 0.8 * self._peak_d_unique:
                trend = "growing"
            elif d_unique <= 0.2 * self._peak_d_unique:
                trend = "shrinking"
        return {
            "v": HEALTH_V,
            "phase": self.phase,
            # the raw condition only reads as a RISK when no spill tier
            # will catch the growth; armed, it is the spill forecast
            "oom_risk": self.oom_risk and not self.spill_armed,
            **(
                {"spill_forecast": True}
                if (self.oom_risk and self.spill_armed)
                else {}
            ),
            "stalled": self.stalled,
            **(
                {"spill_degraded": True} if self.spill_degraded else {}
            ),
            **(
                {"stall_reason": self.stall_reason}
                if self.stall_reason
                else {}
            ),
            "steps": self.steps,
            "novelty": novelty,
            "peak_fresh_per_step": self._peak_d_unique,
            "frontier": queue if isinstance(queue, (int, float)) else None,
            "frontier_trend": trend,
            "ewma_states_per_sec": (
                round(self._ewma_sps, 1) if self._ewma_sps else None
            ),
            "eta_secs": eta,
        }


def phase_timeline(step_records: list) -> list:
    """Deterministic per-step phase series for the run report: replays the
    COUNT-derived part of the tracker over exported/ring step records.
    Entries: ``{"step", "unique", "d_unique", "novelty", "phase"}``."""
    tracker = HealthTracker()
    out = []
    for i, r in enumerate(step_records):
        tracker.update(r)
        d_states = int(r.get("d_states") or 0)
        d_unique = int(r.get("d_unique") or 0)
        out.append({
            "step": i,
            "unique": int(r.get("unique") or 0),
            "d_unique": d_unique,
            "novelty": (
                round(d_unique / d_states, 6) if d_states > 0 else None
            ),
            "phase": tracker.phase,
        })
    return out
