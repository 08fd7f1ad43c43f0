"""Fleet job and pool declarations: checking as a service over one card.

The port's own copy of ``stateright_tpu/fleet/spec.py`` (the module
imports no JAX, but the port imports nothing of that package).

A :class:`Job` names one tenant's check: a zero-arg **builder factory**
(a fresh :class:`~stateright_tpu_torch.checker.base.CheckerBuilder` per
attempt: a resumed attempt must never inherit a spent CheckerBuilder's mutated
flags), a priority, and the resource hints the scheduler's admission
control prices (engine capacities; the memory ledger's ``capacity_plan``
ladder is evaluated against the slot budget).  A :class:`FleetSpec` is the
whole pool declaration: the job list, the slot count, the per-slot byte
budget, and the scheduling policy knobs (cohort packing on/off, spill
routing for over-budget jobs, the supervision restart budget).

The spec is inert data: building one does no device work, arms no
builder flag and touches no environment.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable, Optional

# fleet/job record + ledger schema version
FLEET_V = 1

#: admission decisions (scheduler.place): ``admitted`` fits the slot
#: budget (or no budget is known), ``admitted_spill`` fits only with the
#: host spill tier armed (the job is routed ``--spill``), ``refused``
#: fits neither — the job is never run and completes with this status.
ADMITTED, ADMITTED_SPILL, REFUSED = "admitted", "admitted_spill", "refused"

#: terminal job statuses (scheduler results); ``preempted`` is a
#: TRANSIENT status — a preempted job re-queues and later terminates in
#: one of the other states.
COMPLETED, FAILED, PREEMPTED = "completed", "failed", "preempted"


@dataclass
class Job:
    """One tenant's check request.

    ``build`` returns a FRESH CheckerBuilder each call; the scheduler
    calls it once per attempt (resume state lives in the job's autosave
    generations, not in builder mutations).  ``capacity``/``batch``/
    ``queue_capacity``/``steps_per_call`` are the engine hints admission
    control prices and the spawn receives; ``packable`` nominates the
    job for sweep-cohort packing (small jobs only: packed jobs run
    unsupervised and cannot be preempted, the sweep engine's contract);
    ``params`` is carried verbatim into the ledger/records (campaign
    grid coordinates); ``spawn_kw`` reaches ``spawn_gpu`` as it is
    (``device="cpu"`` runs the job on the plain PyTorch path)."""

    key: str
    build: Callable[[], object]
    priority: int = 0
    capacity: int = 1 << 12
    batch: int = 256
    queue_capacity: Optional[int] = None
    steps_per_call: Optional[int] = None
    packable: bool = False
    params: dict = field(default_factory=dict)
    spawn_kw: dict = field(default_factory=dict)

    def engine_kw(self) -> dict:
        """The spawn keywords admission control priced — hints first,
        explicit ``spawn_kw`` overriding."""
        kw = {"capacity": int(self.capacity), "batch": int(self.batch)}
        if self.queue_capacity is not None:
            kw["queue_capacity"] = int(self.queue_capacity)
        if self.steps_per_call is not None:
            kw["steps_per_call"] = int(self.steps_per_call)
        kw.update(self.spawn_kw)
        return kw


@dataclass
class FleetSpec:
    """The pool declaration the scheduler runs.

    ``slots`` is the pool width (concurrent runs); ``slot_budget_bytes``
    the per-slot admission budget (None ⇒ the live
    ``telemetry.memory.device_budget``, which follows
    ``STATERIGHT_TPU_DEVICE_BYTES``, else the card's memory; absent budgets
    admit everything, the capacity verb's degrade rule); ``spill`` routes
    jobs whose hot ladder cannot fit onto the host spill tier instead of
    refusing them; ``pack`` enables sweep-cohort packing of same-shape
    ``packable`` jobs; ``campaign_id`` tags every record/ledger row for
    the Explorer/`_cli runs` campaign grouping."""

    jobs: list
    slots: int = 2
    slot_budget_bytes: Optional[int] = None
    spill: bool = False
    pack: bool = True
    max_restarts: int = 2
    campaign_id: Optional[str] = None

    def __post_init__(self):
        if int(self.slots) < 1:
            raise ValueError("FleetSpec needs at least one pool slot")
        if not self.jobs:
            raise ValueError("FleetSpec needs at least one job")
        seen = set()
        for j in self.jobs:
            if not isinstance(j, Job):
                raise TypeError(f"FleetSpec.jobs entries must be Job: {j!r}")
            if j.key in seen:
                raise ValueError(f"duplicate job key {j.key!r}")
            seen.add(j.key)
            if not callable(j.build):
                raise TypeError(
                    f"job {j.key!r}: build must be a zero-arg builder "
                    "factory"
                )


@dataclass
class JobResult:
    """One job's terminal outcome in a :class:`FleetResult`."""

    key: str
    status: str  # completed | failed | refused
    decision: str = ADMITTED
    unique: Optional[int] = None
    states: Optional[int] = None
    max_depth: Optional[int] = None
    discoveries: list = field(default_factory=list)
    run_id: Optional[str] = None
    parent_run_id: Optional[str] = None
    slot: Optional[int] = None
    cohort: Optional[str] = None  # pack-group id for cohort-packed jobs
    preemptions: int = 0
    restarts: int = 0
    secs: float = 0.0
    reason: Optional[str] = None
    params: dict = field(default_factory=dict)

    def to_json(self) -> dict:
        out = {
            "key": self.key, "status": self.status,
            "decision": self.decision, "secs": round(self.secs, 3),
        }
        for k in ("unique", "states", "max_depth", "run_id",
                  "parent_run_id", "slot", "cohort", "reason"):
            v = getattr(self, k)
            if v is not None:
                out[k] = v
        if self.discoveries:
            out["discoveries"] = sorted(self.discoveries)
        if self.preemptions:
            out["preemptions"] = self.preemptions
        if self.restarts:
            out["restarts"] = self.restarts
        if self.params:
            out["params"] = dict(self.params)
        return out


class PreemptionPlan:
    """Deterministic stall injection for tests/smokes: force the named
    job's health tracker into a ``stall`` transition once its recorder
    reaches ``after_steps`` step records (step counts are count-derived,
    so the trigger point is deterministic per job even under a racing
    pool).  The scheduler's health monitor then observes the transition
    through the ordinary ring-record path — injection manufactures the
    SIGNAL, never bypasses the preemption machinery."""

    def __init__(self, stalls: dict):
        self.stalls = {str(k): int(v) for k, v in (stalls or {}).items()}
        self._fired: set = set()
        self._lock = threading.Lock()

    def due(self, key: str, steps: int) -> bool:
        at = self.stalls.get(key)
        if at is None or steps < at:
            return False
        with self._lock:
            if key in self._fired:
                return False
            self._fired.add(key)
        return True
