"""Campaigns: a parameter grid expanded into fleet jobs, with a
durable ledger (the ``campaign`` CLI verb).

The port's own copy of ``stateright_tpu/fleet/campaign.py``.  A campaign
is the fleet's canonical workload: "check this model at every point of
this parameter grid".  :func:`expand_grid` turns ``{"rm_count": [3, 5],
"lossy": [False, True]}`` into the cross product; :func:`campaign_spec`
maps each point through a model factory into a
:class:`~stateright_tpu_torch.fleet.spec.Job` (grid points are
``packable`` by default: same-factory points usually share a twin shape,
which is what cohort packing amortizes); and :func:`run_campaign`
schedules the lot and writes the campaign ledger: one JSON document with
per-job wall-clock, decisions, counts, compile accounting, and the
aggregate states/s.

The ledger lands via the atomic write discipline
(``telemetry/_atomic.py``): a killed campaign leaves the previous
ledger intact, never a torn one.
"""

from __future__ import annotations

import itertools
import os
import uuid
from typing import Callable, Optional

from .scheduler import FleetResult, FleetScheduler
from .spec import FLEET_V, FleetSpec, Job

#: the ledger filename under a campaign root
LEDGER_NAME = "campaign.json"


def expand_grid(grid: dict) -> list:
    """The sorted-key cross product of ``{param: [values...]}`` as a
    list of param dicts — deterministic order (itertools.product over
    sorted keys), so a campaign's job list is stable across runs."""
    if not grid:
        return [{}]
    keys = sorted(grid)
    axes = []
    for k in keys:
        vals = grid[k]
        if not isinstance(vals, (list, tuple)):
            vals = [vals]
        if not vals:
            raise ValueError(f"campaign grid axis {k!r} is empty")
        axes.append(list(vals))
    return [dict(zip(keys, combo)) for combo in itertools.product(*axes)]


def _default_key(params: dict) -> str:
    return ",".join(f"{k}={v}" for k, v in sorted(params.items())) \
        or "point"


def campaign_spec(
    factory: Callable[..., object],
    grid: dict,
    *,
    campaign_id: Optional[str] = None,
    key_fn: Optional[Callable[[dict], str]] = None,
    priority_fn: Optional[Callable[[dict], int]] = None,
    packable: bool = True,
    capacity: int = 1 << 12,
    batch: int = 256,
    slots: int = 2,
    slot_budget_bytes: Optional[int] = None,
    spill: bool = False,
    pack: bool = True,
    max_restarts: int = 2,
    run_dir: Optional[str] = None,
) -> FleetSpec:
    """Expand ``grid`` through ``factory(**params)`` into a
    :class:`FleetSpec`.  ``factory`` is called lazily per attempt (the
    Job builder-factory contract); ``key_fn``/``priority_fn`` derive
    the job key and priority from each grid point (defaults: ``k=v``
    pairs / priority 0); ``run_dir`` routes every job's report into a
    run registry (the lineage-audit substrate)."""
    jobs = []
    for params in expand_grid(grid):
        key = key_fn(params) if key_fn is not None \
            else _default_key(params)

        def build(params=params):
            from ..checker.base import CheckerBuilder

            model = factory(**params)
            b = getattr(model, "checker", None)
            b = b() if callable(b) else CheckerBuilder(model)
            return b.runs(run_dir) if run_dir else b

        jobs.append(Job(
            key=key, build=build,
            priority=priority_fn(params) if priority_fn else 0,
            capacity=capacity, batch=batch, packable=packable,
            params=dict(params),
        ))
    return FleetSpec(
        jobs=jobs, slots=slots, slot_budget_bytes=slot_budget_bytes,
        spill=spill, pack=pack, max_restarts=max_restarts,
        campaign_id=campaign_id or f"campaign-{uuid.uuid4().hex[:8]}",
    )


def build_ledger(spec: FleetSpec, result: FleetResult) -> dict:
    """The campaign ledger document: per-job wall-clock + decisions +
    counts, compile accounting, and the aggregate throughput headline
    (total states over total wall-clock — the multi-tenant serving
    metric, not any single job's)."""
    total_states = sum(
        r.states or 0 for r in result.results.values()
    )
    doc = {
        "v": FLEET_V,
        "campaign_id": spec.campaign_id,
        "slots": result.slots,
        "jobs": len(spec.jobs),
        "completed": result.completed,
        "failed": result.failed,
        "refused": result.refused,
        "preemptions": result.preemptions,
        "engine_compiles": result.engine_compiles,
        "packed": [dict(p) for p in result.packed],
        "secs": round(result.secs, 3),
        "total_states": int(total_states),
        "states_per_sec": (
            round(total_states / result.secs, 1)
            if result.secs > 0 else None
        ),
        "results": [r.to_json() for r in result.results.values()],
    }
    return doc


def run_campaign(
    spec: FleetSpec,
    *,
    root: str,
    recorder=None,
    preemption=None,
    every_secs: float = 0.0,
    stream=None,
    device=None,
) -> tuple:
    """Schedule ``spec`` under ``root`` (job autosaves in
    ``root/jobs/``, the ledger at ``root/campaign.json``) and return
    ``(FleetResult, ledger_dict)``.  The ledger write is atomic; a
    write failure degrades loudly (the run's results are still
    returned — losing the artifact must not lose the answer).
    ``device`` is the scheduler's (:class:`FleetScheduler`)."""
    import sys

    from ..telemetry._atomic import atomic_write_json

    sched = FleetScheduler(
        spec, root=root, recorder=recorder, preemption=preemption,
        every_secs=every_secs, stream=stream, device=device,
    )
    result = sched.run()
    ledger = build_ledger(spec, result)
    try:
        os.makedirs(root, exist_ok=True)
        atomic_write_json(os.path.join(root, LEDGER_NAME), ledger)
    except OSError as e:
        print(
            f"stateright-tpu-torch: campaign: ledger write failed "
            f"({type(e).__name__}: {e}); results returned in-memory",
            file=stream if stream is not None else sys.stderr,
        )
    return result, ledger
