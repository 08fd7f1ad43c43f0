"""Fleet scheduling: multi-tenant checking as a service over one card.

The port's own copy of ``stateright_tpu/fleet/``.  Declare tenants as
:class:`Job` entries in a :class:`FleetSpec`, then ``run_fleet(spec)`` (or
drive a :class:`FleetScheduler` yourself).  Jobs are placed by the memory
ledger's capacity plans (admission control), packed into sweep cohorts
where shapes unify, supervised by ``supervise()``, and preempted by health
signal with autosave-backed exactly-once resume.
:mod:`~stateright_tpu_torch.fleet.campaign` expands a parameter grid into
a campaign with a durable ledger.

Nothing here is imported by the engines: with the fleet off, the step
dispatches exactly the operations it does without it (pinned by
tests/test_torch_fleet.py).
"""

from .campaign import (  # noqa: F401
    LEDGER_NAME,
    build_ledger,
    campaign_spec,
    expand_grid,
    run_campaign,
)
from .scheduler import (  # noqa: F401
    PREEMPT_EVENTS,
    FleetResult,
    FleetScheduler,
    run_fleet,
)
from .spec import (  # noqa: F401
    ADMITTED,
    ADMITTED_SPILL,
    COMPLETED,
    FAILED,
    FLEET_V,
    PREEMPTED,
    REFUSED,
    FleetSpec,
    Job,
    JobResult,
    PreemptionPlan,
)
