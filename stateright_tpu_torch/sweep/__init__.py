"""Hyper-batched instance sweeps: one device run checks a model family.

The port's counterpart of ``stateright_tpu/sweep/``.  A :class:`SweepSpec`
enumerates a family of instances (lossiness flags, bounds, table seeds);
``cohort.py`` groups them into shape cohorts (instances whose twins'
captured aten graphs are structurally identical: the differing constants
are lifted out and gathered per row by an instance tag); and the sweep
engine (``engine.py``) runs each cohort as one wavefront over a shared
visited table whose fingerprints are namespaced per instance
(``cand_prep``'s namespace mode, ``fingerprint.ns_fingerprint``), so
instances never collide and each instance's counts, verdicts and traces
are those of its own sequential run.

Surfaces: ``CheckerBuilder.sweep(SPEC)``, the models' ``sweep`` verb, and
``STATERIGHT_TPU_SWEEP=N`` (models that define ``sweep_family``); one
registry record per instance, tagged ``sweep_id``.
"""

from .spec import (  # noqa: F401
    ENV_SWEEP,
    SWEEP_V,
    SweepInstance,
    SweepSpec,
    resolve_sweep_spec,
)
