"""Deterministic fault injection: the chaos layer of the port.

The port's own copy of ``stateright_tpu/testing/faults.py``, in the same
JSON format, so one plan file drives either package and a seeded
:meth:`FaultPlan.scheduled` gives the same faults in both.

A :class:`FaultPlan` is a seed-driven, JSON-serializable list of
:class:`Fault` entries, each naming a **site** (an injection seam of the
engine or a store), a **trigger** (the ``at``-th occurrence of that site,
0-based) and an **action** (the failure to manufacture).  Installing a
plan (``plan.install()`` or ``with plan:``) arms the process-global hook;
the seams call :func:`fire` with their occurrence context, and the plan
decides, deterministically, whether this occurrence fails.

Sites (the port's seams):

 - ``host_sync``       -- every host sync of the GPU engine, right after
   the block's stats read (``parallel/wavefront.py``)
 - ``growth``          -- every growth boundary of the GPU engine: table,
   queue and candidate-budget growth and the spill eviction
 - ``spill_flush``     -- a ``spill.SpillStore`` disk-segment flush
 - ``snapshot_write``  -- an autosave generation write (``checkpoint.py``)
 - ``atomic_write``    -- every durable write of the port
   (``telemetry/_atomic.py``)

Actions:

 - ``kill``    -- raise :class:`InjectedKill` (preemption-shaped: the
   supervisor classifies it transient, like SIGTERM)
 - ``oom``     -- raise :class:`InjectedOOM` (its message carries
   ``RESOURCE_EXHAUSTED``, as JAX's does; the supervisor classifies it as
   a device OOM, as it does ``torch.OutOfMemoryError``)
 - ``io``      -- raise ``OSError(EIO)``
 - ``enospc``  -- raise ``OSError(ENOSPC)`` (disk full)
 - ``sigterm`` / ``sigkill`` -- deliver the real signal to this process
   (SIGKILL is not catchable: the run dies as a preempted job does)

With no plan installed, and with one installed that never fires, the
seams are host-side checks that read nothing from the device: every
engine step dispatches the same operations either way
(``tests/test_torch_engine.py`` pins it).  Every firing is appended to
the plan's ``fired`` log and, when the seam passed its flight recorder,
written as a versioned ``fault`` ring record.
"""

from __future__ import annotations

import errno
import json
import threading
from dataclasses import dataclass, field
from typing import Optional

FAULT_V = 1

SITES = ("host_sync", "growth", "spill_flush", "snapshot_write",
         "atomic_write")
ACTIONS = ("kill", "oom", "io", "enospc", "sigterm", "sigkill")


class InjectedFault(Exception):
    """Base class for manufactured failures (so tests can catch the
    whole family)."""


class InjectedKill(InjectedFault):
    """Preemption-shaped kill: the supervised-run classifier treats it
    exactly like SIGTERM/SIGINT (transient; resume from autosave)."""


class InjectedOOM(InjectedFault):
    """Device-OOM-shaped failure: the message carries
    ``RESOURCE_EXHAUSTED`` (the JAX package's shape, kept so both
    packages' fired logs agree); the supervisor's classifier puts it in
    the ``oom`` class with a real ``torch.OutOfMemoryError``."""


@dataclass
class Fault:
    """One scheduled failure: fire ``action`` at the ``at``-th occurrence
    (0-based) of ``site``.  One-shot: ``fired`` flips on delivery."""

    site: str
    action: str = "kill"
    at: int = 0
    fired: bool = False

    def to_json(self) -> dict:
        return {"site": self.site, "action": self.action, "at": self.at,
                "fired": self.fired}

    @classmethod
    def from_json(cls, d: dict) -> "Fault":
        return cls(
            site=str(d["site"]), action=str(d.get("action", "kill")),
            at=int(d.get("at", 0)), fired=bool(d.get("fired", False)),
        )


@dataclass
class FaultPlan:
    """A deterministic chaos schedule.  ``seed`` names the plan (and
    drives :meth:`scheduled`'s trigger derivation); ``faults`` is the
    explicit schedule; ``fired`` logs deliveries in order."""

    faults: list
    seed: int = 0
    fired: list = field(default_factory=list)

    def __post_init__(self):
        self._counts: dict = {}
        self._lock = threading.Lock()
        for f in self.faults:
            if f.site not in SITES:
                raise ValueError(
                    f"unknown fault site {f.site!r} (sites: {SITES})"
                )
            if f.action not in ACTIONS:
                raise ValueError(
                    f"unknown fault action {f.action!r} "
                    f"(actions: {ACTIONS})"
                )

    # -- construction --------------------------------------------------------

    @classmethod
    def scheduled(
        cls, seed: int, site: str, action: str = "kill",
        lo: int = 1, hi: int = 16,
    ) -> "FaultPlan":
        """Seed-driven single-fault plan: the trigger step is derived
        deterministically from ``seed`` in ``[lo, hi)`` — same seed, same
        schedule, every run (no wall clock, no global RNG)."""
        import random

        at = random.Random(seed).randrange(lo, max(hi, lo + 1))
        return cls([Fault(site=site, action=action, at=at)], seed=seed)

    # -- (de)serialization ----------------------------------------------------

    def to_json(self) -> dict:
        return {
            "v": FAULT_V,
            "seed": self.seed,
            "faults": [f.to_json() for f in self.faults],
        }

    @classmethod
    def from_json(cls, d: dict) -> "FaultPlan":
        return cls(
            [Fault.from_json(f) for f in d.get("faults", [])],
            seed=int(d.get("seed", 0)),
        )

    @classmethod
    def from_file(cls, path: str) -> "FaultPlan":
        with open(path) as f:
            return cls.from_json(json.load(f))

    def to_jsonl(self, path: str) -> None:
        """One plan header line + one line per delivered fault: the chaos
        run's auditable trail."""
        lines = [json.dumps({"kind": "plan", **self.to_json()})]
        lines += [json.dumps({"kind": "fired", **e}) for e in self.fired]
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")

    # -- arming --------------------------------------------------------------

    def install(self) -> "FaultPlan":
        global _ACTIVE
        _ACTIVE = self
        return self

    def uninstall(self) -> None:
        global _ACTIVE
        if _ACTIVE is self:
            _ACTIVE = None

    def __enter__(self) -> "FaultPlan":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()

    # -- delivery ------------------------------------------------------------

    def _fire(self, site: str, recorder=None, **ctx) -> None:
        with self._lock:
            n = self._counts.get(site, 0)
            self._counts[site] = n + 1
            hit = None
            for f in self.faults:
                if f.site == site and not f.fired and f.at == n:
                    hit = f
                    f.fired = True
                    break
            if hit is not None:
                self.fired.append({
                    "site": site, "action": hit.action, "at": n, **ctx,
                })
        if hit is None:
            return
        if recorder is not None:
            recorder.record(
                "fault", v=FAULT_V, site=site, action=hit.action, at=n,
            )
        _deliver(hit.action, site, n)


def _deliver(action: str, site: str, at: int):
    msg = f"injected {action!r} fault at {site}[{at}] (FaultPlan)"
    if action == "kill":
        raise InjectedKill(msg)
    if action == "oom":
        raise InjectedOOM(f"RESOURCE_EXHAUSTED: {msg}")
    if action == "io":
        raise OSError(errno.EIO, msg)
    if action == "enospc":
        raise OSError(errno.ENOSPC, msg)
    if action in ("sigterm", "sigkill"):
        import os
        import signal

        sig = signal.SIGTERM if action == "sigterm" else signal.SIGKILL
        os.kill(os.getpid(), sig)
        return  # SIGTERM may be handled; SIGKILL never returns
    raise ValueError(action)


_ACTIVE: Optional[FaultPlan] = None


def active() -> Optional[FaultPlan]:
    """The installed plan, or None (the default, and the fast path)."""
    return _ACTIVE


def fire(site: str, recorder=None, **ctx) -> None:
    """The seam hook: a no-op unless a plan is installed AND schedules
    this occurrence.  Called from host loops only, never inside an engine
    step, so arming a plan cannot change what a step dispatches."""
    plan = _ACTIVE
    if plan is not None:
        plan._fire(site, recorder=recorder, **ctx)
