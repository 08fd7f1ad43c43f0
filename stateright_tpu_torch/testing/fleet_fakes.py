"""Engine-free fakes for fleet-scheduler unit tests.

The port's copy of the JAX package's ``tests/fleet_fakes.py``, kept in
the package (as ``sweep_fixtures.py`` is) so the tests and the card smoke
share it.  The fast tier must exercise the scheduler's policy surface —
admission, queueing, preemption, records, ledgers — in milliseconds,
which means no engine may ever spawn.  ``FakeBuilder``/``FakeChecker`` present
exactly the builder/checker surface the scheduler and ``supervise()``
touch: a twin-less model (admission admits host-side checks without a
capacity plan), the autosave/spill/telemetry mutation points supervise
saves and restores, and a checker that either completes instantly or
blocks until ``stop()`` (the cooperative-yield path).
"""

from __future__ import annotations

import threading
import uuid


class FakeModel:
    """Twin-less model stub: ``twin_or_none`` returns None, so
    admission admits it as a host-side check without pricing."""

    def properties(self):
        return []


class FakeChecker:
    """The checker surface the scheduler + supervise read.

    ``block=True`` makes ``join()`` wait for ``stop()`` (bounded, so a
    broken test fails loudly instead of hanging) — the shape of a run
    long enough to preempt.  ``fail`` raises from ``join()`` — the
    supervised-failure shape."""

    def __init__(
        self,
        model,
        *,
        unique=1,
        states=1,
        depth=1,
        discoveries=None,
        block=False,
        fail=None,
        recorder=None,
        resume=None,
    ):
        self.model = model
        self._unique = int(unique)
        self._states = int(states)
        self._depth = int(depth)
        self._discoveries = dict(discoveries or {})
        self._block = bool(block)
        self._fail = fail
        self.flight_recorder = recorder
        self.parent_run_id = (
            str(resume["run_id"])
            if resume and resume.get("run_id") else None
        )
        self._run_id = uuid.uuid4().hex[:16]
        self._stop = threading.Event()
        self._done = threading.Event()
        if not block and fail is None:
            self._done.set()

    @property
    def run_id(self) -> str:
        return self._run_id

    def is_done(self) -> bool:
        return self._done.is_set()

    def stop(self):
        self._stop.set()
        self._done.set()
        return self

    def join(self):
        if self._fail is not None:
            self._done.set()
            raise self._fail
        if self._block:
            assert self._stop.wait(10.0), "FakeChecker never stopped"
        self._done.set()
        return self

    def state_count(self) -> int:
        return self._states

    def unique_state_count(self) -> int:
        return self._unique

    def max_depth(self) -> int:
        return self._depth

    def discoveries(self) -> dict:
        return dict(self._discoveries)


class FakeBuilder:
    """The builder surface the scheduler + supervise mutate.  One
    ``FakeBuilder`` per ``Job.build()`` call, like a real builder
    factory; ``spawn_plan`` maps the spawn ordinal (0-based, across
    ALL builders sharing the plan list) to FakeChecker kwargs — how a
    test scripts "first attempt blocks until preempted, the resumed
    attempt completes"."""

    def __init__(
        self,
        *,
        unique=1,
        states=1,
        depth=1,
        discoveries=None,
        recorder_factory=None,
        spawn_plan=None,
        spawn_log=None,
    ):
        self.model = FakeModel()
        self.telemetry_opts = None
        self.autosave_opts = None
        self.spill_mode = None
        self.target_state_count = None
        self.run_dir = None
        self._kw = {
            "unique": unique, "states": states, "depth": depth,
            "discoveries": discoveries,
        }
        self._recorder_factory = recorder_factory
        self._spawn_plan = spawn_plan
        self.spawn_log = spawn_log if spawn_log is not None else []

    def telemetry(self, enabled=True, **kw):
        self.telemetry_opts = {"capacity": 256} if enabled else None
        return self

    def spill(self, enabled=True):
        self.spill_mode = bool(enabled)
        return self

    def autosave(self, path, every_secs=60.0, keep=3):
        self.autosave_opts = {
            "dir": str(path), "every_secs": float(every_secs),
            "keep": int(keep),
        }
        return self

    def spawn_gpu(self, resume=None, **kw):
        ordinal = len(self.spawn_log)
        extra = {}
        if self._spawn_plan is not None:
            extra = dict(self._spawn_plan.get(ordinal, {}))
        self.spawn_log.append({"resume": resume, "kw": dict(kw)})
        rec = self._recorder_factory() if self._recorder_factory else None
        fkw = dict(self._kw)
        fkw.update(extra)
        return FakeChecker(
            self.model, recorder=rec, resume=resume, **fkw,
        )
