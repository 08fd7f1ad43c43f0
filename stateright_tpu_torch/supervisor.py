"""Supervised runs: retry with backoff around the GPU engine, resume from
autosave, and graceful degradation on a device OOM.

The port's own copy of ``stateright_tpu/supervisor.py``.
``supervise(builder, autosave_dir=...)`` runs the check under a loop
that

 1. **arms periodic autosave** (``checkpoint.py``), so the run always has
    a recent durable generation to fall back to;
 2. **classifies failures** (:func:`classify_failure`): an injected kill,
    SIGINT and ``SystemExit`` are ``preemption``; ``torch.OutOfMemoryError``
    (and the injected equivalent, and the JAX ``RESOURCE_EXHAUSTED`` text)
    is ``oom``; an ``OSError`` is ``io``; anything else is ``fatal`` and
    re-raises at once.  On the card that includes every other CUDA error
    (a device-side assert or an illegal address ends the process's CUDA
    context, so a retry in the same process cannot succeed), a failed
    kernel build or load, and ``spawn_gpu``'s "no CUDA device": a model or
    device fault is never retried into a silently wrong answer, and no
    attempt is ever moved to the CPU or to a plain version;
 3. **resumes transient failures from the newest autosave generation**,
    after a bounded exponential backoff with seeded jitter, within a
    restart budget.  The dead attempt's checker, its exception and its
    traceback (which hold its device buffers) are dropped and the
    allocator's cached blocks returned before the next attempt allocates.
    Each resumed attempt links ``parent_run_id``, so the run registry's
    lineage diff (``_cli compare parent child --expect=IDENTICAL``)
    checks the recovery end to end;
 4. **degrades on a device OOM**: it arms ``CheckerBuilder.spill()``, so
    the next growth boundary evicts to the host tier instead of growing;
    with the tier already armed it halves the expansion batch once, and a
    second OOM ends the run.

**The budget after a real OOM** (a deliberate difference from JAX, whose
``_pin_budget_from_snapshot`` pins a budget only when none is known):
the port always knows the card's memory (``telemetry/memory.
device_budget``), so after a real ``torch.OutOfMemoryError`` (an
allocator limit below the card's, other tenants) it pins a budget of
twice the snapshot's analytic footprint whenever that is below the budget
in force: the OOM has just shown the known limit to be wrong, and the
spill-armed resume must evict before it meets the same wall.  An injected
OOM follows JAX's rule.  The pin is an env knob, restored when
supervision ends.

Cross-process resume: ``supervise`` looks for an existing generation in
``autosave_dir`` first, so re-running the same supervised command after a
SIGKILL continues the dead run; with a run registry configured, the dead
parent's last manifest is archived as a stub report
(``checkpoint.stub_report_doc``) so the lineage chain keeps its parent.
"""

from __future__ import annotations

import gc
import os
import random
import sys
import time
import traceback
from dataclasses import dataclass, field
from typing import Callable, Optional

from .checkpoint import (
    DEFAULT_EVERY_SECS,
    DEFAULT_KEEP,
    latest_generation,
    stub_report_doc,
)
from .parallel._base import ENV_SPILL, resolve_flag
from .testing.faults import InjectedFault, InjectedKill, InjectedOOM

SUPERVISE_V = 1

#: failure classes (classify_failure); ``fatal`` re-raises, the rest are
#: transient and resume from the newest autosave generation
PREEMPTION, OOM, IO, FATAL = "preemption", "oom", "io", "fatal"


def _is_torch_oom(exc: BaseException) -> bool:
    """``torch.OutOfMemoryError`` (alias ``torch.cuda.OutOfMemoryError``)
    by type name, or a CUDA error whose text is the allocation failure:
    matched structurally, never by import identity."""
    if any(c.__name__ == "OutOfMemoryError" for c in type(exc).__mro__):
        return True
    text = str(exc)
    return "CUDA out of memory" in text or (
        "CUDA error" in text and "out of memory" in text)


def classify_failure(exc: BaseException) -> str:
    """Map one run failure onto the supervision taxonomy (module
    docstring; JAX ``supervisor.py:60-84``, plus ``torch.OutOfMemoryError``).
    Every other CUDA error (torch's ``RuntimeError`` or
    ``AcceleratorError``, ``_cuda.check``'s launch error), a
    ``_cuda.KernelBuildError`` (which wraps the loader's ``OSError`` so
    that it is not taken for ``io``) and ``spawn_gpu``'s "no CUDA device"
    are ``RuntimeError``s and fall through to ``fatal``."""
    if isinstance(exc, InjectedOOM):
        return OOM
    if isinstance(exc, (InjectedKill, KeyboardInterrupt)):
        return PREEMPTION
    if _is_torch_oom(exc):
        return OOM
    if "RESOURCE_EXHAUSTED" in str(exc):
        return OOM  # the JAX package's device-OOM shape
    if isinstance(exc, OSError):
        return IO
    if isinstance(exc, SystemExit):
        return PREEMPTION  # a SIGTERM handler converting to exit
    return FATAL


@dataclass
class Attempt:
    """One supervised attempt's outcome (the result's audit trail)."""

    n: int
    outcome: str  # "completed" | "yielded" | a failure class
    error: Optional[str] = None
    resumed_from_gen: Optional[int] = None
    backoff_secs: Optional[float] = None
    degradation: Optional[str] = None


@dataclass
class SupervisedRun:
    """What ``supervise`` returns: the completed checker and the
    supervision trail (restarts, each attempt's outcome, the degradation
    events).  ``yielded`` marks a cooperative stop (the ``yield_event``
    hook): the checker is partial, its last autosave generation is the
    resume point, and ``supervise`` on the same ``autosave_dir``
    continues it bit for bit."""

    checker: object
    restarts: int
    attempts: list = field(default_factory=list)
    degradations: list = field(default_factory=list)
    yielded: bool = False

    def __getattr__(self, name):
        # the result surface reads straight off the completed checker
        return getattr(self.checker, name)


def _pin_budget_from_snapshot(snap: Optional[dict], real_oom: bool,
                              device=None) -> Optional[tuple]:
    """Pin a device budget of twice the snapshot's analytic footprint (the
    failed growth transient was about three times it) for the spill
    tier's evict-or-grow decision: when no budget is known (JAX's rule),
    or, after a real OOM, when the known one is larger (module
    docstring).  Returns ``(budget, prior_env_value)`` so the caller can
    restore the env knob when supervision ends, or None."""
    from .telemetry.memory import ENV_DEVICE_BYTES, device_budget

    fb = None
    if snap is not None and "footprint_bytes" in snap:
        try:
            fb = int(snap["footprint_bytes"])
        except (TypeError, ValueError):
            fb = None
    if not fb:
        return None
    budget = 2 * fb
    known = device_budget(device)[0]
    if known is not None and not (real_oom and budget < known):
        return None
    prior = os.environ.get(ENV_DEVICE_BYTES)
    os.environ[ENV_DEVICE_BYTES] = str(budget)
    return budget, prior


def _release_attempt(exc: BaseException) -> None:
    """Drop what a failed attempt holds on the card before the next one
    allocates: the frames of its traceback (the engine thread's carry and
    engine buffers live in their locals), for the exception and every
    exception chained to it, then the allocator's cached blocks."""
    seen = set()
    e: Optional[BaseException] = exc
    while e is not None and id(e) not in seen:
        seen.add(id(e))
        if e.__traceback__ is not None:
            traceback.clear_frames(e.__traceback__)
        e.__traceback__ = None
        e = e.__cause__ or e.__context__
    gc.collect()
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.empty_cache()


def supervise(
    builder,
    *,
    autosave_dir: Optional[str] = None,
    every_secs: float = DEFAULT_EVERY_SECS,
    keep: int = DEFAULT_KEEP,
    max_restarts: int = 5,
    backoff_base: float = 0.5,
    backoff_max: float = 30.0,
    seed: int = 0,
    spawn: Optional[Callable] = None,
    sleep: Callable[[float], None] = time.sleep,
    yield_event=None,
    **spawn_kw,
) -> SupervisedRun:
    """Run ``builder``'s check under supervision; returns a
    :class:`SupervisedRun` around the completed checker.

    ``autosave_dir`` roots the checkpoint generations (a temp dir when
    omitted: in-process restarts work, a cross-process resume needs a real
    path).  ``spawn`` maps ``(builder, resume, **spawn_kw)`` to a checker
    (default ``builder.spawn_gpu(resume=..., **spawn_kw)``: on the card
    unless ``spawn_kw`` says ``device="cpu"``); the supervisor joins it.
    ``sleep`` and ``seed`` let tests drive the backoff without the wall
    clock.  ``yield_event`` is the cooperative-stop hook: once it is set,
    the current attempt ``stop()``s at its next host sync (writing one
    last generation) and ``supervise`` returns the partial run with
    ``yielded=True`` instead of retrying.  The builder's autosave and
    spill settings, and any budget pinned, are restored when supervision
    ends."""
    if autosave_dir is None:
        import tempfile

        autosave_dir = tempfile.mkdtemp(prefix="stateright-tpu-torch-autosave-")
    prior_autosave_opts = builder.autosave_opts
    prior_spill_mode = builder.spill_mode
    builder.autosave(autosave_dir, every_secs=every_secs, keep=keep)
    if spawn is None:
        def spawn(b, resume=None, **kw):
            return b.spawn_gpu(resume=resume, **kw)

    rng = random.Random(seed)
    restarts = 0
    attempts: list = []
    degradations: list = []
    oom_degraded = False
    last_cls: Optional[str] = None
    # the batch_shrunk degradation: the snapshot's stored batch governs
    # the resumed buffer layout, so the shrink lands on every freshly
    # loaded generation
    pending_batch: Optional[int] = None
    # the budget pinned for the spill degradation: (value, prior value)
    pinned_budget: Optional[tuple] = None
    try:
        while True:
            found = latest_generation(autosave_dir)
            snap = manifest = None
            if found is not None:
                snap, manifest = found
                snap = dict(snap)
                if pending_batch is not None and "batch" in snap:
                    import numpy as np

                    snap["batch"] = np.int64(pending_batch)
                _maybe_register_stub(builder, manifest)
            # the trail rides the builder into the spawned checker (its
            # durability block and manifests)
            builder._supervise_restarts = restarts
            builder._supervise_degradations = list(degradations)
            from .telemetry.spans import start_span

            prior_span_ctx = getattr(builder, "_span_ctx", None)
            att_span = start_span("attempt", parent=prior_span_ctx)
            builder._span_ctx = att_span.ctx
            checker = None
            try:
                checker = spawn(builder, resume=snap, **spawn_kw)
                rec = getattr(checker, "flight_recorder", None)
                if rec is not None and restarts:
                    fields = {"attempt": restarts, "reason": last_cls or "?"}
                    if manifest and manifest.get("run_id"):
                        fields["parent_run_id"] = str(manifest["run_id"])
                    if degradations:
                        fields["degradation"] = degradations[-1]
                    rec.record("restart", v=SUPERVISE_V, **fields)
                    rec.update_meta(restarts=restarts, supervised=True)
                if yield_event is not None:
                    _arm_yield_watch(checker, yield_event)
                checker.join()
                att_span.end(rec, attempt=restarts)
            except BaseException as e:  # noqa: BLE001 - classified below
                att_span.end(getattr(checker, "flight_recorder", None),
                             attempt=restarts, error=type(e).__name__)
                cls = classify_failure(e)
                att = Attempt(
                    n=len(attempts), outcome=cls,
                    error=f"{type(e).__name__}: {e}",
                    resumed_from_gen=manifest.get("gen") if manifest else None,
                )
                attempts.append(att)
                if cls == FATAL or restarts >= max_restarts:
                    raise
                last_cls = cls
                if cls == OOM:
                    # the newest generation, the one the next attempt
                    # resumes from (JAX reads the failed attempt's starting
                    # snapshot here, none for a first attempt, so it could
                    # never pin a budget after an OOM in its first run)
                    newest = latest_generation(autosave_dir)
                    deg = _degrade_for_oom(
                        builder, spawn_kw,
                        newest[0] if newest is not None else snap,
                        oom_degraded, real=not isinstance(e, InjectedFault))
                    if deg is None:
                        raise  # degraded once already: OOM again = done
                    event, new_batch, pinned = deg
                    oom_degraded = True
                    degradations.append(event)
                    att.degradation = event
                    if new_batch is not None:
                        pending_batch = new_batch
                    if pinned is not None:
                        pinned_budget = pinned
                # the dead attempt's device memory goes before the next
                # attempt allocates
                if checker is not None:
                    checker._run_error = None
                checker = None
                _release_attempt(e)
                delay = min(backoff_base * (2 ** restarts), backoff_max) * (
                    1.0 + 0.25 * rng.random())
                att.backoff_secs = round(delay, 3)
                restarts += 1
                print(
                    f"stateright-tpu-torch: supervise: attempt {att.n} "
                    f"failed ({cls}: {att.error}); restart {restarts}/"
                    f"{max_restarts} after {delay:.2f}s backoff"
                    + (f" [{att.degradation}]" if att.degradation else ""),
                    file=sys.stderr,
                )
                sleep(delay)
                continue
            finally:
                # each attempt's span must not leak into the next one, or
                # outlive supervision on the builder
                builder._span_ctx = prior_span_ctx
            yielded = yield_event is not None and yield_event.is_set()
            attempts.append(Attempt(
                n=len(attempts),
                outcome="yielded" if yielded else "completed",
                resumed_from_gen=manifest.get("gen") if manifest else None,
            ))
            return SupervisedRun(
                checker, restarts, attempts=attempts,
                degradations=list(degradations), yielded=yielded,
            )
    finally:
        # supervision leaves no trail on the builder: a later plain spawn
        # must not inherit a restart count, an autosave cadence into this
        # dir, an armed spill tier or a pinned budget
        for attr in ("_supervise_restarts", "_supervise_degradations"):
            if hasattr(builder, attr):
                delattr(builder, attr)
        builder.autosave_opts = prior_autosave_opts
        builder.spill_mode = prior_spill_mode
        if pinned_budget is not None:
            from .telemetry.memory import ENV_DEVICE_BYTES

            _, prior = pinned_budget
            if prior is None:
                os.environ.pop(ENV_DEVICE_BYTES, None)
            else:
                os.environ[ENV_DEVICE_BYTES] = prior


def _arm_yield_watch(checker, yield_event) -> None:
    """The cooperative-stop watcher: once ``yield_event`` is set, ask the
    engine to ``stop()`` at its next host sync; the stop path writes one
    last autosave generation, so the run resumes from it bit for bit.
    The watcher ends by itself when the attempt finishes."""
    import threading

    def _watch():
        while not yield_event.wait(0.02):
            if checker.is_done():
                return
        checker.stop()

    threading.Thread(target=_watch, daemon=True,
                     name="supervise-yield").start()


def _degrade_for_oom(builder, spawn_kw: dict, snap: Optional[dict],
                     already: bool, real: bool) -> Optional[tuple]:
    """One degradation move for a device OOM; returns ``(event, new_batch,
    pinned_budget)``, or None once a move was spent.  The port has one
    engine, which the spill tier always fits, so the move is to arm it,
    unless it is armed already (by the builder or by
    ``STATERIGHT_TPU_SPILL=1``): then halve the expansion batch, which
    halves the per-step candidate and queue transients.  ``new_batch`` is
    applied by the loop to every generation it loads, since the
    snapshot's batch governs the resumed layout."""
    if already:
        return None
    if not resolve_flag(builder.spill_mode, ENV_SPILL):
        builder.spill()
        pinned = _pin_budget_from_snapshot(snap, real,
                                           spawn_kw.get("device"))
        event = (f"spill_armed(budget={pinned[0]})" if pinned
                 else "spill_armed")
        return event, None, pinned
    cur = None
    if snap is not None and "batch" in snap:
        cur = int(snap["batch"])
    elif spawn_kw.get("batch"):
        cur = int(spawn_kw["batch"])
    new = max(8, (cur or 2048) // 2)
    spawn_kw["batch"] = new  # governs a from-scratch restart (no snapshot)
    return f"batch_shrunk({cur}->{new})", new, None


def _maybe_register_stub(builder, manifest: dict) -> None:
    """With a run registry configured and the manifest's run never
    archived (it was killed mid-flight), archive the checkpoint-derived
    stub so the lineage chain has its parent.  Never fatal."""
    from .telemetry.registry import RunRegistry, resolve_run_dir

    root = resolve_run_dir(builder.run_dir)
    rid = manifest.get("run_id")
    if not root or not rid:
        return
    try:
        reg = RunRegistry(root)
        if any(r.get("run_id") == rid for r in reg.index()):
            return
        doc = stub_report_doc(manifest)
        if doc is not None:
            reg.record_doc(doc)
    except Exception as e:  # noqa: BLE001 - the ledger never blocks a
        # resume
        print(f"stateright-tpu-torch: supervise: stub-archive failed: "
              f"{type(e).__name__}: {e}", file=sys.stderr)
