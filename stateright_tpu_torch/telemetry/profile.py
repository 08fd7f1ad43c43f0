"""Scoped ``torch.profiler`` hook: trace the first N blocks of a GPU run.

The port's counterpart of ``stateright_tpu/telemetry/profile.py`` (a
scoped ``jax.profiler`` trace there).  A whole-run trace of a long check
is unusable (the steady state repeats block after block), so the engine
arms a :class:`ScopedProfiler` that starts a ``torch.profiler`` session
(CPU activity, and CUDA activity when a CUDA device is present) at its
first block and stops it after ``steps`` host syncs, then writes the
session as a Chrome trace (``trace-<pid>-<n>.json`` under ``logdir``).
The trace holds the kernels the blocks launched, by their CUDA names
(``cand_prep_kernel``, ``bucket_plan_kernel``, ``insert_commit_kernel``).
An engine whose block is a CUDA graph with a conditional WHILE node
(``ops/block_loop.py``) is traced on the CPU only: CUPTI's kernel tracing
faults the device inside such a body (``ops.block_loop.CUPTI_FAULT``),
and the session's ``start`` event carries that reason as ``cuda_off``.

Failure policy (the JAX package's): profiling must never break a run.  A
profiler that cannot start or stop, or an unwritable logdir, downgrades
to a recorded ``profile`` event with ``error`` set; the check proceeds.
"""

from __future__ import annotations

import itertools
import os
from typing import Optional

from .recorder import FlightRecorder

_SESSIONS = itertools.count()


class ScopedProfiler:
    """Traces the first ``steps`` host-sync blocks to ``logdir``.

    The engine calls :meth:`maybe_start` right before its first block and
    :meth:`tick` once per host sync; the profiler stops itself after
    ``steps`` ticks (and is closed defensively by :meth:`stop` at run end
    either way).  Events land in the flight recorder; ``trace_path`` is
    the written trace (None until a session stopped cleanly).
    """

    def __init__(self, logdir: str, steps: int,
                 recorder: Optional[FlightRecorder] = None):
        self.logdir = str(logdir)
        self.steps = int(steps)
        self.recorder = recorder
        self.trace_path: Optional[str] = None
        self._prof = None
        self._ticks = 0
        self._active = False
        self._failed = False

    def _record(self, **fields) -> None:
        if self.recorder is None:
            return
        # profile events carry the engine-run span id when one is bound,
        # so the Chrome trace nests the profiled window under its run
        sid = self.recorder.bound_span()
        if sid is not None:
            fields.setdefault("span", sid)
        self.recorder.record("profile", **fields)

    def maybe_start(self, cuda_off: Optional[str] = None) -> None:
        """Start the session before a block, once: a session that ran its
        ``steps`` blocks (or failed) is not started again.  ``cuda_off``:
        why the engine's blocks must not be traced on the device (the
        session traces the CPU only, and its ``start`` event says why);
        None: CUDA activity too when a CUDA device is present."""
        if self._active or self._failed or self._ticks >= self.steps:
            return
        try:
            import torch

            acts = [torch.profiler.ProfilerActivity.CPU]
            cuda = torch.cuda.is_available() and cuda_off is None
            if cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            os.makedirs(self.logdir, exist_ok=True)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.start()
            self._active = True
            more = {"cuda_off": cuda_off} if cuda_off is not None else {}
            self._record(
                event="start", logdir=self.logdir, steps=self.steps,
                cuda=cuda, **more,
            )
        except Exception as e:  # noqa: BLE001 - profiling never breaks a run
            self._failed = True
            self._prof = None
            self._record(event="unavailable", error=f"{type(e).__name__}: {e}")

    def tick(self) -> None:
        """One host sync passed; stop the trace once N were profiled."""
        if not self._active:
            return
        self._ticks += 1
        if self._ticks >= self.steps:
            self.stop()

    def stop(self) -> None:
        """Close the session and write its trace.  Idempotent — the flag
        flips BEFORE the backend call, so the run wrapper's ``finally``
        can repeat a happy-path stop without double-stopping; every
        backend error is swallowed into a ``stop-failed`` event, so a stop
        while an engine exception is in flight never masks it."""
        if not self._active:
            return
        self._active = False
        prof, self._prof = self._prof, None
        try:
            prof.stop()
            path = os.path.join(
                self.logdir, f"trace-{os.getpid()}-{next(_SESSIONS)}.json"
            )
            prof.export_chrome_trace(path)
            self.trace_path = path
            self._record(
                event="stop", logdir=self.logdir, trace=path,
                profiled_steps=self._ticks,
            )
        except Exception as e:  # noqa: BLE001
            self._failed = True
            self._record(event="stop-failed", error=f"{type(e).__name__}: {e}")
