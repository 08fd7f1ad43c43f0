"""Engine prewarm, the persistent compile cache, and compile-time
attribution.

The port's own copy of ``stateright_tpu/parallel/prewarm.py`` (:1-437).
It imports nothing but the standard library at import time, so the build
sites below (``ops/_cuda.py``, ``native/build.py``) can import it without
pulling in the engine.

What the port builds before a block can run, and what these three pieces
do about it:

 - :class:`EnginePrewarmer` (JAX :236-437) — one background worker thread
   that builds the growth ladder's NEXT capacity rungs ahead of time, so a
   growth boundary swaps in a ready engine instead of blocking the run on a
   cold build.  A port engine (``parallel/wavefront._Engine``) is its
   device buffers (``PrepBuffers``/``PlanBuffers``) and, under ``.por()``
   and ``.checked()``, the ``make_fx`` captures of the twin's kernels at
   the engine's batch; the prewarmed engine is the SAME engine, built
   earlier (``GpuChecker._schedule_prewarm``).  A wrong prediction costs
   one wasted background build, never correctness.

 - :func:`enable_persistent_compile_cache` (JAX :152-206) — the one
   directory that the kernel library (``ops/_cuda.py``, ``nvcc``) and the
   native module (``native/build.py``, ``g++``) build into and load from:
   :func:`compile_cache_dir`.  Default ``stateright_tpu_torch/_build/``;
   ``STATERIGHT_TPU_COMPILE_CACHE=DIR`` or the builder's
   ``.compile_cache(DIR)`` move it.  The cache holds those two artefacts
   and not engines: an engine owns mutable buffers that two live checkers
   must not share (JAX caches stateless executables on the twin).

 - :class:`CompileWatch` (JAX :40-140) — compile-time attribution.  JAX
   feeds its counters from jax's monitoring events; the port feeds them
   from its own build sites through :func:`build_site` (the kernel library
   build or load, the native module build or load, ``analysis/graph.
   capture`` and the engine's construction) and :func:`note_cache` (a hit:
   a compiled artefact loaded from the cache directory without running a
   compiler; a miss: ``nvcc`` or ``g++`` ran).  The counters are
   PER-THREAD, so the run loop's watch never absorbs the prewarm worker's
   background builds, and nested sites (a capture inside an engine's
   construction) are charged once.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from pathlib import Path
from typing import Callable, Optional

# -- compile-event accounting ---------------------------------------------------

# PER-THREAD accumulators: each build site charges the thread that ran it,
# so the run loop's watch never sees the prewarm worker's builds and vice
# versa
_tls = threading.local()


def _tls_counts() -> dict:
    counts = getattr(_tls, "counts", None)
    if counts is None:
        counts = {
            "backend_compile_secs": 0.0,  # builds and loads
            "persistent_cache_hits": 0,
            "persistent_cache_misses": 0,
        }
        _tls.counts = counts
    return counts


@contextlib.contextmanager
def build_site():
    """Charge the enclosed seconds to the calling thread's compile
    counter.  Only the outermost site of a thread counts, so a capture
    inside an engine's construction is charged once."""
    depth = getattr(_tls, "depth", 0)
    _tls.depth = depth + 1
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _tls.depth = depth
        if depth == 0:
            _tls_counts()["backend_compile_secs"] += (
                time.perf_counter() - t0)


def note_cache(hit: bool) -> None:
    """Count one persistent-cache lookup on the calling thread: ``hit``
    when a compiled artefact was loaded without running a compiler."""
    key = "persistent_cache_hits" if hit else "persistent_cache_misses"
    _tls_counts()[key] += 1


def compile_counters() -> dict:
    """Snapshot of the CALLING THREAD's compile accounting."""
    return dict(_tls_counts())


class CompileWatch:
    """Delta view over :func:`compile_counters`: ``start()`` then
    ``delta()`` yields the compile seconds and persistent-cache hits and
    misses the CURRENT THREAD had in between (see module docstring)."""

    def __init__(self):
        self._base = compile_counters()

    def start(self) -> "CompileWatch":
        self._base = compile_counters()
        return self

    def delta(self) -> dict:
        now = compile_counters()
        return {
            "compile_secs": round(
                now["backend_compile_secs"] - self._base["backend_compile_secs"],
                6,
            ),
            "persistent_hits": (
                now["persistent_cache_hits"]
                - self._base["persistent_cache_hits"]
            ),
            "persistent_misses": (
                now["persistent_cache_misses"]
                - self._base["persistent_cache_misses"]
            ),
        }


# -- persistent compile cache ---------------------------------------------------

ENV_COMPILE_CACHE = "STATERIGHT_TPU_COMPILE_CACHE"
ENV_PREWARM = "STATERIGHT_TPU_PREWARM"
# where the kernel library and the native module go when nothing moves them
DEFAULT_CACHE_DIR = Path(__file__).resolve().parent.parent / "_build"

_cache_lock = threading.Lock()
_cache_dir: Optional[str] = None


def enable_persistent_compile_cache(path: Optional[str] = None) -> Optional[str]:
    """Point the kernel library's and the native module's builds at
    ``path`` (default: the ``STATERIGHT_TPU_COMPILE_CACHE`` env var; no-op
    returning None when neither is set).  Idempotent; re-pointing at
    another directory is honored (last caller wins: it is one process-wide
    setting).  A library that the process has already loaded stays
    loaded."""
    global _cache_dir
    path = path or os.environ.get(ENV_COMPILE_CACHE) or None
    if not path:
        return None
    path = str(path)
    with _cache_lock:
        os.makedirs(path, exist_ok=True)
        _cache_dir = path
    return path


def disable_persistent_compile_cache() -> None:
    """Undo :func:`enable_persistent_compile_cache` (tests restore global
    state; a long-lived process keeps the directory once set)."""
    global _cache_dir
    with _cache_lock:
        _cache_dir = None


def compile_cache_dir() -> Path:
    """The directory the build sites build into and load from: the one
    :func:`enable_persistent_compile_cache` set, else
    ``STATERIGHT_TPU_COMPILE_CACHE``, else :data:`DEFAULT_CACHE_DIR`."""
    with _cache_lock:
        path = _cache_dir
    path = path or os.environ.get(ENV_COMPILE_CACHE) or None
    return Path(path) if path else DEFAULT_CACHE_DIR


# the builder-flag resolution and the step flags' env knobs live in
# ``parallel/_base.py``; importing them here at module load would pull the
# engine into the build sites, so they are re-exported on first access
_REEXPORTS = ("resolve_flag", "ENV_PREDEDUP", "ENV_POR", "ENV_SPILL")


def __getattr__(name: str):
    if name in _REEXPORTS:
        from . import _base

        return getattr(_base, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


# -- ahead-of-time engine prewarm -----------------------------------------------

PREWARM_THREAD_NAME = "stateright-prewarm"

# Interpreter-teardown guard: a daemon thread killed in the middle of a
# build (a device allocation, a capture) can abort the process, so an
# atexit hook drops every queued job and waits out the in-flight one
# before Python starts tearing down
_live_prewarmers = None
_atexit_lock = threading.Lock()


def _drain_prewarmers_at_exit() -> None:
    for p in list(_live_prewarmers or ()):
        try:
            p.close()
            p.wait_idle(120.0)
        except Exception:  # noqa: BLE001 - exit path must never raise
            pass


def _register_prewarmer(p: "EnginePrewarmer") -> None:
    global _live_prewarmers
    with _atexit_lock:
        if _live_prewarmers is None:
            import atexit
            import weakref

            _live_prewarmers = weakref.WeakSet()
            atexit.register(_drain_prewarmers_at_exit)
        _live_prewarmers.add(p)


class _Job:
    __slots__ = ("key", "build", "done", "result", "error", "compile_secs",
                 "persistent_hit", "started_t", "finished_t")

    def __init__(self, key, build):
        self.key = key
        self.build = build
        self.done = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        self.compile_secs = 0.0
        self.persistent_hit = False
        self.started_t: Optional[float] = None
        self.finished_t: Optional[float] = None


class EnginePrewarmer:
    """One background worker building predicted engine rungs in schedule
    order.  ``schedule(key, build)`` enqueues ``build()`` (idempotent per
    key); ``take(key)`` returns ``(result, waited_secs, was_ready, job)``
    for a scheduled key — waiting out an in-flight build if the boundary
    arrived first (still better than building cold: the build started
    earlier) — or ``None`` when the key was never scheduled.  ``build``
    runs on the worker thread and should return the finished engine;
    exceptions are captured and re-raised at ``take`` (the caller then
    builds cold)."""

    def __init__(self, name: str = PREWARM_THREAD_NAME):
        self._jobs: dict = {}
        self._queue: list = []
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._idle = threading.Event()
        self._idle.set()
        self._closed = False
        self._thread = threading.Thread(
            target=self._work, name=name, daemon=True
        )
        _register_prewarmer(self)
        self._thread.start()

    # -- worker --------------------------------------------------------------

    def _work(self) -> None:
        while True:
            self._wake.wait()
            with self._lock:
                if self._closed and not self._queue:
                    self._idle.set()
                    return
                job = self._queue.pop(0) if self._queue else None
                if not self._queue and not self._closed:
                    self._wake.clear()
                if job is not None:
                    self._idle.clear()
            if job is None:
                continue
            job.started_t = time.monotonic()
            watch = CompileWatch()
            try:
                job.result = job.build()
            except BaseException as e:  # noqa: BLE001 - surfaced at take()
                job.error = e
            d = watch.delta()
            job.compile_secs = d["compile_secs"]
            job.persistent_hit = d["persistent_hits"] > 0
            job.finished_t = time.monotonic()
            job.done.set()
            with self._lock:
                if not self._queue:
                    self._idle.set()

    # -- caller surface ------------------------------------------------------

    def schedule(self, key, build: Callable[[], object]) -> bool:
        """Enqueue ``build()`` for ``key`` unless already scheduled;
        True when a new job was queued."""
        with self._lock:
            if self._closed or key in self._jobs:
                return False
            job = _Job(key, build)
            self._jobs[key] = job
            self._queue.append(job)
            self._wake.set()
            return True

    def scheduled(self, key) -> bool:
        with self._lock:
            return key in self._jobs

    def ready(self, key) -> bool:
        """True when ``key``'s background build has finished (the rung
        would swap in with ~zero wait)."""
        with self._lock:
            job = self._jobs.get(key)
        return job is not None and job.done.is_set()

    def take(self, key, timeout: Optional[float] = None):
        """Consume the job for ``key``: ``(result, waited_secs, was_ready,
        job)`` or None when never scheduled.  A job that is DONE is
        returned at once; an IN-FLIGHT build is waited out (bounded by
        ``timeout``; the build started earlier, so waiting beats
        duplicating it).  A job still sitting in the queue is CANCELLED and
        None returned — the caller's cold build starts at once instead of
        queueing behind unrelated background builds."""
        with self._lock:
            job = self._jobs.get(key)
            if job is None:
                return None
            if job in self._queue:  # scheduled but never started: cancel
                self._queue.remove(job)
                self._jobs.pop(key, None)
                return None
        was_ready = job.done.is_set()
        t0 = time.monotonic()
        if not job.done.wait(timeout):
            return None
        waited = time.monotonic() - t0
        with self._lock:
            self._jobs.pop(key, None)
        if job.error is not None:
            raise job.error
        return job.result, waited, was_ready, job

    def pending(self) -> int:
        with self._lock:
            return len(self._jobs)

    def prune(self, keep) -> int:
        """Drop jobs whose key is not in ``keep``: queued ones are
        cancelled outright, finished ones release their engines (their
        rung can no longer be consumed once capacities moved past it, and
        a stale queued job would delay the NEXT useful build on the single
        worker).  The in-flight job is left alone.  Returns the number of
        jobs dropped."""
        keep = set(keep)
        dropped = 0
        with self._lock:
            for job in list(self._queue):
                if job.key not in keep:
                    self._queue.remove(job)
                    self._jobs.pop(job.key, None)
                    job.error = RuntimeError("prewarm prediction superseded")
                    job.done.set()
                    dropped += 1
            for key, job in list(self._jobs.items()):
                if key not in keep and job.done.is_set():
                    self._jobs.pop(key, None)
                    dropped += 1
        return dropped

    def close(self) -> None:
        """Stop accepting work and DROP queued (not yet started) jobs —
        their predicted rungs will never be consumed once the run is over.
        The in-flight build (if any) runs to completion on the worker;
        :meth:`wait_idle` (and the atexit drain) waits it out so the
        interpreter never tears down under a live build."""
        with self._lock:
            self._closed = True
            for job in self._queue:
                job.error = RuntimeError("prewarmer closed")
                job.done.set()
                self._jobs.pop(job.key, None)
            self._queue.clear()
            self._wake.set()

    def wait_idle(self, timeout: Optional[float] = None) -> bool:
        """True once no build is in flight (the queue is already empty or
        dropped by :meth:`close`)."""
        return self._idle.wait(timeout)
