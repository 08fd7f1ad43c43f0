"""Shared work-sharing worker pool of the host checkers.

The port's own copy of ``stateright_tpu/checker/pool.py``, with its
flight-recorder and run-report hooks (JAX ``pool.py:47``, :117-179).  One
implementation of the job-market protocol (idle-count termination
detection, surplus splitting, error propagation, deadline enforcement),
shared by BFS and DFS (the reference duplicates it per strategy:
``bfs.rs:70-151``, ``dfs.rs:76-158``).  Subclasses provide
``_check_block`` (process up to ``JOB_BLOCK_SIZE`` entries of a job) and
``_split_job`` (carve ``k`` shares off a job for idle workers).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional

from .base import Checker, CheckerBuilder

log = logging.getLogger(__name__)


class _JobMarket:
    """Shared job queue and idle count (reference ``bfs.rs:29-30,70-74``)."""

    def __init__(self, thread_count: int):
        self.cond = threading.Condition()
        self.thread_count = thread_count
        self.jobs: list = []
        self.closed = False

    def close(self):
        with self.cond:
            self.closed = True
            self.cond.notify_all()


class WorkerPoolChecker(Checker):
    """Checker strategy backed by a pool of work-sharing threads."""

    _telemetry_tag = "pool"  # overridden: "bfs" / "dfs"

    def _start_pool(self, options: CheckerBuilder, initial_job) -> None:
        self._options = options
        # the flight recorder (JAX ``pool.py:47``): one "step" record per
        # processed job block, from whichever worker thread ran it
        self.flight_recorder = options._make_recorder(self._telemetry_tag)
        self._report_path = options.report_path
        self._run_dir = options.run_dir
        self._count_lock = threading.Lock()
        self._state_count_shared = 0
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._timed_out = False
        self._deadline = (
            time.monotonic() + options.timeout_secs
            if options.timeout_secs is not None
            else None
        )
        self._market = _JobMarket(options.thread_count)
        self._market.jobs.append(initial_job)
        self._waiting = 0
        self._threads = [
            threading.Thread(target=self._worker, daemon=True)
            for _ in range(options.thread_count)
        ]
        for t in self._threads:
            t.start()

    # -- strategy hooks ------------------------------------------------------

    def _check_block(self, pending) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def _split_job(self, pending, k: int) -> list:  # pragma: no cover
        raise NotImplementedError

    # -- pool protocol -------------------------------------------------------

    def _worker(self):
        # thread-lifecycle log lines (reference ``bfs.rs:84,95,101,107``);
        # enable with logging.DEBUG on this module
        log.debug("%s started", threading.current_thread().name)
        try:
            self._worker_loop()
            log.debug("%s done", threading.current_thread().name)
        except BaseException as e:  # model bugs must reach join()
            log.debug("%s failed: %r", threading.current_thread().name, e)
            self._error = e
            self._stop.set()
            self._market.close()

    def _worker_loop(self):
        market = self._market
        pending = None
        while True:
            if not pending:
                with market.cond:
                    while True:
                        if market.jobs:
                            pending = market.jobs.pop()
                            break
                        if market.closed or self._stop.is_set():
                            return
                        self._waiting += 1
                        if self._waiting == market.thread_count:
                            # all workers idle, no jobs: exploration complete
                            market.closed = True
                            self._waiting -= 1
                            market.cond.notify_all()
                            return
                        market.cond.wait()
                        self._waiting -= 1
                if not pending:
                    continue
            self._check_block(pending)
            if self.flight_recorder is not None:
                # queue = the market's REMAINING blocks; busy=False opts
                # out of the zero-novelty stall rule (a job block holds
                # un-deduped successors, so an all-duplicates block is a
                # converging run, not a spinning one)
                self.flight_recorder.step(
                    engine=self._telemetry_tag,
                    states=self._state_count_shared,
                    unique=self.unique_state_count(),
                    queue=len(self._market.jobs),
                    busy=False,
                )
            if self._deadline is not None and time.monotonic() > self._deadline:
                # "timed out" means cut short: a run whose last block
                # exhausted the space just past the deadline completed
                if pending or self._market.jobs:
                    self._timed_out = True
                    self._stop.set()
            if self._stop.is_set():
                market.close()
                return
            # share surplus work with idle threads
            # (reference ``bfs.rs:138-150``)
            if len(pending) > 1:
                with market.cond:
                    if self._waiting > 0 and not market.jobs:
                        n = min(self._waiting + 1, len(pending))
                        market.jobs.extend(self._split_job(pending, n - 1))
                        market.cond.notify_all()

    def _add_count(self, n: int) -> None:
        with self._count_lock:
            self._state_count_shared += n

    # -- Checker surface -----------------------------------------------------

    def state_count(self) -> int:
        return self._state_count_shared

    @property
    def timed_out(self) -> bool:
        """True when the builder's ``timeout()`` cut the run short (as
        opposed to finishing, reaching ``target_states``, or discovering
        every property)."""
        return self._timed_out

    def join(self) -> "WorkerPoolChecker":
        for t in self._threads:
            t.join()
        if self._error is not None:
            raise self._error
        if self.flight_recorder is not None:
            # close the health timeline (idempotent); a deadline-cut run
            # stays in the phase where it was cut
            self.flight_recorder.close_run(done=not self._timed_out)
        self._maybe_write_report()
        return self

    def is_done(self) -> bool:
        return all(not t.is_alive() for t in self._threads)
