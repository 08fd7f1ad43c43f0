"""Process-parallel BFS — the honest multi-core CPU baseline.

The port's own copy of ``stateright_tpu/checker/mp.py``, with its
flight-recorder and run-report hooks (JAX ``mp.py:98``, :192-201): worker 0
logs one (wall time, frontier, unique, states) tuple per round, from the
barrier snapshot every worker agrees on, and the parent replays them as
``step`` records after the merge.  This module imports no ``torch``: its workers are ``fork``-ed and run host
model code only (a forked child of a process that has started CUDA cannot
use CUDA), and the parent resolves the model's fingerprint scheme (its
tensor twin, where it has one) before it forks.

The thread pool (``pool.py``) mirrors the reference's work-stealing job
market (``bfs.rs:70-151``) faithfully, but under the CPython GIL its
``threads(N)`` is effectively single-core.  This strategy provides real
multi-core checking: ``fork``-ed worker processes running a bulk-synchronous
wavefront with **fingerprint-ownership sharding** — the same decomposition
the device engines use (``parallel/sharded.py`` routes fingerprints to their
owner shard by ``fp % D`` over ICI; here the "devices" are processes and the
"all-to-all" is a pair of multiprocessing queues per worker).

Per round, each worker:

 1. pops its owned frontier, evaluates properties, expands successors
    (identical per-state semantics to ``bfs.py``: no-op/self-loop pruning,
    boundary filter, terminal ebits flush);
 2. routes each successor to ``owner = fp % N`` (one message per peer per
    round, possibly empty — reception is therefore deterministic and
    deadlock-free; ``mp.Queue`` puts are asynchronous via feeder threads);
 3. dedups arrivals against its owned slice of the visited map
    (``fp -> parent fp``, exactly the BFS parent-pointer scheme of
    ``bfs.rs:26`` — each fingerprint has a single owner, so no cross-process
    races exist by construction);
 4. publishes (frontier size, unique count, state count, discovery mask)
    to a shared array and double-barriers: all workers then reach the same
    termination verdict (empty global frontier / all properties discovered /
    target count reached) from the same snapshot.

Work balance comes from fingerprint uniformity instead of stealing: a 64-bit
mixed hash spreads any frontier near-evenly across owners, which is the same
argument the TPU engine rests on.

**Symmetry reduction** works here (beyond the reference, whose symmetry is
DFS-only — ``dfs.rs:260-285``): the dedup key becomes
``stable_hash(representative(state))`` — a pure function, so no
cross-process state is needed — and successors are routed to
``owner = class_key % N`` so each symmetry class has exactly one owner.
The search continues with the *original* state (the ``dfs.py`` subtlety),
and parent pointers link original fingerprints, so discovery paths are
genuine action sequences needing no class-matching walk.  Per-round
arrival batches are folded in worker order, making the reduced counts
deterministic for a fixed worker count (like the device engines, whose
counts are pinned per mesh width).

**Visitors** work here too (closing the reference's multi-core-or-visitor
tradeoff): callbacks cannot cross process boundaries, so workers record
their per-round visit order (fingerprints only) and the PARENT replays
every visit after the merge — round-major, worker-minor, a deterministic
valid BFS level order — reconstructing each ``Path`` from the complete
parent-pointer map.  Recorders and snapshot visitors observe exactly the
states a thread checker would show them; the one semantic difference is
WHEN (after the run, not during), which only matters to a visitor that
races the live run — none of the reference's do.

Discovery *paths* are reconstructed by the parent from the merged visited
map, same as ``bfs.py``.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import time
import traceback
from typing import Optional

from .base import (
    Checker,
    CheckerBuilder,
    ParentPointerTrace,
    evaluate_properties,
    flush_terminal_ebits,
    init_ebits,
)

# shared-stats columns, per worker
_FRONTIER, _UNIQUE, _COUNT, _DISC, _STOP = range(5)
_NCOL = 5
# seconds the parent waits for a worker that has reported to exit
_JOIN_SECS = 60.0


class MpBfsChecker(ParentPointerTrace, Checker):
    """Checker surface over a completed process-parallel run.

    The run happens synchronously in the constructor (workers fork, explore,
    and report back); ``join()`` is a no-op afterwards.  ``fork`` start
    method is required — the model travels to workers by address-space
    inheritance, so arbitrary (unpicklable) models work, matching the thread
    checkers.
    """

    def __init__(self, options: CheckerBuilder, processes: Optional[int] = None):
        self.model = options.model
        self._props = list(self.model.properties())
        self._target = options.target_state_count
        # workers cannot share a recorder across the fork: the parent
        # replays worker 0's per-round history into this one
        self.flight_recorder = options._make_recorder("mp")
        self._report_path = options.report_path
        self._run_dir = options.run_dir
        # the fingerprint scheme resolves here, before the fork: every
        # worker inherits the model's twin instead of building its own
        for s in self.model.init_states():
            self.model.fingerprint_state(s)
            break
        # an EXPLICIT processes count wins verbatim (processes=1 is a valid
        # single-worker debugging run); only the unset case falls through to
        # threads(N) and then to all cores
        if processes is not None:
            n = max(1, processes)
        elif options.thread_count > 1:
            n = options.thread_count
        else:
            n = os.cpu_count() or 1
        self.worker_count = n
        ctx = mp.get_context("fork")
        queues = [ctx.Queue() for _ in range(n)]
        result_q = ctx.Queue()
        stats = ctx.Array("q", n * _NCOL, lock=False)
        barrier = ctx.Barrier(n)
        deadline = (
            time.monotonic() + options.timeout_secs
            if options.timeout_secs is not None
            else None
        )
        want_visits = options.visitor_obj is not None
        workers = [
            ctx.Process(
                target=_worker_main,
                args=(
                    i, n, self.model, self._props, queues, result_q, stats,
                    barrier, options.target_state_count, deadline,
                    options.symmetry_fn, want_visits,
                ),
                daemon=True,
            )
            for i in range(n)
        ]
        for w in workers:
            w.start()
        # drain results BEFORE joining: the visited maps ride the queue's
        # feeder thread, and a child cannot exit until its queue is drained.
        # The get() is watchdogged — a worker that dies WITHOUT reporting
        # (OOM kill, or a crash that strands its peers on the barrier) must
        # not hang the parent forever: on the first error result, or on any
        # abnormally-exited worker with the queue empty, every worker is
        # terminated and the failure surfaces as an exception.
        import queue as _queue

        self._generated: dict[int, int] = {}
        self._discoveries: dict[str, int] = {}
        self._count = 0

        def _fail(msg: str):
            for w in workers:
                if w.is_alive():
                    w.terminate()
            for w in workers:
                w.join(timeout=5)
            raise RuntimeError(msg)

        results: dict[int, tuple] = {}
        while len(results) < n:
            try:
                kind, who, payload = result_q.get(timeout=5.0)
            except _queue.Empty:
                crashed = [w for w in workers if w.exitcode not in (None, 0)]
                if crashed:
                    _fail(
                        "mp BFS worker died without reporting "
                        f"(exitcode {crashed[0].exitcode}); "
                        "remaining workers terminated"
                    )
                continue
            if kind == "error":
                # peers may be stranded mid-round (their barrier will never
                # fill) — fail fast rather than waiting for n results
                _fail("mp BFS worker failed:\n" + payload)
            results[who] = payload
        # merge in WORKER order, not report-arrival order: when two workers
        # both discovered a property, the surviving witness fingerprint (and
        # therefore the reconstructed trace) must not depend on OS scheduling
        for who in sorted(results):
            visited, disc, count, _, _ = results[who]
            for fp, pfp in visited.values():
                self._generated[fp] = pfp
            for name, fp in disc.items():
                self._discoveries.setdefault(name, fp)
            self._count += count
        for w in workers:
            w.join(timeout=_JOIN_SECS)
            if w.is_alive():
                w.terminate()
                w.join(timeout=5)
        if self.flight_recorder is not None and 0 in results:
            rec = self.flight_recorder
            for rnd, (t_abs, frontier, unique, count) in enumerate(
                    results[0][4]):
                rec.step(engine="mp", states=count, unique=unique,
                         frontier=frontier, round=rnd, t=rec.rel(t_abs))
            rec.close_run(done=True)
        if want_visits:
            self._replay_visits(options.visitor_obj, results)

    def _replay_visits(self, visitor, results: dict) -> None:
        """Replay every worker's recorded visit order through the parent's
        visitor — round-major, worker-minor (a deterministic, valid BFS
        level order) — with paths reconstructed from the now-complete
        merged parent map (callbacks cannot cross the process boundary)."""
        from .path import Path

        logs = {who: results[who][3] for who in results}
        rounds = max((len(l) for l in logs.values()), default=0)
        for r in range(rounds):
            for who in sorted(logs):
                log = logs[who]
                if r >= len(log):
                    continue
                for fp in log[r]:
                    visitor.visit(
                        self.model,
                        Path.from_fingerprints(self.model, self._trace(fp)),
                    )

    # -- Checker surface -----------------------------------------------------

    def state_count(self) -> int:
        return self._count

    def unique_state_count(self) -> int:
        return len(self._generated)

    def join(self) -> "MpBfsChecker":
        self._maybe_write_report()
        return self

    def is_done(self) -> bool:
        return True

    # discoveries()/_trace() via ParentPointerTrace


def _worker_main(
    me, n, model, props, queues, result_q, stats, barrier, target, deadline,
    symmetry=None, want_visits=False,
):
    try:
        _worker_loop(
            me, n, model, props, queues, result_q, stats, barrier, target,
            deadline, symmetry, want_visits,
        )
    except Exception:  # noqa: BLE001 - reported to the parent, peers unblocked
        tb = traceback.format_exc()
        for j in range(n):
            if j != me:
                queues[j].put(("abort", me, tb))
        result_q.put(("error", me, tb))
        queues[me].cancel_join_thread()


def _worker_loop(
    me, n, model, props, queues, result_q, stats, barrier, target, deadline,
    symmetry=None, want_visits=False,
):
    prop_count = len(props)
    full_mask = (1 << prop_count) - 1
    prop_index = {p.name: i for i, p in enumerate(props)}
    ebits0 = init_ebits(props)
    # dedup/ownership key: the state fingerprint, or under symmetry the
    # class key stable_hash(representative(state)) — a pure function, so
    # every worker computes it identically with no shared state (the
    # dfs.py::_dedup_key scheme; search continues with ORIGINAL states so
    # parent pointers chain real, re-executable fingerprints)
    if symmetry is not None:
        from ..fingerprint import stable_hash

        def dedup_key(state, fp):
            return stable_hash(symmetry(state))
    else:
        def dedup_key(state, fp):
            return fp

    # key -> (original fp, parent fp); for the plain run key == fp
    visited: dict[int, tuple] = {}
    discoveries: dict[str, int] = {}
    local_count = 0

    # init states: every worker enumerates them (deterministic model
    # obligation, as everywhere in the framework), keeps its owned slice;
    # worker 0 accounts the init contribution to state_count (bfs.py parity)
    frontier = []
    for s in model.init_states():
        if not model.within_boundary(s):
            continue
        if me == 0:
            local_count += 1
        fp = model.fingerprint_state(s)
        key = dedup_key(s, fp)
        if key % n == me and key not in visited:
            visited[key] = (fp, 0)
            frontier.append((s, fp, ebits0))

    # per-round visit order (fps only — the parent replays them through
    # the visitor after the merge; see MpBfsChecker._replay_visits)
    visit_log: list[list[int]] = []
    # per-round (wall, frontier, unique, states) history for the parent's
    # flight recorder; worker 0 only (every worker sees the same snapshot)
    round_log: list[tuple] = []
    rnd = 0
    while True:
        if want_visits:
            visit_log.append([fp for _, fp, _ in frontier])
        buckets: list[list] = [[] for _ in range(n)]
        for state, fp, ebits in frontier:
            ebits = evaluate_properties(
                model, props, discoveries, state, ebits, fp
            )
            is_terminal = True
            seen_children = set()
            for action in model.actions(state):
                nxt = model.next_state(state, action)
                if nxt is None:
                    continue
                if not model.within_boundary(nxt):
                    continue
                local_count += 1
                is_terminal = False
                nfp = model.fingerprint_state(nxt)
                key = dedup_key(nxt, nfp)
                if key in seen_children or nfp == fp:
                    continue
                seen_children.add(key)
                buckets[key % n].append((nxt, nfp, fp, ebits, key))
            if is_terminal and ebits:
                flush_terminal_ebits(props, discoveries, ebits, fp)

        # all-to-all: exactly one (possibly empty) message per peer per round
        for j in range(n):
            if j != me:
                queues[j].put((rnd, me, buckets[j]))
        batches = {me: buckets[me]}
        for _ in range(n - 1):
            tag, src, batch = queues[me].get()
            if tag == "abort":
                raise RuntimeError(f"peer worker {src} failed:\n{batch}")
            assert tag == rnd, f"round skew: got {tag}, at {rnd}"
            batches[src] = batch

        frontier = []
        # fold arrivals in worker order, not queue-arrival order: first
        # insertion decides which ORIGINAL state represents a symmetry
        # class (and its parent pointer), so a deterministic fold makes
        # counts and traces reproducible for a fixed worker count
        for j in sorted(batches):
            for state, nfp, pfp, ebits, key in batches[j]:
                if key not in visited:
                    visited[key] = (nfp, pfp)
                    frontier.append((state, nfp, ebits))

        disc_mask = 0
        for name in discoveries:
            disc_mask |= 1 << prop_index[name]
        base = me * _NCOL
        stats[base + _FRONTIER] = len(frontier)
        stats[base + _UNIQUE] = len(visited)
        stats[base + _COUNT] = local_count
        stats[base + _DISC] = disc_mask
        stats[base + _STOP] = int(
            deadline is not None and time.monotonic() > deadline
        )
        barrier.wait()
        tot_frontier = sum(stats[j * _NCOL + _FRONTIER] for j in range(n))
        tot_unique = sum(stats[j * _NCOL + _UNIQUE] for j in range(n))
        if me == 0:
            tot_count = sum(stats[j * _NCOL + _COUNT] for j in range(n))
            round_log.append(
                (time.monotonic(), tot_frontier, tot_unique, tot_count)
            )
        or_mask = 0
        stop = False
        for j in range(n):
            or_mask |= stats[j * _NCOL + _DISC]
            stop = stop or bool(stats[j * _NCOL + _STOP])
        stop = (
            stop
            or tot_frontier == 0
            or (prop_count and or_mask == full_mask)
            or (target is not None and tot_unique >= target)
        )
        # second barrier: nobody may overwrite stats for round r+1 until
        # every worker has read the round-r snapshot and agreed on ``stop``
        barrier.wait()
        if stop:
            break
        rnd += 1

    result_q.put(
        ("done", me, (visited, discoveries, local_count, visit_log,
                      round_log))
    )


def spawn_mp_bfs(model, workers: Optional[int] = None, target_states=None):
    """Convenience: process-parallel BFS over ``model`` (see module doc)."""
    b = model.checker()
    if target_states:
        b = b.target_states(target_states)
    return b.spawn_mp_bfs(processes=workers)
