"""Parallel breadth-first checker on host threads: the CPU oracle
(reference ``src/checker/bfs.rs``).

The port's own copy of ``stateright_tpu/checker/bfs.py``.  Work is shared
through the job market (``pool.py``).  The visited map stores
``fp -> parent fp``, so discovery paths are rebuilt by walking parent
pointers and re-executing the model (reference ``bfs.rs:314-342``).

Semantics (the reference's, ``checker.rs:459-461``):

 - ``state_count`` counts the init states plus every generated
   within-boundary successor, duplicates included; ``unique_state_count``
   is the size of the visited map.
 - Properties are evaluated when a state is popped; the run stops as soon
   as every property has a discovery (checked per state, before expansion).
 - ``eventually`` bookkeeping uses per-path bits flushed at terminal states
   (``base.init_ebits``).
 - Symmetry is ignored, as in the reference: the host DFS and the GPU
   engine honour it.

Dedup across threads relies on CPython's atomic ``dict.setdefault``: the
insert either wins (returns our parent fp) or reveals the earlier entry, so
a state is enqueued exactly once (the reference's DashMap entry API,
``bfs.rs:245-259``).
"""

from __future__ import annotations

from collections import deque

from .base import (
    JOB_BLOCK_SIZE,
    CheckerBuilder,
    ParentPointerTrace,
    evaluate_properties,
    flush_terminal_ebits,
    init_ebits,
)
from .path import Path
from .pool import WorkerPoolChecker


class BfsChecker(ParentPointerTrace, WorkerPoolChecker):

    _telemetry_tag = "bfs"

    def __init__(self, options: CheckerBuilder):
        self.model = options.model
        self._props = list(self.model.properties())
        self._prop_count = len(self._props)
        self._generated: dict[int, int] = {}  # fp -> parent fp (0 for init)
        self._discoveries: dict[str, int] = {}  # property name -> fp

        ebits = init_ebits(self._props)
        job = deque()
        init_count = 0
        for s in self.model.init_states():
            if not self.model.within_boundary(s):
                continue
            init_count += 1
            fp = self.model.fingerprint_state(s)
            if fp not in self._generated:
                self._generated[fp] = 0
                job.append((s, fp, ebits))
        self._start_pool(options, job)
        self._add_count(init_count)

    # -- strategy hooks ------------------------------------------------------

    def _split_job(self, pending: deque, k: int) -> list:
        chunk = len(pending) // (k + 1)
        return [
            deque(pending.popleft() for _ in range(chunk)) for _ in range(k)
        ]

    def _check_block(self, pending: deque):
        model = self.model
        props = self._props
        generated = self._generated
        discoveries = self._discoveries
        visitor = self._options.visitor_obj
        target = self._options.target_state_count
        local_count = 0
        processed = 0
        while pending and processed < JOB_BLOCK_SIZE and not self._stop.is_set():
            state, fp, ebits = pending.popleft()
            processed += 1
            if visitor is not None:
                visitor.visit(model, Path.from_fingerprints(model, self._trace(fp)))
            ebits = evaluate_properties(
                model, props, discoveries, state, ebits, fp
            )
            if self._prop_count and len(discoveries) == self._prop_count:
                self._stop.set()
                break
            # expansion (reference ``bfs.rs:229-264``)
            is_terminal = True
            seen_children = set()  # two actions can yield the same successor
            for action in model.actions(state):
                nxt = model.next_state(state, action)
                if nxt is None:
                    continue
                if not model.within_boundary(nxt):
                    continue
                local_count += 1
                is_terminal = False
                nfp = model.fingerprint_state(nxt)
                if nfp in seen_children or nfp == fp:
                    continue
                # atomic insert-or-reveal: cross-thread races resolve by
                # parent fp; same-parent duplicates are caught above, so a
                # returned parent equal to ours means our insert won
                if generated.setdefault(nfp, fp) == fp:
                    seen_children.add(nfp)
                    pending.append((nxt, nfp, ebits))
            if is_terminal and ebits:
                flush_terminal_ebits(props, discoveries, ebits, fp)
                if self._prop_count and len(discoveries) == self._prop_count:
                    self._stop.set()
                    break
            if target is not None and len(generated) >= target:
                self._stop.set()
                break
        self._add_count(local_count)

    # -- Checker surface (paths via ParentPointerTrace) ----------------------

    def unique_state_count(self) -> int:
        return len(self._generated)
