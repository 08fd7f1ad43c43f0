"""Parallel depth-first checker on host threads (reference
``src/checker/dfs.rs``).

The port's own copy of ``stateright_tpu/checker/dfs.py``.  It needs far
less memory than BFS: the visited set stores bare fingerprints (no parent
pointers) and each pending entry carries its fingerprint path as a
structurally shared cons chain (the reference copies a
``Vec<Fingerprint>`` per entry, ``dfs.rs:25-29``), so discovery paths need
no parent walk.  Paths found are not generally shortest.

Symmetry reduction applies here, as in the reference (``dfs.rs:260-285``):
successors are deduplicated on the representative's structural hash while
the search goes on with the *original* state, so recorded paths stay
valid (the reference pins a regression test for exactly that,
``dfs.rs:394-483``).

Cross-thread dedup uses atomic ``dict.setdefault`` with a per-attempt token
(compared by identity), the Python analogue of DashSet insertion.
"""

from __future__ import annotations

from ..fingerprint import stable_hash
from .base import (
    JOB_BLOCK_SIZE,
    CheckerBuilder,
    evaluate_properties,
    flush_terminal_ebits,
    init_ebits,
)
from .path import Path
from .pool import WorkerPoolChecker


def _fps(node) -> list[int]:
    """Materialize a cons fp-path chain ``(fp, parent_node)`` into a list."""
    out = []
    while node is not None:
        out.append(node[0])
        node = node[1]
    out.reverse()
    return out


class DfsChecker(WorkerPoolChecker):

    _telemetry_tag = "dfs"

    def __init__(self, options: CheckerBuilder):
        self.model = options.model
        self._symmetry = options.symmetry_fn
        self._props = list(self.model.properties())
        self._prop_count = len(self._props)
        self._generated: dict[int, object] = {}  # key -> insertion token
        self._discoveries: dict[str, tuple] = {}  # name -> cons fp-path node

        ebits = init_ebits(self._props)
        job: list = []
        init_count = 0
        for s in self.model.init_states():
            if not self.model.within_boundary(s):
                continue
            init_count += 1
            if self._insert(self._dedup_key(s)):
                fp = self.model.fingerprint_state(s)
                job.append((s, (fp, None), ebits))
        self._start_pool(options, job)
        self._add_count(init_count)

    def _dedup_key(self, state) -> int:
        if self._symmetry is not None:
            # The symmetry key is internal to this run (never used for
            # paths or device tables), so it is the structural hash: a
            # representative may permute a state into a configuration a
            # tensor twin's fingerprint bridge cannot encode (outside a
            # compiled twin's reachable closure).
            return stable_hash(self._symmetry(state))
        return self.model.fingerprint_state(state)

    def _insert(self, key: int) -> bool:
        """Atomically insert ``key``; True iff we were first."""
        token = object()
        return self._generated.setdefault(key, token) is token

    # -- strategy hooks ------------------------------------------------------

    def _split_job(self, pending: list, k: int) -> list:
        # share from the bottom of the stack: the oldest (shallowest) entries
        chunk = len(pending) // (k + 1)
        shares = []
        for _ in range(k):
            shares.append(pending[:chunk])
            del pending[:chunk]
        return shares

    def _check_block(self, pending: list):
        model = self.model
        props = self._props
        discoveries = self._discoveries
        visitor = self._options.visitor_obj
        target = self._options.target_state_count
        local_count = 0
        processed = 0
        while pending and processed < JOB_BLOCK_SIZE and not self._stop.is_set():
            state, node, ebits = pending.pop()
            processed += 1
            if visitor is not None:
                visitor.visit(model, Path.from_fingerprints(model, _fps(node)))
            ebits = evaluate_properties(
                model, props, discoveries, state, ebits, node
            )
            if self._prop_count and len(discoveries) == self._prop_count:
                self._stop.set()
                break
            is_terminal = True
            for action in model.actions(state):
                nxt = model.next_state(state, action)
                if nxt is None:
                    continue
                if not model.within_boundary(nxt):
                    continue
                local_count += 1
                is_terminal = False
                if self._insert(self._dedup_key(nxt)):
                    nfp = model.fingerprint_state(nxt)
                    pending.append((nxt, (nfp, node), ebits))
            if is_terminal and ebits:
                flush_terminal_ebits(props, discoveries, ebits, node)
                if self._prop_count and len(discoveries) == self._prop_count:
                    self._stop.set()
                    break
            if target is not None and len(self._generated) >= target:
                self._stop.set()
                break
        self._add_count(local_count)

    # -- Checker surface -----------------------------------------------------

    def unique_state_count(self) -> int:
        return len(self._generated)

    def discoveries(self) -> dict[str, Path]:
        return {
            name: Path.from_fingerprints(self.model, _fps(node))
            for name, node in dict(self._discoveries).items()
        }
