"""Sequential-consistency tester (reference ``src/semantics/sequential_consistency.rs``).

The port's own copy of ``stateright_tpu/semantics/sequential_consistency.py``
(the native search runs with its real-time prerequisites off,
``_REAL_TIME = False``).  The recording is the linearizability tester's,
but without the real-time
(happens-before) prerequisites: only per-thread program order must be
respected by the serialization.  A history can be sequentially consistent
yet not linearizable (stale reads across threads).
"""

from __future__ import annotations

from typing import Optional

from .linearizability import LinearizabilityTester, _serialize


class SequentialConsistencyTester(LinearizabilityTester):
    """Shares recording with LinearizabilityTester; the ``_last_completed``
    snapshots are recorded but ignored during serialization.  The verdict
    cache is keyed by the tester itself, whose equality folds in the
    concrete type, so SC and linearizability verdicts never mix."""

    _REAL_TIME = False  # the native search drops the prerequisites too

    def serialized_history(self) -> Optional[list]:
        if not self.valid:
            return None
        remaining = {
            t: tuple(enumerate(cs)) for t, cs in self.history_by_thread.items()
        }
        return _serialize(
            [], self.init_ref_obj, remaining, dict(self.in_flight_by_thread),
            real_time=False,
        )
