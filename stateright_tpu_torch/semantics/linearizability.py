"""Linearizability tester (reference ``src/semantics/linearizability.rs``).

The port's own copy of ``stateright_tpu/semantics/linearizability.py``:
:meth:`LinearizabilityTester.is_consistent` asks the port's native C++
search (:meth:`LinearizabilityTester._native_verdict`, which loads
``native/linearize.cpp``) when the spec is a plain register, and the
Python interleaving search otherwise or when the module is unavailable;
both give the same verdict.

On each invocation the tester snapshots the index of the last operation
completed by every *other* thread; a serialization must schedule those
prerequisite operations first — the "real time" (happens-before)
constraint (reference ``linearizability.rs:102-125,178-240``).

``serialized_history`` performs the exhaustive recursive interleaving
search of the reference.  Many states share a history value, so verdicts
are memoized by the tester itself.
"""

from __future__ import annotations

from typing import Optional

from ..fingerprint import stable_hash, stable_words
from . import ConsistencyTester, SequentialSpec

# Complete = (last_completed: tuple[(peer, idx)], op, ret)
# InFlight = (last_completed, op)

_VERDICT_CACHE: dict = {}
_VERDICT_CACHE_MAX = 1 << 20


class LinearizabilityTester(ConsistencyTester):
    __slots__ = (
        "init_ref_obj",
        "history_by_thread",
        "in_flight_by_thread",
        "valid",
    )

    def __init__(
        self,
        init_ref_obj: SequentialSpec,
        history_by_thread: Optional[dict] = None,
        in_flight_by_thread: Optional[dict] = None,
        valid: bool = True,
    ):
        self.init_ref_obj = init_ref_obj
        #: thread -> tuple of Complete
        self.history_by_thread = history_by_thread or {}
        #: thread -> InFlight
        self.in_flight_by_thread = in_flight_by_thread or {}
        #: protocol misuse (double in-flight op / return without invoke)
        #: permanently invalidates the history (``linearizability.rs:103-113``)
        self.valid = valid

    # -- recording (reference ``linearizability.rs:102-147``) ----------------

    def _last_completed(self, thread_id) -> tuple:
        return tuple(
            sorted(
                (int(t), len(cs) - 1)
                for t, cs in self.history_by_thread.items()
                if t != thread_id and cs
            )
        )

    def _invalidated(self) -> "LinearizabilityTester":
        return type(self)(
            self.init_ref_obj,
            self.history_by_thread,
            self.in_flight_by_thread,
            valid=False,
        )

    def on_invoke(self, thread_id, op) -> "LinearizabilityTester":
        thread_id = int(thread_id)
        if not self.valid:
            return self
        if thread_id in self.in_flight_by_thread:
            return self._invalidated()
        in_flight = dict(self.in_flight_by_thread)
        in_flight[thread_id] = (self._last_completed(thread_id), op)
        history = dict(self.history_by_thread)
        history.setdefault(thread_id, ())
        return type(self)(self.init_ref_obj, history, in_flight)

    def on_return(self, thread_id, ret) -> "LinearizabilityTester":
        thread_id = int(thread_id)
        if not self.valid:
            return self
        if thread_id not in self.in_flight_by_thread:
            return self._invalidated()
        in_flight = dict(self.in_flight_by_thread)
        last_completed, op = in_flight.pop(thread_id)
        history = dict(self.history_by_thread)
        history[thread_id] = history.get(thread_id, ()) + (
            (last_completed, op, ret),
        )
        return type(self)(self.init_ref_obj, history, in_flight)

    def __len__(self) -> int:
        return len(self.in_flight_by_thread) + sum(
            len(h) for h in self.history_by_thread.values()
        )

    # -- checking (reference ``linearizability.rs:165-240``) -----------------

    #: real-time prerequisites apply (False in the SC subclass)
    _REAL_TIME = True

    def is_consistent(self) -> bool:
        # keyed by the tester itself: dict equality resolves 64-bit hash
        # collisions exactly
        cached = _VERDICT_CACHE.get(self)
        if cached is None:
            if len(_VERDICT_CACHE) >= _VERDICT_CACHE_MAX:
                _VERDICT_CACHE.clear()
            cached = self._native_verdict()
            if cached is None:
                cached = self.serialized_history() is not None
            _VERDICT_CACHE[self] = cached
        return cached

    def _native_verdict(self) -> Optional[bool]:
        """Run the C++ search (``native/linearize.cpp``; JAX
        ``semantics/linearizability.py:124-190``) when the spec is a plain
        register and every operation fits the register vocabulary; None
        means "use the Python search"."""
        if not self.valid:
            return False
        from ..native import load
        from .register import Register

        mod = load()
        if mod is None or type(self.init_ref_obj) is not Register:
            return None
        threads = sorted(
            set(self.history_by_thread) | set(self.in_flight_by_thread))
        tid = {t: i for i, t in enumerate(threads)}
        valmap: dict = {}

        def vm(v) -> int:
            if v not in valmap:
                valmap[v] = len(valmap)
            return valmap[v]

        def conv(op, ret) -> Optional[tuple]:
            if op[0] == "write":
                if ret is not None and ret != ("write_ok",):
                    return None
                return (0, vm(op[1]))
            if op[0] == "read":
                if ret is None:
                    return (1, 0)
                if ret[0] != "read_ok":
                    return None
                return (1, vm(ret[1]))
            return None

        try:
            init_val = vm(self.init_ref_obj.value)
            packed = []
            for t in threads:
                comp = []
                for lc, op, ret in self.history_by_thread.get(t, ()):
                    k = conv(op, ret)
                    if k is None:
                        return None
                    comp.append(
                        (k[0], k[1], tuple((tid[p], i) for p, i in lc)))
                infl = self.in_flight_by_thread.get(t)
                if infl is None:
                    packed.append((tuple(comp), None))
                else:
                    lc, op = infl
                    k = conv(op, None)
                    if k is None:
                        return None
                    packed.append((tuple(comp), (
                        k[0], k[1], tuple((tid[p], i) for p, i in lc))))
        except TypeError:  # unhashable values and the like: Python decides
            return None
        return bool(
            mod.serialize_register(tuple(packed), init_val, self._REAL_TIME))

    def serialized_history(self) -> Optional[list]:
        """A legal total order explaining the history, or None."""
        if not self.valid:
            return None
        remaining = {
            t: tuple(enumerate(cs)) for t, cs in self.history_by_thread.items()
        }
        return _serialize(
            [], self.init_ref_obj, remaining, dict(self.in_flight_by_thread)
        )

    # -- value semantics -----------------------------------------------------

    def _key(self):
        return (
            self.init_ref_obj,
            tuple(sorted(self.history_by_thread.items())),
            tuple(sorted(self.in_flight_by_thread.items())),
            self.valid,
        )

    def __eq__(self, other):
        return type(self) is type(other) and self._key() == other._key()

    def __hash__(self):
        return stable_hash(self)

    def stable_words(self, out: list) -> None:
        stable_words(type(self).__name__, out)
        stable_words(self._key(), out)

    def __repr__(self):
        return (
            f"{type(self).__name__}(history={self.history_by_thread!r}, "
            f"in_flight={self.in_flight_by_thread!r})"
        )


def _serialize(
    valid_history: list,
    ref_obj: SequentialSpec,
    remaining: dict,  # thread -> tuple of (orig_idx, Complete)
    in_flight: dict,  # thread -> InFlight
    real_time: bool = True,
) -> Optional[list]:
    """Exhaustive interleaving search (reference ``linearizability.rs:178-240``).
    ``real_time=False`` drops the prerequisite checks, yielding sequential
    consistency (reference ``sequential_consistency.rs``)."""
    if all(not h for h in remaining.values()):
        return valid_history  # in-flight ops may legally remain unserialized

    def violates(last_completed) -> bool:
        if not real_time:
            return False
        for peer, min_peer_time in last_completed:
            ops = remaining.get(peer)
            if ops and ops[0][0] <= min_peer_time:
                return True  # a prerequisite op is still unserialized
        return False

    for thread_id in sorted(remaining):
        history = remaining[thread_id]
        if not history:
            # Case 1: nothing left to interleave; maybe an in-flight op whose
            # return was never observed — it may be serialized or not.
            if thread_id not in in_flight:
                continue
            last_completed, op = in_flight[thread_id]
            if violates(last_completed):
                continue
            next_ref, ret = ref_obj.invoke(op)
            next_in_flight = dict(in_flight)
            del next_in_flight[thread_id]
            result = _serialize(
                valid_history + [(op, ret)], next_ref, remaining,
                next_in_flight, real_time,
            )
        else:
            # Case 2: completed op next in this thread's program order.
            _, (last_completed, op, ret) = history[0]
            if violates(last_completed):
                continue
            ok, next_ref = ref_obj.is_valid_step(op, ret)
            if not ok:
                continue
            next_remaining = dict(remaining)
            next_remaining[thread_id] = history[1:]
            result = _serialize(
                valid_history + [(op, ret)], next_ref, next_remaining,
                in_flight, real_time,
            )
        if result is not None:
            return result
    return None
