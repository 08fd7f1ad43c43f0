"""Executable quick-start examples: the package's "front page".

The port's own copy of ``stateright_tpu/models/quickstart.py``.
The reference teaches its API through three doctest-sized specs: a sliding
puzzle solved by the checker (``src/lib.rs:40-116``), Lamport logical
clocks as a two-actor system (``src/actor.rs:11-78``), and a served toy
model (``src/checker.rs:60-97``); the vector-clock system detects
concurrency.  They are runnable functions (``python -m
stateright_tpu_torch.models.quickstart``) on the host checkers.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..actor import Actor, ActorModel, Id, Network, Out
from ..core import Expectation, Model, Property
from ..utils.vector_clock import VectorClock

GOAL = (0, 1, 2, 3, 4, 5, 6, 7, 8)


class SlidingPuzzle(Model):
    """3×3 sliding puzzle: find a solve sequence with the BFS checker.

    The *sometimes* property turns the checker into a solver: the discovery
    trace for "solved" is a shortest move sequence (BFS order), exactly the
    reference's front-page example (``src/lib.rs:40-116``).
    """

    def __init__(self, start=(1, 4, 2, 3, 5, 8, 6, 7, 0)):
        super().__init__()
        self.start = tuple(start)

    def init_states(self):
        return [self.start]

    def actions(self, state):
        return ["down", "up", "right", "left"]

    def next_state(self, state, action):
        empty = state.index(0)
        ey, ex = divmod(empty, 3)
        src = {
            "down": empty - 3 if ey > 0 else None,   # tile above slides down
            "up": empty + 3 if ey < 2 else None,     # tile below slides up
            "right": empty - 1 if ex > 0 else None,  # tile left slides right
            "left": empty + 1 if ex < 2 else None,   # tile right slides left
        }[action]
        if src is None:
            return None
        board = list(state)
        board[empty], board[src] = board[src], 0
        return tuple(board)

    def properties(self):
        return [Property.sometimes("solved", lambda m, s: s == GOAL)]


class LogicalClock(Actor):
    """Lamport-clock actor: each message carries a timestamp; receivers
    advance past it and reply (``src/actor.rs:11-78`` behavior parity:
    the checker finds how large the clocks can grow)."""

    def __init__(self, bootstrap_to: Id | None = None):
        self.bootstrap_to = bootstrap_to

    def on_start(self, id: Id, out: Out):
        if self.bootstrap_to is not None:
            out.send(self.bootstrap_to, 1)
            return 1
        return 0

    def on_msg(self, id: Id, state, src: Id, msg, out: Out):
        if msg > state:
            out.send(src, msg + 1)
            return msg + 1
        return None


def solve_puzzle():
    """Returns the shortest solve trace for the default puzzle."""
    checker = SlidingPuzzle().checker().spawn_bfs().join()
    checker.assert_properties()
    return checker.discovery("solved")


def clock_model(limit: int = 3) -> ActorModel:
    m = ActorModel(cfg=None)
    m.actor(LogicalClock())
    m.actor(LogicalClock(bootstrap_to=Id(0)))
    m.property(
        Expectation.ALWAYS,
        "less than max",
        lambda model, s: all(ts < limit for ts in s.actor_states),
    )
    return m


def clock_counterexample(limit: int = 3):
    """Returns the trace on which a clock first reaches ``limit``."""
    checker = clock_model(limit).checker().spawn_bfs().join()
    return checker.discovery("less than max")


# -- the served toy model (reference ``checker.rs:60-97``) --------------------


class FizzBuzz(Model):
    """The reference's ``serve`` doctest model: states are the emitted
    prefix of the fizz-buzz sequence, bounded by ``max``."""

    def __init__(self, max: int = 30):
        super().__init__()
        self.max = max

    def init_states(self):
        return [()]

    def actions(self, state):
        n = len(state)
        if n % 15 == 0:
            return ["fizzbuzz"]
        if n % 5 == 0:
            return ["buzz"]
        if n % 3 == 0:
            return ["fizz"]
        return [None]

    def next_state(self, state, action):
        return state + ((len(state), action),)

    def within_boundary(self, state) -> bool:
        return len(state) <= self.max

    def properties(self):
        return [
            Property.sometimes(
                "reaches the bound", lambda m, s: len(s) == m.max
            )
        ]


def serve_fizzbuzz(addr: str = "localhost:3000", block: bool = True):
    """``FizzBuzz(30).checker().serve(addr)``: the reference's front-page
    Explorer example (``checker.rs:60-97``; JAX ``quickstart.py:145``)."""
    return FizzBuzz(30).checker().serve(addr, block=block)


# -- vector clocks: detecting concurrency -------------------------------------


@dataclass(frozen=True)
class ObserverState:
    """The observer's merged clock plus whether any delivery was causally
    concurrent with what it had already seen."""

    clock: VectorClock
    saw_concurrent: bool = False


class StampedSender(Actor):
    """Emits a single event stamped with its vector clock
    (``VectorClock.incremented``, reference ``vector_clock.rs:34-40``)."""

    def __init__(self, observer: Id):
        self.observer = observer

    def on_start(self, id: Id, out: Out):
        clock = VectorClock().incremented(int(id))
        out.send(self.observer, clock)
        return clock


class ClockObserver(Actor):
    """Merges incoming clocks (``merge_max``) and flags deliveries that are
    incomparable with its current knowledge (``partial_cmp`` → ``None``),
    i.e. causally concurrent events."""

    def on_start(self, id: Id, out: Out):
        return ObserverState(VectorClock())

    def on_msg(self, id: Id, state: ObserverState, src: Id, msg, out: Out):
        concurrent = msg.partial_cmp(state.clock) is None
        merged = state.clock.merge_max(msg).incremented(int(id))
        return ObserverState(merged, state.saw_concurrent or concurrent)


def vector_clock_model() -> ActorModel:
    """Two independent senders + one observer: the checker proves the two
    events are concurrent (neither causally precedes the other) by
    discovering an observer state with ``saw_concurrent`` set."""
    m = ActorModel(cfg=None)
    m.actor(StampedSender(observer=Id(2)))
    m.actor(StampedSender(observer=Id(2)))
    m.actor(ClockObserver())
    # non-duplicating: the observer bumps its clock per delivery, so under
    # the (default) duplicating network redelivery would grow states forever
    m.init_network_(Network.new_unordered_nonduplicating())
    m.property(
        Expectation.SOMETIMES,
        "concurrency detected",
        lambda model, s: s.actor_states[2].saw_concurrent,
    )
    return m


def _audit_models(rest=()):
    """The configurations of the static audit (``_cli.fleet_audit``; JAX
    ``models/quickstart.py``'s hook).  The Lamport clock model carries
    two pinned AH205 warnings: logical clocks grow without bound, the
    growing domain the rule exists for (the model itself is bounded by
    ``within_boundary``, which compiling it for the card would still
    need as a ``state_bound``)."""
    return [
        ("quickstart sliding_puzzle", SlidingPuzzle()),
        ("quickstart lamport_clocks", clock_model()),
        ("quickstart vector_clocks", vector_clock_model()),
    ]


def main() -> None:
    path = solve_puzzle()
    moves = path.actions()
    print(f"puzzle solved in {len(moves)} moves:")
    for step in moves:
        print(f"  slide {step}")
    trace = clock_counterexample()
    n = len(trace.actions())
    print(f"logical clocks exceed the bound after {n} deliveries;")
    print(f"final clocks: {list(trace.final_state().actor_states)}")


if __name__ == "__main__":
    main()
