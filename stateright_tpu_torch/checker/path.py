"""Traces through a model's state space (reference ``src/checker/path.rs``).

The port's counterpart of ``stateright_tpu/checker/path.py``.  A
:class:`Path` is a sequence ``state --action--> state --action--> ... state``.
The GPU engine and the host BFS store only ``fp -> parent fp``, so
materializing a path *re-executes* the object-form model and matches
successor fingerprints (reference ``path.rs:20-86``).  Exact fingerprints
are injective along a trace, so the greedy first-match walk is exhaustive;
a symmetry key (canonical fingerprints) takes the backtracking walk, with a
per-depth dead-end memo.  If re-execution cannot reproduce a recorded
fingerprint the model is nondeterministic (or its representative disagrees
with the device canonicalizer) and the walk raises with a diagnostic, as
the reference does.
"""

from __future__ import annotations

from typing import Generic, Iterable, Optional, Sequence, TypeVar

State = TypeVar("State")
Action = TypeVar("Action")

_NONDETERMINISM_MSG = """\
Failed to reconstruct a path because the model is not deterministic.
Refusing to continue. This usually happens when a state contains a
container whose iteration order is not stable across identical states
(e.g. iterating a Python set whose insertion order differs), or when
actions/next_state consult randomness or wall-clock time. Make the
model a pure function of its inputs. Missing fingerprint: {fp:#018x}
after {n} matched step(s)."""


class Path(Generic[State, Action]):
    """A pair sequence ``[(state, action), ..., (final_state, None)]``."""

    def __init__(self, pairs: Sequence[tuple[State, Optional[Action]]]):
        if not pairs:
            raise ValueError("empty path")
        self._pairs = list(pairs)

    # -- construction --------------------------------------------------------

    @staticmethod
    def from_fingerprints(model, fingerprints: Sequence[int], key=None) -> "Path":
        """Re-execute ``model`` along a fingerprint trace
        (reference ``path.rs:20-86``).

        ``key`` overrides the per-state fingerprint used for matching:
        symmetry-reduced GPU runs pass the canonical fingerprint
        (``fingerprint_state(representative(s))``, or a twin's
        ``representative_key``), so the walk picks, at each step, an actual
        successor of the previously chosen member whose symmetry class
        matches the trace.  The result is a genuine path of the model."""
        if not fingerprints:
            raise ValueError("empty fingerprint path")
        fps = list(fingerprints)
        if key is None:
            # exact fingerprints are injective along the trace: the greedy
            # first-match walk is exhaustive, no backtracking needed
            key = model.fingerprint_state
            greedy = True
        else:
            # a symmetry key maps whole classes to one fingerprint, and the
            # representative need not be class-invariant: committing to the
            # wrong member can dead-end even though the trace is valid, so
            # the walk backtracks over matching members
            greedy = False

        # members proven to dead-end, per depth: whether a member can match
        # the remaining suffix depends only on (member, depth), never on the
        # prefix that reached it, so a dead end holds across alternatives,
        # and skipping it bounds the walk at O(members x depth)
        dead: dict[int, set] = {}

        def matches(state, want, depth):
            out = []
            seen_members = set()
            blocked = dead.get(depth, ())
            for action in model.actions(state):
                nxt = model.next_state(state, action)
                if nxt is not None and key(nxt) == want:
                    if greedy:
                        return [(action, nxt)]
                    # distinct actions often give the identical successor;
                    # keep one per member, or backtracking re-explores the
                    # same dead-end subtree per duplicate
                    member = model.fingerprint_state(nxt)
                    if member not in seen_members and member not in blocked:
                        seen_members.add(member)
                        out.append((action, nxt))
            return out

        init_matches = [
            (None, s) for s in model.init_states() if key(s) == fps[0]
        ]
        if not init_matches:
            raise RuntimeError(_NONDETERMINISM_MSG.format(fp=fps[0], n=0))
        # DFS over (depth, chosen member) with an explicit alternatives stack
        stack = [(0, init_matches)]  # depth i: candidates matching fps[i]
        chosen: list[tuple[Optional[Action], State]] = []
        deepest = 0  # deepest matched depth, for the failure diagnostic
        while stack:
            depth, cands = stack[-1]
            if not cands:
                stack.pop()
                if chosen:
                    popped = chosen.pop()
                    if not greedy:  # every continuation failed: dead end
                        dead.setdefault(depth - 1, set()).add(
                            model.fingerprint_state(popped[1])
                        )
                continue
            act_nxt = cands.pop(0)
            chosen.append(act_nxt)
            deepest = max(deepest, depth)
            if depth + 1 == len(fps):
                pairs: list[tuple[State, Optional[Action]]] = []
                for i in range(len(chosen) - 1):
                    pairs.append((chosen[i][1], chosen[i + 1][0]))
                pairs.append((chosen[-1][1], None))
                return Path(pairs)
            nxt_cands = matches(act_nxt[1], fps[depth + 1], depth + 1)
            if nxt_cands:
                stack.append((depth + 1, nxt_cands))
            else:
                chosen.pop()
                if not greedy:  # no viable continuation at all: dead end
                    dead.setdefault(depth, set()).add(
                        model.fingerprint_state(act_nxt[1])
                    )
        if not greedy:
            raise RuntimeError(
                "Failed to reconstruct a symmetry-reduced path: no sequence "
                "of class members matches the recorded canonical "
                f"fingerprints (failed past step {deepest} of {len(fps)}). "
                "This indicates the model's representative() disagrees with "
                "the device canonicalizer, or the model is nondeterministic."
            )
        raise RuntimeError(
            _NONDETERMINISM_MSG.format(fp=fps[deepest + 1], n=deepest)
        )

    @staticmethod
    def from_actions(
        model, init_state: State, actions: Iterable[Action]
    ) -> Optional["Path"]:
        """Follow an action sequence from ``init_state``; ``None`` if any
        action is unavailable (reference ``path.rs:90-112``)."""
        pairs: list[tuple[State, Optional[Action]]] = []
        state = init_state
        for action in actions:
            if action not in list(model.actions(state)):
                return None
            nxt = model.next_state(state, action)
            if nxt is None:
                return None
            pairs.append((state, action))
            state = nxt
        pairs.append((state, None))
        return Path(pairs)

    # -- accessors -----------------------------------------------------------

    def last_state(self) -> State:
        return self._pairs[-1][0]

    final_state = last_state

    def states(self) -> list[State]:
        return [s for s, _ in self._pairs]

    def actions(self) -> list[Action]:
        return [a for _, a in self._pairs if a is not None]

    def into_vec(self) -> list[tuple[State, Optional[Action]]]:
        return list(self._pairs)

    def encode(self, model) -> str:
        """``/``-joined fingerprints, as the Explorer's URLs use them
        (reference ``path.rs:160-165``)."""
        return "/".join(str(model.fingerprint_state(s)) for s, _ in self._pairs)

    def __len__(self) -> int:
        return len(self._pairs)

    def __eq__(self, other) -> bool:
        return isinstance(other, Path) and self._pairs == other._pairs

    def __hash__(self) -> int:
        from ..fingerprint import stable_hash

        try:
            return stable_hash(
                tuple(
                    (stable_hash(s), 0 if a is None else stable_hash(a))
                    for s, a in self._pairs
                )
            )
        except TypeError:
            # exotic unhashable actions: a weak but eq-consistent hash
            return len(self._pairs)

    def __repr__(self) -> str:
        return "Path[" + ", ".join(repr(a) for a in self.actions()) + "]"

    def __str__(self) -> str:
        return "\n".join(str(a) for a in self.actions())
