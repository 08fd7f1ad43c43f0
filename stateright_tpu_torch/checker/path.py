"""Traces through a model's state space (reference ``src/checker/path.rs``).

The port's counterpart of ``stateright_tpu/checker/path.py``.  A
:class:`Path` is a sequence ``state --action--> state --action--> ... state``.
The GPU engine stores only ``fp -> parent fp``, so materializing a path
*re-executes* the object-form model and matches successor fingerprints
(reference ``path.rs:20-86``).  Exact fingerprints are injective along a
trace, so the greedy first-match walk is exhaustive; the backtracking walk
that symmetry keys need comes with the symmetry slice.  If re-execution
cannot reproduce a recorded fingerprint the model is nondeterministic and
the walk raises with a diagnostic, as the reference does.
"""

from __future__ import annotations

from typing import Generic, Optional, Sequence, TypeVar

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
    def from_fingerprints(model, fingerprints: Sequence[int]) -> "Path":
        """Re-execute ``model`` along a fingerprint trace (greedy walk)."""
        fps = list(fingerprints)
        if not fps:
            raise ValueError("empty fingerprint path")
        key = model.fingerprint_state
        state = next((s for s in model.init_states() if key(s) == fps[0]), None)
        if state is None:
            raise RuntimeError(_NONDETERMINISM_MSG.format(fp=fps[0], n=0))
        pairs: list[tuple[State, Optional[Action]]] = []
        for depth, want in enumerate(fps[1:], start=1):
            step = next(
                (
                    (action, nxt)
                    for action in model.actions(state)
                    if (nxt := model.next_state(state, action)) is not None
                    and key(nxt) == want
                ),
                None,
            )
            if step is None:
                raise RuntimeError(
                    _NONDETERMINISM_MSG.format(fp=want, n=depth - 1)
                )
            pairs.append((state, step[0]))
            state = step[1]
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

    def __len__(self) -> int:
        return len(self._pairs)

    def __eq__(self, other) -> bool:
        return isinstance(other, Path) and self._pairs == other._pairs

    def __repr__(self) -> str:
        return "Path[" + ", ".join(repr(a) for a in self.actions()) + "]"

    def __str__(self) -> str:
        return "\n".join(str(a) for a in self.actions())
