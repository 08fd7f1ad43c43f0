"""Symmetry reduction (reference ``src/checker/representative.rs``,
``rewrite.rs``, ``rewrite_plan.rs``).

The port's own copy of ``stateright_tpu/symmetry.py``.  Many distributed
systems are symmetric under permutations of identical processes: exploring
one member of each equivalence class suffices.  A state type opts in by
defining ``representative()``, which returns the canonical member of its
class; the checkers then dedup on the representative's fingerprint while
the search goes on with the original state, so paths stay valid
(reference ``dfs.rs:260-285``).

:class:`RewritePlan` is a permutation derived by sorting values (the
reference's double argsort, ``rewrite_plan.rs:74-96``).
:func:`rewrite_value` applies a plan recursively through tuples, lists,
sets, dicts, dataclasses and anything defining ``rewrite(plan)``
(reference ``rewrite.rs:49-135``).  ``reindex`` is a pure permutation;
element rewriting is explicit through :func:`rewrite_value`.
"""

from __future__ import annotations

import dataclasses
from enum import Enum
from typing import Any, Callable, Iterable, Optional, Sequence


class RewritePlan:
    """A permutation of dense nat-like ids: ``mapping[old] = new``."""

    def __init__(self, mapping: Sequence[int]):
        self.mapping = list(mapping)

    @staticmethod
    def from_values_to_sort(
        values: Iterable[Any], key: Optional[Callable] = None
    ) -> "RewritePlan":
        """The plan that would stably sort ``values``: a double argsort
        (reference ``rewrite_plan.rs:74-96``).  ``key`` defaults to the
        values themselves; pass ``stable_hash`` for unorderable values."""
        vals = list(values)
        keyed = [(key(v) if key else v) for v in vals]
        order = sorted(range(len(vals)), key=lambda i: keyed[i])  # new -> old
        mapping = [0] * len(vals)
        for new, old in enumerate(order):
            mapping[old] = new
        return RewritePlan(mapping)

    def rewrite_id(self, x: int) -> int:
        from .actor import Id

        return Id(self.mapping[int(x)])

    def reindex(self, seq: Sequence) -> list:
        """Permute a dense vector: ``result[new] = seq[old]``."""
        out = [None] * len(self.mapping)
        for old, new in enumerate(self.mapping):
            out[new] = seq[old]
        return out

    def __repr__(self):
        return f"RewritePlan({self.mapping!r})"


def rewrite_value(x: Any, plan: RewritePlan) -> Any:
    """Rewrite the actor ids inside ``x`` by ``plan``, recursively
    (reference ``rewrite.rs:18-135``)."""
    from .actor import Id

    if isinstance(x, Id):
        return plan.rewrite_id(x)
    if x is None or isinstance(x, (bool, str, bytes, float, Enum)):
        return x
    if type(x) is int:
        return x
    rw = getattr(x, "rewrite", None)
    if rw is not None:
        return rw(plan)
    if isinstance(x, tuple):
        return tuple(rewrite_value(v, plan) for v in x)
    if isinstance(x, list):
        return [rewrite_value(v, plan) for v in x]
    if isinstance(x, frozenset):
        return frozenset(rewrite_value(v, plan) for v in x)
    if isinstance(x, set):
        return {rewrite_value(v, plan) for v in x}
    if isinstance(x, dict):
        return {
            rewrite_value(k, plan): rewrite_value(v, plan) for k, v in x.items()
        }
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(
            x,
            **{
                f.name: rewrite_value(getattr(x, f.name), plan)
                for f in dataclasses.fields(x)
            },
        )
    return x  # int subclasses other than Id and opaque scalars pass through
