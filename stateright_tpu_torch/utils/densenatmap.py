"""Type-safe map keyed by densely packed nat-like keys
(reference ``src/util/densenatmap.rs``).

The port's own copy of ``stateright_tpu/utils/densenatmap.py``.  Values are
stored in a list indexed by ``int(key)``; inserting past the end with a gap
is an error, which catches off-by-one actor-Id bugs early.  Keys are
anything convertible with ``int()`` (e.g. actor ``Id``).
"""

from __future__ import annotations

from typing import Generic, Iterable, Iterator, TypeVar

from ..fingerprint import stable_words
from ..symmetry import rewrite_value

K = TypeVar("K")
V = TypeVar("V")


class DenseNatMap(Generic[K, V]):
    def __init__(self, values: Iterable[V] = ()):
        self._values: list[V] = list(values)

    @staticmethod
    def from_iter(values: Iterable[V]) -> "DenseNatMap":
        return DenseNatMap(values)

    def insert(self, key: K, value: V) -> None:
        """Insert at ``key``; the key must be in-bounds or exactly one past the
        end (reference ``densenatmap.rs:95-109`` panics on gaps)."""
        i = int(key)
        if i < len(self._values):
            self._values[i] = value
        elif i == len(self._values):
            self._values.append(value)
        else:
            raise IndexError(
                f"DenseNatMap gap insert: key {i} with len {len(self._values)}"
            )

    def __getitem__(self, key: K) -> V:
        return self._values[int(key)]

    def __setitem__(self, key: K, value: V) -> None:
        self.insert(key, value)

    def get(self, key: K):
        i = int(key)
        return self._values[i] if 0 <= i < len(self._values) else None

    def __len__(self) -> int:
        return len(self._values)

    def __iter__(self) -> Iterator[V]:
        return iter(self._values)

    def values(self) -> list[V]:
        return list(self._values)

    def items(self):
        return list(enumerate(self._values))

    def __eq__(self, other) -> bool:
        return isinstance(other, DenseNatMap) and self._values == other._values

    def __repr__(self) -> str:
        return f"DenseNatMap({self._values!r})"

    def stable_words(self, out: list[int]) -> None:
        stable_words(tuple(self._values), out)

    def rewrite(self, plan) -> "DenseNatMap":
        """Reindex + rewrite values under a symmetry permutation
        (reference ``densenatmap.rs:209-223``)."""
        reindexed = plan.reindex(self._values)
        return DenseNatMap(rewrite_value(v, plan) for v in reindexed)
