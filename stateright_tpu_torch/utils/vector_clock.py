"""Vector clocks: a partial causal order (reference ``src/util/vector_clock.rs``).

The port's own copy of ``stateright_tpu/utils/vector_clock.py``.
Equality, hash and ordering ignore trailing zeros, so clocks over different
actor counts compare sensibly (reference ``vector_clock.rs:54-106``).
"""

from __future__ import annotations

from typing import Iterable, Optional

from ..fingerprint import stable_words


class VectorClock:
    __slots__ = ("_v",)

    def __init__(self, values: Iterable[int] = ()):
        self._v = list(values)

    def _trimmed(self) -> tuple[int, ...]:
        v = self._v
        n = len(v)
        while n and v[n - 1] == 0:
            n -= 1
        return tuple(v[:n])

    def get(self, i: int) -> int:
        return self._v[i] if i < len(self._v) else 0

    def incremented(self, i: int) -> "VectorClock":
        """Copy with index ``i`` bumped (reference ``vector_clock.rs:34-40``)."""
        v = self._v + [0] * (i + 1 - len(self._v))
        v[i] += 1
        return VectorClock(v)

    def merge_max(self, other: "VectorClock") -> "VectorClock":
        """Element-wise max (reference ``vector_clock.rs:21-31``)."""
        n = max(len(self._v), len(other._v))
        return VectorClock(max(self.get(i), other.get(i)) for i in range(n))

    def partial_cmp(self, other: "VectorClock") -> Optional[int]:
        """-1/0/1 if comparable under the causal order, else ``None``."""
        n = max(len(self._v), len(other._v))
        lt = gt = False
        for i in range(n):
            a, b = self.get(i), other.get(i)
            if a < b:
                lt = True
            elif a > b:
                gt = True
        if lt and gt:
            return None
        return (-1 if lt else 0) if not gt else 1

    def __lt__(self, other) -> bool:
        return self.partial_cmp(other) == -1

    def __eq__(self, other) -> bool:
        return isinstance(other, VectorClock) and self._trimmed() == other._trimmed()

    def __hash__(self) -> int:
        return hash(self._trimmed())

    def stable_words(self, out: list[int]) -> None:
        stable_words(self._trimmed(), out)

    def __repr__(self) -> str:
        return f"VectorClock({self._v!r})"
