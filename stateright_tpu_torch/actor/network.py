"""In-model network semantics (reference ``src/actor/network.rs``).

The port's own copy of ``stateright_tpu/actor/network.py``; the ordered
network and the symmetry ``rewrite`` hooks come with the slices that use
them.

The network is *state data*, not I/O: pending messages are part of the
checked system state, and delivery/drop/duplication are state-space actions.
Two of the reference's semantics (``network.rs:44-64``):

 - **unordered_duplicating** — a set of envelopes; delivery leaves the
   envelope in place (redelivery allowed), drop removes it forever.  It is
   ``ActorModel``'s default, as in the reference.
 - **unordered_nonduplicating** — a multiset (envelope -> count); delivery
   and drop each consume one copy.

Both are persistent values: mutation returns a new network.  Equality
and stable hashing are order-insensitive, mirroring the reference's
sorted-pre-hash containers (``util.rs:124-145``).  The device twin packs
the non-duplicating multiset as sorted slot words
(``parallel/actor_tensor.py``); this module is the object-form oracle.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterable, Iterator

from ..fingerprint import stable_hash


@dataclass(frozen=True)
class Envelope:
    """A message in flight (reference ``network.rs:24-26``)."""

    src: Any  # Id
    dst: Any  # Id
    msg: Any

    def __repr__(self):
        return f"Envelope(src={self.src!r}, dst={self.dst!r}, msg={self.msg!r})"


class Network:
    """Base class + constructors (reference ``network.rs:66-140``)."""

    name: str = ""

    @staticmethod
    def new_unordered_duplicating(
        envelopes: Iterable[Envelope] = (),
    ) -> "UnorderedDuplicatingNetwork":
        n = UnorderedDuplicatingNetwork({})
        for env in envelopes:
            n = n.send(env)
        return n

    @staticmethod
    def new_unordered_nonduplicating(
        envelopes: Iterable[Envelope] = (),
    ) -> "UnorderedNonDuplicatingNetwork":
        n = UnorderedNonDuplicatingNetwork({})
        for env in envelopes:
            n = n.send(env)
        return n

    @staticmethod
    def names() -> list[str]:
        return ["unordered_duplicating", "unordered_nonduplicating"]

    @staticmethod
    def from_name(name: str) -> "Network":
        try:
            return {
                "unordered_duplicating": Network.new_unordered_duplicating,
                "unordered_nonduplicating": Network.new_unordered_nonduplicating,
            }[name]()
        except KeyError:
            raise ValueError(f"unable to parse network name: {name}") from None

    # -- interface -----------------------------------------------------------

    def send(self, env: Envelope) -> "Network":
        raise NotImplementedError

    def on_deliver(self, env: Envelope) -> "Network":
        raise NotImplementedError

    def on_drop(self, env: Envelope) -> "Network":
        raise NotImplementedError

    def iter_deliverable(self) -> Iterator[Envelope]:
        """Distinct deliverable envelopes."""
        raise NotImplementedError

    def iter_all(self) -> Iterator[Envelope]:
        """Every envelope, with multiplicity."""
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError


class UnorderedDuplicatingNetwork(Network):
    """Messages race and can be redelivered (reference ``network.rs:47-48``).
    Delivery is a no-op; only an explicit drop removes an envelope
    (``network.rs:203-205,242-244``)."""

    name = "unordered_duplicating"
    __slots__ = ("_envs",)

    def __init__(self, envs: dict):
        # dict[Envelope, None] as an insertion-ordered set: deterministic
        # iteration within a process, order-insensitive equality
        self._envs = envs

    def send(self, env: Envelope) -> "UnorderedDuplicatingNetwork":
        if env in self._envs:
            return self
        d = dict(self._envs)
        d[env] = None
        return UnorderedDuplicatingNetwork(d)

    def on_deliver(self, env: Envelope) -> "UnorderedDuplicatingNetwork":
        return self  # redelivery allowed

    def on_drop(self, env: Envelope) -> "UnorderedDuplicatingNetwork":
        d = dict(self._envs)
        d.pop(env, None)
        return UnorderedDuplicatingNetwork(d)

    def iter_deliverable(self):
        return iter(self._envs)

    def iter_all(self):
        return iter(self._envs)

    def __len__(self):
        return len(self._envs)

    def __eq__(self, other):
        return (
            isinstance(other, UnorderedDuplicatingNetwork)
            and self._envs.keys() == other._envs.keys()
        )

    def __hash__(self):
        return stable_hash(frozenset(stable_hash(e) for e in self._envs))

    def stable_words(self, out: list) -> None:
        out.append(0xD0)
        out.append(len(self._envs))
        out.extend(sorted(stable_hash(e) for e in self._envs))

    def __repr__(self):
        return f"UnorderedDuplicating({list(self._envs)!r})"


class UnorderedNonDuplicatingNetwork(Network):
    """Multiset of envelopes: no ordering, no redelivery
    (reference ``network.rs:50-51,188-190``)."""

    name = "unordered_nonduplicating"
    __slots__ = ("_counts",)

    def __init__(self, counts: dict):
        self._counts = counts  # Envelope -> positive count

    def send(self, env: Envelope) -> "UnorderedNonDuplicatingNetwork":
        d = dict(self._counts)
        d[env] = d.get(env, 0) + 1
        return UnorderedNonDuplicatingNetwork(d)

    def _consume(self, env: Envelope) -> "UnorderedNonDuplicatingNetwork":
        if env not in self._counts:
            raise KeyError(f"envelope not found: {env!r}")
        d = dict(self._counts)
        if d[env] == 1:
            del d[env]
        else:
            d[env] -= 1
        return UnorderedNonDuplicatingNetwork(d)

    on_deliver = _consume
    on_drop = _consume

    def iter_deliverable(self):
        return iter(self._counts)

    def iter_all(self):
        for env, count in self._counts.items():
            for _ in range(count):
                yield env

    def __len__(self):
        return sum(self._counts.values())

    def __eq__(self, other):
        return (
            isinstance(other, UnorderedNonDuplicatingNetwork)
            and self._counts == other._counts
        )

    def __hash__(self):
        return stable_hash(
            frozenset((stable_hash(e), c) for e, c in self._counts.items())
        )

    def stable_words(self, out: list) -> None:
        out.append(0xD1)
        out.append(len(self._counts))
        out.extend(
            sorted(
                stable_hash((stable_hash(e), c)) for e, c in self._counts.items()
            )
        )

    def __repr__(self):
        return f"UnorderedNonDuplicating({dict(self._counts)!r})"
