"""In-model network semantics (reference ``src/actor/network.rs``).

The port's own copy of ``stateright_tpu/actor/network.py``, with the
symmetry ``rewrite(plan)`` hook of each network (``symmetry.py``).

The network is *state data*, not I/O: pending messages are part of the
checked system state, and delivery/drop/duplication are state-space actions.
The reference's three semantics (``network.rs:44-64``):

 - **unordered_duplicating** — a set of envelopes; delivery leaves the
   envelope in place (redelivery allowed), drop removes it forever.  It is
   ``ActorModel``'s default, as in the reference.
 - **unordered_nonduplicating** — a multiset (envelope -> count); delivery
   and drop each consume one copy.
 - **ordered** — per directed ``(src, dst)`` pair, a FIFO queue; only heads
   are deliverable.

All are persistent values: mutation returns a new network.  Equality
and stable hashing are order-insensitive, mirroring the reference's
sorted-pre-hash containers (``util.rs:124-145``).  The device twins pack
the network as sorted slot words (``parallel/actor_tensor.py``); this
module is the object-form oracle.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterable, Iterator, Tuple

from ..fingerprint import hash_words, stable_hash, stable_words


@dataclass(frozen=True)
class Envelope:
    """A message in flight (reference ``network.rs:24-26``)."""

    src: Any  # Id
    dst: Any  # Id
    msg: Any

    @property
    def channel(self) -> Tuple[int, int]:
        """The directed ``(src, dst)`` channel this envelope travels on:
        the unit of the per-channel device packing
        (``parallel/actor_compiler.py``) and, for ordered networks, the
        FIFO flow key."""
        return (int(self.src), int(self.dst))

    def __repr__(self):
        return f"Envelope(src={self.src!r}, dst={self.dst!r}, msg={self.msg!r})"


class Network:
    """Base class + constructors (reference ``network.rs:66-140``)."""

    name: str = ""

    @staticmethod
    def new_ordered(envelopes: Iterable[Envelope] = ()) -> "OrderedNetwork":
        n = OrderedNetwork({})
        for env in envelopes:
            n = n.send(env)
        return n

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
        return ["ordered", "unordered_duplicating", "unordered_nonduplicating"]

    @staticmethod
    def from_name(name: str) -> "Network":
        try:
            return {
                "ordered": Network.new_ordered,
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
        """Distinct deliverable envelopes (heads only for ordered flows)."""
        raise NotImplementedError

    def iter_all(self) -> Iterator[Envelope]:
        """Every envelope, with multiplicity."""
        raise NotImplementedError

    def channels(self) -> list:
        """Sorted directed ``(src, dst)`` channels currently carrying
        traffic: for ordered networks the FIFO flows, for the unordered
        semantics the per-destination confinement the per-channel device
        packing relies on."""
        return sorted({env.channel for env in self.iter_all()})

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

    def rewrite(self, plan):
        from ..symmetry import rewrite_value

        n = UnorderedDuplicatingNetwork({})
        for env in self._envs:
            n = n.send(rewrite_value(env, plan))
        return n

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

    def rewrite(self, plan):
        from ..symmetry import rewrite_value

        d: dict = {}
        for env, count in self._counts.items():
            key = rewrite_value(env, plan)
            d[key] = d.get(key, 0) + count
        return UnorderedNonDuplicatingNetwork(d)

    def __repr__(self):
        return f"UnorderedNonDuplicating({dict(self._counts)!r})"


class OrderedNetwork(Network):
    """Per-directed-pair FIFO flows (reference ``network.rs:53-63``).  Only
    the head of each flow is deliverable; empty flows are removed so removal
    is the exact inverse of insertion (``network.rs:219-235``)."""

    name = "ordered"
    __slots__ = ("_flows",)

    def __init__(self, flows: dict):
        self._flows = flows  # (src, dst) -> tuple of msgs (non-empty)

    def send(self, env: Envelope) -> "OrderedNetwork":
        key = (env.src, env.dst)
        d = dict(self._flows)
        d[key] = d.get(key, ()) + (env.msg,)
        return OrderedNetwork(d)

    def _remove(self, env: Envelope) -> "OrderedNetwork":
        key = (env.src, env.dst)
        if key not in self._flows:
            raise KeyError(f"flow not found: {key!r}")
        flow = self._flows[key]
        try:
            i = flow.index(env.msg)
        except ValueError:
            raise KeyError(f"message not found in flow: {env!r}") from None
        d = dict(self._flows)
        if len(flow) == 1:
            del d[key]
        else:
            d[key] = flow[:i] + flow[i + 1 :]
        return OrderedNetwork(d)

    on_deliver = _remove
    on_drop = _remove

    def iter_deliverable(self):
        # sorted flow order like the reference's BTreeMap for determinism
        for key in sorted(self._flows):
            yield Envelope(key[0], key[1], self._flows[key][0])

    def iter_all(self):
        for key in sorted(self._flows):
            for msg in self._flows[key]:
                yield Envelope(key[0], key[1], msg)

    def __len__(self):
        return sum(len(f) for f in self._flows.values())

    def __eq__(self, other):
        return isinstance(other, OrderedNetwork) and self._flows == other._flows

    def __hash__(self):
        return stable_hash(
            frozenset(
                (int(k[0]), int(k[1]), stable_hash(tuple(v)))
                for k, v in self._flows.items()
            )
        )

    def stable_words(self, out: list) -> None:
        out.append(0xD2)
        out.append(len(self._flows))
        hashes = []
        for (src, dst), msgs in self._flows.items():
            words: list = [int(src), int(dst)]
            stable_words(tuple(msgs), words)
            hashes.append(hash_words(words))
        out.extend(sorted(hashes))

    def rewrite(self, plan):
        from ..symmetry import rewrite_value

        return OrderedNetwork(
            {
                (plan.rewrite_id(k[0]), plan.rewrite_id(k[1])): tuple(
                    rewrite_value(m, plan) for m in v
                )
                for k, v in self._flows.items()
            }
        )

    def __repr__(self):
        return f"Ordered({dict(self._flows)!r})"
