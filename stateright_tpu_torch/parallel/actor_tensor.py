"""Device encoding of the in-model network: a sorted-slot multiset.

The port's counterpart of ``stateright_tpu/parallel/actor_tensor.py``: the
slot codec and the slot-multiset ops as plain PyTorch on int64 bit
patterns (``ops/hashing.py``).  The ordered-flow sends
(``slot_send_ordered``, ``region_send_ordered``) come with the actor
compiler.

The reference's unordered non-duplicating network is a multiset of
envelopes (``src/actor/network.rs:188-190``).  The tensor form packs each
*distinct* envelope into one 64-bit slot word::

    slot = envelope_code << COUNT_BITS | count      (EMPTY = 2^64-1 if free)

and keeps the slot array sorted ascending *as unsigned words*, so equal
multisets produce equal words in equal positions.  On the device the empty
slot is the int64 ``-1``, which a signed sort would put first:
:func:`slot_canonicalize` sorts on ``x ^ 2^63``, the unsigned order.  Codes
may use all 58 bits above the count, so a slot word's top bit may be set.

Device ops (pure, batched over leading axes):

 - :func:`slot_deliver` — decrement count at a slot index; free at zero.
 - :func:`slot_send` — increment an existing code's count or claim the
   first free slot (the caller re-sorts once per step via
   :func:`slot_canonicalize`).
 - :func:`slot_canonicalize` — re-sort so EMPTY slots sink to the end.

Host-side, :class:`SlotCodec` mirrors the packing for ``encode_state`` /
``decode_state`` bridges.
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch

from ..fingerprint import MASK64
from ..ops.hashing import SIGN, lshr, to_i64

COUNT_BITS = 6
COUNT_MASK = (1 << COUNT_BITS) - 1
SLOT_EMPTY = MASK64  # the free slot's unsigned word
_EMPTY = to_i64(SLOT_EMPTY)  # ... and its int64 bit pattern (-1)


class SlotCodec:
    """Host-side slot packing over an envelope⇄code bijection."""

    def __init__(
        self,
        n_slots: int,
        encode_env: Callable,  # Envelope -> int code
        decode_env: Callable,  # int code -> Envelope
    ):
        self.n_slots = n_slots
        self.encode_env = encode_env
        self.decode_env = decode_env

    def pack(self, env_counts: Iterable[tuple]) -> tuple:
        """``[(envelope, count), ...] -> sorted slot words``."""
        words = []
        for env, count in env_counts:
            if not 1 <= count <= COUNT_MASK:
                raise ValueError(f"count {count} out of range for {env!r}")
            words.append((self.encode_env(env) << COUNT_BITS) | count)
        if len(words) > self.n_slots:
            raise ValueError(
                f"{len(words)} distinct envelopes exceed {self.n_slots} slots"
            )
        words.sort()
        words += [SLOT_EMPTY] * (self.n_slots - len(words))
        return tuple(words)

    def unpack(self, words) -> list[tuple]:
        """``slot words -> [(envelope, count), ...]``; words may be int64
        bit patterns (rows read back from the device) or unsigned."""
        out = []
        for w in words:
            w = int(w) & MASK64
            if w == SLOT_EMPTY:
                continue
            out.append((self.decode_env(w >> COUNT_BITS), w & COUNT_MASK))
        return out


def slot_counts(slots: torch.Tensor) -> torch.Tensor:
    return slots & COUNT_MASK


def slot_codes(slots: torch.Tensor) -> torch.Tensor:
    return lshr(slots, COUNT_BITS)


def slot_occupied(slots: torch.Tensor) -> torch.Tensor:
    return slots != _EMPTY


def slot_deliver(slots: torch.Tensor, index: int) -> torch.Tensor:
    """Consume one instance of the envelope in slot ``index`` (static index;
    batched over leading axes).  Caller must ensure the slot is occupied.
    Returns un-canonicalized slots."""
    w = slots[..., index]
    neww = torch.where(slot_counts(w) <= 1, _EMPTY, w - 1)
    out = slots.clone()
    out[..., index] = neww
    return out


def slot_send(slots: torch.Tensor, code: torch.Tensor, enable: torch.Tensor,
              set_semantics: bool = False):
    """Add one instance of ``code`` (int64[...]) where ``enable`` (bool[...]).

    Existing code -> count+1; else claim the first free slot (one-hot
    select, so repeated sends compose without re-sorting in between; the
    caller canonicalizes once per step).  Returns ``(slots, overflow)``:
    ``overflow`` is True where enable is set but no slot was available, or
    the matched slot's count field is saturated (a count+1 there would carry
    into the envelope-code bits and silently corrupt the row).

    ``set_semantics`` models a *duplicating* network's envelope SET
    (reference ``network.rs:203-205``): sending an already-present code is a
    no-op instead of a count bump, and cannot overflow the count field.
    """
    n = slots.shape[-1]
    occupied = slot_occupied(slots)
    match = occupied & (slot_codes(slots) == code[..., None])
    exists = match.any(dim=-1)
    if set_semantics:
        maxed = torch.zeros_like(exists)
        bumped = slots
    else:
        maxed = (match & (slot_counts(slots) == COUNT_MASK)).any(dim=-1)
        bumped = torch.where(match & (enable & ~maxed)[..., None],
                             slots + 1, slots)

    free = ~occupied
    # the first free slot (argmax returns the first maximum); 0 if none is
    # free, gated below
    first_free = torch.argmax(free.to(torch.int8), dim=-1)
    any_free = free.any(dim=-1)
    claim = enable & ~exists & any_free
    lanes = torch.arange(n, device=slots.device)
    onehot = (lanes == first_free[..., None]) & claim[..., None]
    neww = (code << COUNT_BITS) | 1
    claimed = torch.where(onehot, neww[..., None], bumped)
    overflow = enable & ((~exists & ~any_free) | maxed)
    return claimed, overflow


def slot_canonicalize(slots: torch.Tensor) -> torch.Tensor:
    """Sort slots ascending as unsigned words; EMPTY (all ones) sinks to
    the end."""
    return torch.sort(slots ^ SIGN, dim=-1).values ^ SIGN
