"""Stable 64-bit fingerprinting, identical on host (Python/NumPy) and device
(PyTorch / CUDA).

The port's own copy of ``stateright_tpu/fingerprint.py`` (the splitmix64
constants, ``mix64``/``fold64``/``hash_words`` and the structural
``fingerprint``); the sweep namespacing helpers stay behind until the sweep
slice.  The device row hash (``ops/hashing.py`` and ``csrc/row_hash.cu``)
must equal :func:`hash_words` bit for bit.

The reference derives state identity from a seeded 64-bit hash with fixed keys so
fingerprints are reproducible across runs and builds (reference:
``src/lib.rs:302-344``).  We need something stronger than that: the *same*
fingerprint function must be computable

 - as a scalar Python function over arbitrary structured states (object form),
 - as a vectorized PyTorch function (and a CUDA kernel) over fixed-width
   64-bit row encodings (tensor form, evaluated on the card inside the
   wavefront BFS engine),

so that Explorer URLs, path reconstruction, and discovery bookkeeping agree
bit-for-bit regardless of which backend produced them.

The mixer is the splitmix64 finalizer (public-domain constants), folded over the
64-bit words of the state with a fixed seed.  Structured Python values are
canonically serialized to a word stream first (see :func:`stable_words`), with
order-insensitive folding for sets/maps like the reference's
``HashableHashSet``/``HashableHashMap`` (reference: ``src/util.rs:124-145``):
per-element hashes are sorted before being folded, so any iteration order
produces the same digest.
"""

from __future__ import annotations

import dataclasses
import struct
from enum import Enum
from typing import Any, Callable, Iterable

MASK64 = (1 << 64) - 1

# splitmix64 finalizer constants (public domain, Sebastiano Vigna).
_SM_GAMMA = 0x9E3779B97F4A7C15
_SM_M1 = 0xBF58476D1CE4E5B9
_SM_M2 = 0x94D049BB133111EB

# Fixed seed: fingerprints must be stable across processes/builds.
FINGERPRINT_SEED = 0x5374617465544655  # b"StateTFU"

# Type tags mixed into structural hashes so (1,) != [1] != {1}.
_TAG_NONE = 0x01
_TAG_BOOL = 0x02
_TAG_INT = 0x03
_TAG_FLOAT = 0x04
_TAG_STR = 0x05
_TAG_BYTES = 0x06
_TAG_TUPLE = 0x07
_TAG_LIST = 0x08
_TAG_SET = 0x09
_TAG_DICT = 0x0A
_TAG_OBJECT = 0x0B
_TAG_ENUM = 0x0C
_TAG_NEG = 0x0D
_TAG_BIGINT = 0x0E


def mix64(h: int) -> int:
    """splitmix64 finalizer: a strong 64-bit bijective mixer."""
    h &= MASK64
    h ^= h >> 30
    h = (h * _SM_M1) & MASK64
    h ^= h >> 27
    h = (h * _SM_M2) & MASK64
    h ^= h >> 31
    return h


def fold64(h: int, word: int) -> int:
    """Fold one 64-bit word into the running digest."""
    return mix64((h ^ (word & MASK64)) + _SM_GAMMA & MASK64)


def hash_words(words: Iterable[int], seed: int = FINGERPRINT_SEED) -> int:
    """Hash a stream of u64 words. This is THE fingerprint function: the device
    row-hash (ops/hashing.py) implements exactly this over uint64 rows."""
    h = seed & MASK64
    n = 0
    for w in words:
        h = fold64(h, w)
        n += 1
    h = fold64(h, n)  # length-extension guard
    if h == 0 or h == MASK64:
        # 0 is reserved as the "no parent / no discovery" marker and 2^64-1 as
        # the device hash-table empty-slot sentinel; remap both (same accepted
        # collision class as 64-bit fp collisions generally).
        h = _SM_GAMMA
    return h


# ---------------------------------------------------------------------------
# Structural (object-form) stable hashing
# ---------------------------------------------------------------------------

_custom_hashers: list[tuple[type, Callable[[Any], int]]] = []


def register_stable_hash(cls: type, fn: Callable[[Any], int]) -> None:
    """Register a custom stable-hash function for a user type."""
    _custom_hashers.append((cls, fn))


def stable_words(obj: Any, out: list[int]) -> None:
    """Append the canonical u64 word stream of ``obj`` to ``out``.

    Deterministic across processes (unlike builtin ``hash``, which is
    randomized for str/bytes).  Sets and dicts are folded order-insensitively
    by hashing each element independently and sorting the element digests.
    """
    if obj is None:
        out.append(_TAG_NONE)
    elif obj is True or obj is False:
        out.append(_TAG_BOOL)
        out.append(1 if obj else 0)
    elif type(obj) is int:
        if 0 <= obj < (1 << 64):
            out.append(_TAG_INT)
            out.append(obj)
        elif -(1 << 64) < obj < 0:
            # distinct tag so -1 and 2**64-1 cannot collide
            out.append(_TAG_NEG)
            out.append(-obj)
        else:  # arbitrary precision: split into 64-bit limbs
            out.append(_TAG_BIGINT)
            neg = obj < 0
            v = -obj if neg else obj
            limbs = []
            while v:
                limbs.append(v & MASK64)
                v >>= 64
            out.append((_TAG_NEG if neg else 0) ^ len(limbs))
            out.extend(limbs)
    elif type(obj) is float:
        out.append(_TAG_FLOAT)
        out.append(struct.unpack("<Q", struct.pack("<d", obj))[0])
    elif type(obj) is str:
        b = obj.encode("utf-8")
        out.append(_TAG_STR)
        out.append(len(b))
        for i in range(0, len(b), 8):
            out.append(int.from_bytes(b[i : i + 8], "little"))
    elif type(obj) is bytes:
        out.append(_TAG_BYTES)
        out.append(len(obj))
        for i in range(0, len(obj), 8):
            out.append(int.from_bytes(obj[i : i + 8], "little"))
    elif isinstance(obj, Enum):
        out.append(_TAG_ENUM)
        stable_words(type(obj).__name__, out)
        stable_words(obj.value, out)
    elif type(obj) is tuple or type(obj) is list:
        out.append(_TAG_TUPLE if type(obj) is tuple else _TAG_LIST)
        out.append(len(obj))
        for x in obj:
            stable_words(x, out)
    elif isinstance(obj, (set, frozenset)):
        out.append(_TAG_SET)
        out.append(len(obj))
        out.extend(sorted(stable_hash(x) for x in obj))
    elif isinstance(obj, dict):
        out.append(_TAG_DICT)
        out.append(len(obj))
        out.extend(
            sorted(fold64(stable_hash(k), stable_hash(v)) for k, v in obj.items())
        )
    else:
        for cls, fn in _custom_hashers:
            if isinstance(obj, cls):
                out.append(_TAG_OBJECT)
                out.append(fn(obj) & MASK64)
                return
        sw = getattr(obj, "stable_words", None)
        if sw is not None:
            out.append(_TAG_OBJECT)
            stable_words(type(obj).__name__, out)
            sw(out)
        elif dataclasses.is_dataclass(obj):
            out.append(_TAG_OBJECT)
            stable_words(type(obj).__name__, out)
            for f in dataclasses.fields(obj):
                stable_words(getattr(obj, f.name), out)
        elif isinstance(obj, int):
            # int subclasses without custom hooks (e.g. actor Id) hash as
            # their integer value
            stable_words(int(obj), out)
        else:
            raise TypeError(
                f"cannot stably hash {type(obj).__name__}: define stable_words(out),"
                " use a dataclass, or register_stable_hash()"
            )


def stable_hash(obj: Any) -> int:
    """64-bit order-stable structural hash of a Python value."""
    words: list[int] = []
    stable_words(obj, words)
    return hash_words(words)


def fingerprint(obj: Any) -> int:
    """State fingerprint: nonzero stable 64-bit digest (reference
    ``src/lib.rs:303-311`` uses NonZeroU64; hash_words already avoids 0)."""
    return stable_hash(obj)
