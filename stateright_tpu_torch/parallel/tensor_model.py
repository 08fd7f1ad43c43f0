"""Tensor form of a model: fixed-width 64-bit rows + a batched transition.

The port's counterpart of ``stateright_tpu/parallel/tensor_model.py``.  A
:class:`TensorModel` is the device twin of an object-form
:class:`~stateright_tpu_torch.core.Model`: a static maximum action arity
``max_actions`` and a validity mask instead of dynamic action lists.

Contract (``B`` = batch, ``W`` = width, ``A`` = max_actions, ``P`` = number
of properties, in the object model's ``properties()`` order).  Rows are
int64 tensors holding the 64-bit words' bit patterns (``ops/hashing.py``):

 - ``init_rows() -> numpy uint64[I, W]``
 - ``step_rows(rows: int64[B, W]) -> (int64[B, A, W], bool[B, A])``;
   ``valid[b, a]`` iff action ``a`` is enabled in row ``b`` and yields a
   real successor.  Invalid successor rows may hold garbage.
 - ``property_masks(rows: int64[B, W]) -> bool[B, P]``
 - ``encode_state(state) -> tuple[int, ...]`` / ``decode_state(row)``:
   the host bridge; ``hash_words(encode_state(s))`` equals the device
   ``row_hash`` of the same row.

:class:`FieldWriter` is the JAX writer's coalesced mode, the only one the
port has.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np
import torch

from ..fingerprint import hash_words
from ..ops.hashing import lshr, to_i64


def twin_or_none(model):
    """The model's device twin with host-fallback semantics: None when the
    model declares no twin, or when building it fails in one of the ways
    that mean "no twin for this configuration" (``CompileError``,
    ``NotImplementedError``, ``ValueError``).  Any other error is a fault
    in the twin and raises.  Used by ``spawn_auto``; the GPU spawn path
    itself resolves the twin directly, so construction errors surface
    there instead (JAX ``parallel/tensor_model.py:40``, which host-falls
    back on any error)."""
    from .actor_compiler import CompileError

    try:
        cached = getattr(model, "_tensor_cached", None)
        return (
            cached()
            if cached is not None
            else getattr(model, "tensor_model", lambda: None)()
        )
    except (CompileError, NotImplementedError, ValueError):
        return None


class TensorModel:
    """Base class for device twins of object-form models."""

    width: int  # 64-bit words per state row
    max_actions: int  # static action arity A
    model: Any  # the object-form Model (properties, display, re-execution)

    # -- host-side bridge ----------------------------------------------------

    def init_rows(self) -> np.ndarray:
        raise NotImplementedError

    def encode_state(self, state) -> tuple:
        raise NotImplementedError

    def decode_state(self, row) -> Any:
        raise NotImplementedError

    # -- device-side ---------------------------------------------------------

    def step_rows(self, rows):
        raise NotImplementedError

    def property_masks(self, rows):
        raise NotImplementedError


class TensorBackedModel:
    """Mixin for object-form models that have a tensor twin.

    Overrides ``fingerprint_state`` with the row hash so the host and the
    device agree on state identity.  The twin is resolved once, at the
    first fingerprint, and cached on the model; ``tensor_model()`` may
    return None (no twin for this configuration), and fingerprints then
    fall back to the structural hash.  A builder-style model reports
    configuration changes through ``_config_mutated``: before the first
    fingerprint they drop the cached twin, after it they raise, since the
    fingerprint scheme would silently change mid-run.
    """

    _TENSOR_UNRESOLVED = "unresolved"

    def tensor_model(self) -> Optional[TensorModel]:
        raise NotImplementedError

    def fingerprint_state(self, state) -> int:
        tm = self._tensor_cached()
        if tm is None:
            return super().fingerprint_state(state)
        return hash_words(tm.encode_state(state))

    def _config_mutated(self) -> None:
        if getattr(self, "_tensor_fp_used", False):
            raise RuntimeError(
                "model configuration changed after states were "
                "fingerprinted; configure the model fully before checking "
                "or fingerprinting"
            )
        if hasattr(self, "_tensor_model_cache"):
            object.__delattr__(self, "_tensor_model_cache")

    def _tensor_cached(self) -> Optional[TensorModel]:
        tm = getattr(self, "_tensor_model_cache", self._TENSOR_UNRESOLVED)
        if tm is self._TENSOR_UNRESOLVED:
            tm = self.tensor_model()
            object.__setattr__(self, "_tensor_model_cache", tm)
            # the configuration surface at resolution time: the preflight
            # audit holds the live configuration against it (CF301,
            # analysis/audit.py; JAX tensor_model.py:125-141)
            from ..analysis.audit import config_signature

            object.__setattr__(self, "_tensor_config_sig",
                               config_signature(self))
        object.__setattr__(self, "_tensor_fp_used", True)
        return tm


class RowDomain:
    """Declared value bounds for a tensor row encoding: the seed of the
    sanitizer's interval pass (``analysis/interval.py``); the port's copy
    of ``stateright_tpu/parallel/tensor_model.py:145-230``.

    A twin that defines ``row_domain() -> RowDomain`` tells the static
    sanitizer what each row word (and each packed field) can hold; without
    it the pass falls back to field *widths* discovered from a
    :class:`BitPacker` attribute, which is correct but looser (a 3-bit
    field bounding 5 state codes proves ``< 8``, not ``< 5``).  Sentinel
    words (``EMPTY``-when-free network slots) declare ``may_empty`` so the
    domain is ``[0, hi] ∪ {EMPTY}`` rather than collapsing to top.  Bounds
    are unsigned, as in JAX: ``EMPTY`` is held as 2^64 - 1, and
    :meth:`words_ival` gives the int64 bit patterns the port's kernels see
    (``EMPTY`` is -1 there) with ``signed=True``.
    """

    _EMPTY = (1 << 64) - 1

    def __init__(self, width: int):
        self.width = int(width)
        # per word: (hi, may_empty); None = top (nothing declared)
        self._words: list = [None] * self.width
        # (word, off, bits) -> hi for packed-field refinement
        self._fields: dict = {}

    def declare_word(self, word: int, hi: int,
                     may_empty: bool = False) -> "RowDomain":
        self._words[word] = (int(hi), bool(may_empty))
        return self

    def declare_field(self, word: int, off: int, bits: int,
                      hi: int) -> "RowDomain":
        """Bound bits ``[off, off+bits)`` of ``word`` to ``[0, hi]``
        (tighter than the field width when the domain doesn't fill it)."""
        self._fields[(int(word), int(off), int(bits))] = int(hi)
        return self

    @classmethod
    def from_packer(cls, packer: "BitPacker",
                    field_bounds: Optional[dict] = None,
                    width: Optional[int] = None) -> "RowDomain":
        """Word + field bounds from a :class:`BitPacker` layout; optional
        ``field_bounds`` (name -> hi) tighten individual fields below
        their width.  ``width`` over-allocates for rows with a non-packed
        tail (network slot words), which stays undeclared (top) until
        ``declare_word``."""
        dom = cls(width or packer.width)
        word_hi = [0] * packer.width
        for name, (word, off, bits) in packer.layout.items():
            hi = (1 << bits) - 1
            if field_bounds and name in field_bounds:
                hi = min(hi, int(field_bounds[name]))
            dom.declare_field(word, off, bits, hi)
            word_hi[word] |= hi << off
        for w, hi in enumerate(word_hi):
            dom.declare_word(w, hi)
        return dom

    # -- interpreter-facing --------------------------------------------------

    def field_hi(self, word: int, off: int, bits: int) -> Optional[int]:
        return self._fields.get((int(word), int(off), int(bits)))

    def words_ival(self, start: int, limit: int, signed: bool = False):
        """IVal covering words ``[start, limit)`` (a last-axis slice of the
        input rows): join of the declared word bounds, with the EMPTY
        sentinel carried as an exact outlier; single-word slices keep field
        provenance.  ``signed``: as the int64 bit patterns (a bound at or
        above 2^63 is the int64 hull, ``EMPTY`` the point -1)."""
        from dataclasses import replace

        from ..analysis.interval import IVal

        top = (IVal(-(1 << 63), (1 << 63) - 1) if signed
               else IVal(0, self._EMPTY))
        his, empty = [], False
        for w in range(start, min(limit, self.width)):
            decl = self._words[w]
            if decl is None:
                return top  # an undeclared word: top
            hi, me = decl
            his.append(hi)
            empty = empty or me
        if not his:
            return top
        hi = max(his)
        if signed and hi >= 1 << 63:
            return top
        sentinel = -1 if signed else self._EMPTY
        out = IVal(
            0, hi,
            frozenset({sentinel}) if empty and hi < self._EMPTY
            else frozenset(),
        )
        if limit - start == 1:
            out = replace(out, word=start, shift=0)
        return out


class FieldWriter:
    """Packed-field write accumulator over a :class:`BitPacker` block: the
    JAX writer's coalesced mode
    (``stateright_tpu/parallel/tensor_model.py:236-360``).  Writes collect
    per word in call order, and :meth:`done` builds each written word once
    from the base word and stacks the block once; untouched words pass
    through.  Consecutive writes to disjoint fields of one word share one
    clear of the word.  The base (often an ``expand()`` view shared by
    every action) is only read, never written.  It gives the JAX eager
    mode's block (the same masks, writes in call order) without a clone
    and an indexed write of the whole block per field.
    """

    def __init__(self, pk: "BitPacker", base):
        self.pk = pk
        self.base = base
        # word -> ops in call order; name -> pending value; and name -> the
        # flags OR-ed into it since, so get() after or_field sees the write
        self._word_ops: dict[int, list] = {}
        self._pending: dict[str, object] = {}
        self._or_pending: dict[str, list] = {}

    def set(self, name: str, value) -> "FieldWriter":
        """Write field ``name`` (int64[...] matching the block's leading
        shape, or a Python int)."""
        word, off, bits = self.pk.layout[name]
        self._word_ops.setdefault(word, []).append(("set", off, bits, value))
        self._pending[name] = value
        self._or_pending.pop(name, None)  # a set supersedes earlier ORs
        return self

    def get(self, name: str):
        """Current value of field ``name``: the pending write (or the
        base's field) with the later ORs applied."""
        v = self._pending.get(name)
        if v is None:
            v = self.pk.get(self.base, name)
        else:
            _w, _off, bits = self.pk.layout[name]
            low = to_i64((1 << bits) - 1)
            if isinstance(v, torch.Tensor):
                v = v.to(torch.int64)
                if bits < 64:
                    v = v & low
            else:
                v = torch.full(self.base.shape[:-1], to_i64(int(v)) & low,
                               dtype=torch.int64, device=self.base.device)
        for flag in self._or_pending.get(name, ()):
            v = v | flag.to(torch.int64)
        return v

    def or_field(self, name: str, flag) -> "FieldWriter":
        """OR ``flag`` (bool[...]) into the 1-bit packed field ``name``
        without reading the field back: the word keeps every other bit."""
        word, off, _bits = self.pk.layout[name]
        self._word_ops.setdefault(word, []).append(
            ("or", flag.to(torch.int64) << off))
        self._or_pending.setdefault(name, []).append(flag)
        return self

    @staticmethod
    def _build_word(col, ops):
        """Apply one word's ops in call order; a run of sets to disjoint
        fields becomes one clear and one OR of the masked values."""
        clear, vals, const = 0, None, 0

        def flush(col):
            if clear:
                col = col & to_i64(~clear)
                if const:
                    col = col | to_i64(const)
                if vals is not None:
                    col = col | vals
            return col

        for op in ops:
            if op[0] == "or":
                col = flush(col) | op[1]
                clear, vals, const = 0, None, 0
                continue
            _, off, bits, v = op
            mask = ((1 << bits) - 1) << off
            if clear & mask:  # the same field again: apply what came before
                col = flush(col)
                clear, vals, const = 0, None, 0
            clear |= mask
            if isinstance(v, torch.Tensor):
                t = v.to(torch.int64) << off
                if bits < 64:
                    t = t & to_i64(mask)
                vals = t if vals is None else vals | t
            else:
                const |= (int(v) << off) & mask
        return flush(col)

    def done(self):
        """The written block: one stack of the per-word columns."""
        cols = [self._build_word(self.base[..., w], self._word_ops[w])
                if w in self._word_ops else self.base[..., w]
                for w in range(self.pk.width)]
        shape = self.base.shape[:-1]
        cols = [c if c.shape == shape else c.expand(shape) for c in cols]
        return torch.stack(cols, dim=-1)


class BitPacker:
    """Packs named bit fields into 64-bit words; fields never straddle words.

    The host side packs/unpacks Python ints; the device side extracts and
    rebuilds fields with shifts and masks on int64 bit patterns.
    """

    def __init__(self, fields: Sequence[tuple[str, int]]):
        self.fields = list(fields)
        self.layout: dict[str, tuple[int, int, int]] = {}  # name -> (word, off, bits)
        word, off = 0, 0
        for name, bits in self.fields:
            if not 1 <= bits <= 64:
                raise ValueError(f"field {name!r}: bits must be in 1..64")
            if off + bits > 64:
                word, off = word + 1, 0
            self.layout[name] = (word, off, bits)
            off += bits
        self.width = word + 1

    # -- host ----------------------------------------------------------------

    def pack(self, **values: int) -> tuple:
        words = [0] * self.width
        for name, (word, off, bits) in self.layout.items():
            v = values.pop(name, 0)
            if not 0 <= v < (1 << bits):
                raise ValueError(f"field {name!r}={v} out of range ({bits} bits)")
            words[word] |= v << off
        if values:
            raise ValueError(f"unknown fields: {sorted(values)}")
        return tuple(words)

    def unpack(self, row) -> dict[str, int]:
        return {
            name: ((int(row[word]) & ((1 << 64) - 1)) >> off) & ((1 << bits) - 1)
            for name, (word, off, bits) in self.layout.items()
        }

    # -- device --------------------------------------------------------------

    def get(self, rows, name: str):
        """Extract field ``name``: ``int64[..., W] -> int64[...]``."""
        word, off, bits = self.layout[name]
        v = lshr(rows[..., word], off)
        if bits < 64:
            v = v & to_i64((1 << bits) - 1)
        return v

    def set(self, rows, name: str, value):
        """Return rows with field ``name`` replaced by ``value``."""
        word, off, bits = self.layout[name]
        mask = ((1 << bits) - 1) << off
        cleared = rows[..., word] & to_i64(~mask)
        if isinstance(value, torch.Tensor):
            v = (value.to(torch.int64) << off) & to_i64(mask)
        else:  # a constant stays a Python scalar: no host-to-device copy
            v = to_i64((int(value) << off) & mask)
        out = rows.clone()
        out[..., word] = cleared | v
        return out
