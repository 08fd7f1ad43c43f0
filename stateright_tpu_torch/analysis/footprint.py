"""Per-action read/write footprints of a tensor twin, at bit granularity.

The port's copy of ``stateright_tpu/analysis/footprint.py``, on an aten
graph captured with ``make_fx`` (``analysis/graph.py``) instead of a
jaxpr.  The independence pass (``independence.py``) needs to know, for
every action family of a twin, which packed row bits the action READS (to
compute its successor), which bits its enabledness GUARD reads, and which
bits it WRITES.  Everything else in the row is a pure copy, and pure
copies are what makes two actions commute.  The abstract domain is the
JAX one:

 - every value carries ``deps``, a :class:`FieldSet` (per-word bit masks
   over the input row) of the input bits its VALUE may depend on, beyond
   any identity copy;
 - values derived from a single input word also carry an identity channel
   ``(word, shift, eq, supp)``: the value equals ``input_word >> shift`` on
   the ``eq`` bits, and only the ``supp`` bits can be non-zero.
   ``BitPacker.get``'s extraction (``lshr(rows[..., w], off) & mask``) and
   the ``FieldWriter`` word build (``(w & ~m) | (v & m)``) stay exact
   through this channel;
 - tensors whose LAST axis is the row-word axis are tracked per lane, so a
   word picked with ``select``, or written back with ``select_scatter`` or
   assembled with a last-axis ``stack``, keeps one lane each.

One rule per aten operation stands in for JAX's one rule per primitive.
The port's own idioms: int64 holds the rows, so ``lshr`` is an arithmetic
``>>`` whose sign copies a mask drops (the rule reads the node's users);
``torch.stack`` assembles both the words of a row (last axis) and the
actions (the axis before); a table lookup is ``index.Tensor``.

Per-action decomposition rides the model idiom: ``step_rows`` assembles
``succ`` by stacking per-action row arrays along the action axis (an
``aten.stack`` or ``aten.cat``) and ``valid`` by stacking per-action guard
columns.  Kernels that assemble successors any other way do NOT decompose:
the extraction then reports every action with a ``TOP`` footprint, which
``independence.py`` treats as dependent on everything (``JX302``).
Undecidable can cost reduction, never soundness.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional

import numpy as np
import torch

from .graph import (
    TRANSPARENT, Graph, dtype_of, fill_value, graph_of, is_literal, op_name,
    shape_of,
)
from .report import AuditFinding, Severity

ALL64 = (1 << 64) - 1


# ---------------------------------------------------------------------------
# field sets: per-word bitmasks over the input row
# ---------------------------------------------------------------------------


class FieldSet:
    """A set of input-row bits: ``{word -> bitmask}``, or TOP (unknown)."""

    __slots__ = ("masks", "top")

    def __init__(self, masks: Optional[dict] = None, top: bool = False):
        self.top = bool(top)
        self.masks: dict = {} if top or not masks else {
            w: m & ALL64 for w, m in masks.items() if m
        }

    @classmethod
    def empty(cls) -> "FieldSet":
        return cls()

    @classmethod
    def of(cls, word: int, mask: int = ALL64) -> "FieldSet":
        return cls({int(word): int(mask)})

    @classmethod
    def top_set(cls) -> "FieldSet":
        return cls(top=True)

    @property
    def is_empty(self) -> bool:
        return not self.top and not self.masks

    def union(self, other: "FieldSet") -> "FieldSet":
        if self.top or other.top:
            return FieldSet.top_set()
        out = dict(self.masks)
        for w, m in other.masks.items():
            out[w] = out.get(w, 0) | m
        return FieldSet(out)

    def minus_word_bits(self, word: int, mask: int) -> "FieldSet":
        """Remove ``mask`` bits of ``word`` (TOP stays TOP)."""
        if self.top:
            return self
        out = dict(self.masks)
        if word in out:
            out[word] &= ~mask
        return FieldSet(out)

    def intersects(self, other: "FieldSet") -> bool:
        """Conservative may-intersect: TOP intersects anything non-empty
        (and another TOP)."""
        if self.top:
            return other.top or bool(other.masks)
        if other.top:
            return bool(self.masks)
        return any(
            self.masks.get(w, 0) & m for w, m in other.masks.items()
        )

    def to_json(self) -> object:
        if self.top:
            return "top"
        return {str(w): hex(m) for w, m in sorted(self.masks.items())}

    def __repr__(self) -> str:
        return f"FieldSet({self.to_json()})"


def union_all(sets) -> FieldSet:
    out = FieldSet.empty()
    for s in sets:
        out = out.union(s)
    return out


# ---------------------------------------------------------------------------
# abstract values
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Info:
    """Abstract value of one scalar/lane (JAX ``Info``).

    ``deps`` — non-identity input-bit dependencies of the value.
    ``word``/``shift`` — identity provenance: the value is derived from
    ``input[word] >> shift`` (None = no single-word provenance).
    ``eq`` — value-position bits where the value EQUALS
    ``input[word] >> shift`` (meaningful only with provenance).
    ``supp`` — value-position bits that can be non-zero (None = all).
    ``const`` — exact value when statically known (scalar constants).
    ``acc`` — value-position bits where the value is an OR-ACCUMULATE of
    the identity content, ``(input[word] >> shift) | f(deps)``: written
    back to its own word such a bit is a *monotone* write, and two
    actions' accumulates commute (the compiled twins' saturating poison
    flag).
    """

    deps: FieldSet = field(default_factory=FieldSet.empty)
    word: Optional[int] = None
    shift: int = 0
    eq: int = 0
    supp: Optional[int] = None
    const: Optional[int] = None
    acc: int = 0

    def as_data(self) -> FieldSet:
        """Full read set when the value is consumed AS DATA (identity
        content included): the identity channel's input bits fold in."""
        out = self.deps
        if self.word is not None:
            s = ALL64 if self.supp is None else self.supp
            out = out.union(FieldSet.of(self.word, (s << self.shift) & ALL64))
        return out


TOP_INFO = Info(deps=FieldSet.top_set())


def _join(a: Info, b: Info) -> Info:
    """Join two infos (select/concat): identity survives only where both
    sides carry it, on the intersection of their eq bits; a bit stays an
    OR-accumulate when BOTH branches keep it ``old | something``."""
    deps = a.deps.union(b.deps)
    if (a.word is not None and a.word == b.word and a.shift == b.shift):
        supp = None if (a.supp is None or b.supp is None) else (
            a.supp | b.supp
        )
        eq = a.eq & b.eq
        safe = (a.eq | a.acc) & (b.eq | b.acc)
        return Info(deps=deps, word=a.word, shift=a.shift,
                    eq=eq, supp=supp, acc=safe & ~eq)
    return Info(deps=a.as_data().union(b.as_data()))


def _const_info(v) -> Info:
    arr = np.asarray(v)
    supp = 0
    const = None
    if arr.dtype == np.bool_:
        supp = int(bool(arr.any()))
        if arr.size == 1:
            const = int(bool(arr.reshape(-1)[0]))
    elif np.issubdtype(arr.dtype, np.integer):
        flat = arr.reshape(-1).astype(np.int64).view(np.uint64)
        if flat.size == 0:
            supp = 0
        else:
            # the FULL array: an under-approximated support would let
            # conflicting actions classify independent
            supp = int(np.bitwise_or.reduce(flat)) & ALL64
        if arr.size == 1:
            const = int(flat[0]) & ALL64
    else:
        return Info(supp=None)
    return Info(supp=supp, const=const)


@dataclass(frozen=True)
class AVal:
    """Abstract value of one tensor: either one collapsed :class:`Info`, or
    per-lane infos along the LAST axis (``lanes``)."""

    info: Optional[Info] = None
    lanes: Optional[tuple] = None

    @property
    def tracked(self) -> bool:
        return self.lanes is not None

    def collapse(self) -> Info:
        if self.lanes is None:
            return self.info if self.info is not None else TOP_INFO
        if not self.lanes:
            return TOP_INFO
        out = self.lanes[0]
        for i in self.lanes[1:]:
            out = _join(out, i)
        return out

    def one(self) -> Info:
        return self.info if self.info is not None else self.collapse()


def _scalar(info: Info) -> AVal:
    return AVal(info=info)


TOP_AVAL = AVal(info=TOP_INFO)


# ---------------------------------------------------------------------------
# footprints
# ---------------------------------------------------------------------------


@dataclass
class ActionFootprint:
    """Static footprint of one action family (action slot)."""

    reads: FieldSet  # successor-value reads (pure copies excluded)
    writes: FieldSet  # row bits the successor may change
    guard: FieldSet  # enabledness-condition reads
    decided: bool  # False when any component collapsed to TOP
    # monotone OR-accumulate writes (``new = old | f(reads)``)
    accum: FieldSet = field(default_factory=FieldSet.empty)

    def to_json(self) -> dict:
        return {
            "reads": self.reads.to_json(),
            "writes": self.writes.to_json(),
            "guard": self.guard.to_json(),
            "accum": self.accum.to_json(),
            "decided": self.decided,
        }


@dataclass
class ConjunctInfo:
    """Per-action guard CONJUNCT decomposition (JAX ``ConjunctInfo``): a
    false conjunct's writer set is a sound *necessary enabling set*.

    ``sets[a]`` — one FieldSet per conjunct of action ``a`` (≥ 1; the
    fallback is the whole guard as a single conjunct).
    ``leaf_idx[a]`` — ``(leaf, lane)`` references of ``a``'s conjuncts into
    the conjunct kernel's leaf outputs (``lane`` None for a ``[B]`` leaf,
    else the action's lane within a ``[B, cap]`` guard block), or None: the
    single-conjunct fallback, whose truth is the action's enabled bit.
    ``n_leaves`` — total distinct evaluable conjunct leaves.
    """

    sets: list
    leaf_idx: list
    n_leaves: int

    @property
    def max_conjuncts(self) -> int:
        return max((len(s) for s in self.sets), default=1)


@dataclass
class ModelFootprints:
    """Footprints of every action plus per-property read sets."""

    width: int
    n_actions: int
    actions: list  # list[ActionFootprint]
    prop_reads: list  # list[FieldSet], properties() order
    decomposed: bool  # per-action successor decomposition succeeded
    findings: list = field(default_factory=list)
    conjuncts: Optional[ConjunctInfo] = None

    @property
    def undecided_actions(self) -> list:
        return [i for i, a in enumerate(self.actions) if not a.decided]


# ---------------------------------------------------------------------------
# the interpreter
# ---------------------------------------------------------------------------


def _norm_dim(d, ndim: int) -> int:
    d = int(d)
    return d + ndim if d < 0 else d


class _FpInterp:
    """One forward pass over a captured graph with the footprint domain
    (JAX ``_FpInterp``), conservative TOP for anything unknown."""

    def __init__(self, graph: Graph):
        self.g = graph
        self.env: dict = {}

    # -- env -----------------------------------------------------------------

    def read(self, x):
        """A node's value, or a literal argument's (JAX ``read`` of a
        ``Literal``): an int as its 64-bit pattern, a bool as a bool."""
        if isinstance(x, torch.fx.Node):
            v = self.env.get(x)
            return v if v is not None else TOP_AVAL
        if isinstance(x, bool):
            return _scalar(_const_info(np.asarray(x)))
        if isinstance(x, int):
            return _scalar(_const_info(np.asarray(x & ALL64, np.uint64)))
        if isinstance(x, float):
            return _scalar(Info(supp=None))
        return TOP_AVAL

    # -- entry ---------------------------------------------------------------

    def run(self, rows_lanes: int) -> list:
        g = self.g
        if g.inputs:
            self.env[g.inputs[0]] = AVal(lanes=tuple(
                Info(word=w, shift=0, eq=ALL64, supp=None)
                for w in range(rows_lanes)
            ))
        for n in g.inputs[1:]:
            self.env[n] = TOP_AVAL
        for n in g.nodes:
            if n.op in ("placeholder", "output"):
                continue
            try:
                self.env[n] = self.node(n)
            except Exception:  # noqa: BLE001 - a rule bug degrades to TOP,
                self.env[n] = TOP_AVAL  # never to a wrong footprint
        return [self.read(o) for o in g.outputs]

    # -- per-node transfer ---------------------------------------------------

    def node(self, n):
        if n.op == "get_attr":
            return _scalar(_const_info(self.g.const_value(n)))
        name = op_name(n)
        fill = fill_value(n)
        if fill is not None:
            return _rule_fill(n, fill)
        rule = _FP_RULES.get(name)
        if rule is not None:
            return rule(self, n)
        # unknown operation: every output depends on every input (as data),
        # lanes lost
        deps = union_all(self.read(a).collapse().as_data()
                         for a in _tensor_args(n))
        out = _scalar(Info(deps=deps))
        val = n.meta.get("val")
        if isinstance(val, (tuple, list)):
            return [out] * len(val)
        return out


def _tensor_args(n) -> list:
    out = []
    for a in list(n.args) + list(n.kwargs.values()):
        if isinstance(a, torch.fx.Node):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(x for x in a if isinstance(x, torch.fx.Node))
    return out


def _ndim(x) -> int:
    return len(shape_of(x))


def _last(x) -> int:
    s = shape_of(x)
    return int(s[-1]) if s else 1


# -- rules -------------------------------------------------------------------


def _lanewise(fn):
    """Lift a binary Info rule over (AVal, AVal) with last-axis broadcast:
    lanes x lanes (equal length), lanes x scalar (or one lane), scalar x
    scalar."""

    def rule(a: AVal, b: AVal) -> AVal:
        if a.tracked and b.tracked and len(a.lanes) == len(b.lanes):
            return AVal(lanes=tuple(
                fn(x, y) for x, y in zip(a.lanes, b.lanes)
            ))
        if a.tracked and (not b.tracked or len(b.lanes) == 1):
            bi = b.one()
            return AVal(lanes=tuple(fn(x, bi) for x in a.lanes))
        if b.tracked and (not a.tracked or len(a.lanes) == 1):
            ai = a.one()
            return AVal(lanes=tuple(fn(ai, y) for y in b.lanes))
        return _scalar(fn(a.one(), b.one()))

    return rule


def _data_combine(a: Info, b: Info) -> Info:
    return Info(deps=a.as_data().union(b.as_data()))


def _rule_and_info(a: Info, b: Info) -> Info:
    if a.const is not None and b.const is not None:
        v = a.const & b.const
        return Info(supp=v, const=v)
    for x, c in ((a, b.const), (b, a.const)):
        if c is None:
            continue
        supp = (ALL64 if x.supp is None else x.supp) & c
        if x.word is not None:
            # AND-with-const zeroes bits outside c: an accumulate bit
            # masked off is a plain write again
            return replace(x, eq=x.eq & c, acc=x.acc & c, supp=supp,
                           const=None)
        return Info(deps=x.deps, supp=supp)
    out = _data_combine(a, b)
    if a.supp is not None or b.supp is not None:
        # an AND keeps only bits both operands can carry
        sa = ALL64 if a.supp is None else a.supp
        sb = ALL64 if b.supp is None else b.supp
        out = replace(out, supp=sa & sb)
    return out


def _rule_or_info(a: Info, b: Info) -> Info:
    if a.const is not None and b.const is not None:
        v = a.const | b.const
        return Info(supp=v, const=v)
    for x, y in ((a, b), (b, a)):
        if x.word is not None and y.word is None and y.supp is not None:
            # value | bounded-support operand: only the operand's support
            # bits stop equalling the input word, and become ``old | f``
            eq = x.eq & ~y.supp
            return Info(
                deps=x.deps.union(y.deps),
                word=x.word, shift=x.shift,
                eq=eq,
                supp=None if x.supp is None else (x.supp | y.supp),
                acc=x.acc | (x.eq & y.supp),
            )
    if (a.word is not None and a.word == b.word and a.shift == b.shift):
        sa = ALL64 if a.supp is None else a.supp
        sb = ALL64 if b.supp is None else b.supp
        eq = (a.eq & ~sb) | (b.eq & ~sa) | (a.eq & b.eq)
        # identity bits landing in non-eq output positions become reads
        leak = ((a.eq | b.eq) & ~eq) << a.shift
        deps = a.deps.union(b.deps)
        if leak:
            deps = deps.union(FieldSet.of(a.word, leak & ALL64))
        return Info(deps=deps, word=a.word, shift=a.shift, eq=eq,
                    supp=sa | sb)
    out = _data_combine(a, b)
    if a.supp is not None and b.supp is not None:
        out = replace(out, supp=a.supp | b.supp)
    return out


def _rule_xor_info(a: Info, b: Info) -> Info:
    if a.const is not None and b.const is not None:
        v = a.const ^ b.const
        return Info(supp=v, const=v)
    for x, y in ((a, b), (b, a)):
        if x.word is not None and y.word is None and y.supp is not None:
            # value ^ bounded-support operand: only the support bits flip
            return Info(
                deps=x.deps.union(y.deps),
                word=x.word, shift=x.shift,
                eq=x.eq & ~y.supp,
                supp=None if x.supp is None else (x.supp | y.supp),
                acc=x.acc & ~y.supp,
            )
    out = _data_combine(a, b)
    if a.supp is not None and b.supp is not None:
        out = replace(out, supp=a.supp | b.supp)
    return out


def _shift_info(a: Info, b: Info, left: bool, arith: bool = False) -> Info:
    k = b.const
    if k is None or a.deps.top:
        return _data_combine(a, b)
    k = int(k)
    if k >= 64:
        return Info(deps=a.as_data(), supp=None)
    supp = ALL64 if a.supp is None else a.supp
    if a.word is None:
        nsupp = ((supp << k) if left else (supp >> k)) & ALL64
        const = None if a.const is None else (
            ((a.const << k) if left else (a.const >> k)) & ALL64)
        if arith and not left and supp >> 63:
            # the sign copies: the top k bits may be set
            nsupp |= (ALL64 << (64 - k)) & ALL64 if k else 0
            const = None if a.const is None or not a.const >> 63 else (
                (const | (ALL64 << (64 - k))) & ALL64 if k else const)
        return Info(deps=a.deps, supp=nsupp, const=const)
    if left:
        if k <= a.shift:
            return Info(deps=a.deps, word=a.word, shift=a.shift - k,
                        eq=(a.eq << k) & ALL64, supp=(supp << k) & ALL64,
                        acc=(a.acc << k) & ALL64)
        # over-shift past the origin: identity content moves to higher
        # input positions than it came from; fold to data
        return Info(deps=a.as_data(), supp=(supp << k) & ALL64)
    out = Info(deps=a.deps, word=a.word, shift=a.shift + k,
               eq=a.eq >> k, supp=supp >> k, acc=a.acc >> k)
    if arith and k and supp >> 63:
        # an int64 ``>>`` copies the value's top bit into the top k bits:
        # they are reads of that bit, not identity
        sign = FieldSet.of(a.word, 1 << 63) if a.shift == 0 else (
            FieldSet.empty())
        out = replace(out, supp=out.supp | ((ALL64 << (64 - k)) & ALL64),
                      deps=out.deps.union(sign))
    return out


def _rule_cmp_info(a: Info, b: Info) -> Info:
    return Info(deps=a.as_data().union(b.as_data()), supp=1)


def _rule_not_info(a: Info) -> Info:
    if a.const is not None:
        return Info(supp=(~a.const) & ALL64, const=(~a.const) & ALL64)
    return Info(deps=a.as_data())


_BINARY = {
    "bitwise_and": _rule_and_info, "logical_and": _rule_and_info,
    "bitwise_or": _rule_or_info, "logical_or": _rule_or_info,
    "bitwise_xor": _rule_xor_info, "logical_xor": _rule_xor_info,
    "add": _data_combine, "sub": _data_combine, "rsub": _data_combine,
    "mul": _data_combine, "div": _data_combine,
    "floor_divide": _data_combine, "remainder": _data_combine,
    "fmod": _data_combine, "maximum": _data_combine,
    "minimum": _data_combine, "clamp_min": _data_combine,
    "clamp_max": _data_combine,
    "eq": _rule_cmp_info, "ne": _rule_cmp_info, "lt": _rule_cmp_info,
    "le": _rule_cmp_info, "gt": _rule_cmp_info, "ge": _rule_cmp_info,
}


def _is_lshr(n) -> bool:
    """``lshr``'s shape (``ops/hashing.py``): an int64 ``>> k`` whose every
    user masks it to its low ``64 - k`` bits, so the sign copies vanish and
    the shift is logical."""
    k = n.args[1] if len(n.args) > 1 else None
    if not isinstance(k, int) or not n.users:
        return False
    for u in n.users:
        if op_name(u) != "bitwise_and":
            return False
        m = u.args[1] if u.args[0] is n else u.args[0]
        if not isinstance(m, int) or m < 0 or m >> (64 - k):
            return False
    return True


def _rule_binop(itp: _FpInterp, n):
    name = op_name(n)
    a, b = itp.read(n.args[0]), itp.read(n.args[1])
    if name in ("__lshift__", "bitwise_left_shift", "__rshift__",
                "bitwise_right_shift"):
        left = name in ("__lshift__", "bitwise_left_shift")
        arith = (not left and dtype_of(n) != torch.bool
                 and not _is_lshr(n))

        def fn(x, y):
            return _shift_info(x, y, left, arith)
    else:
        fn = _BINARY[name]
    return _lanewise(fn)(a, b)


def _rule_not(itp, n):
    a = itp.read(n.args[0])
    if a.tracked:
        return AVal(lanes=tuple(_rule_not_info(i) for i in a.lanes))
    return _scalar(_rule_not_info(a.one()))


def _rule_unary_data(itp, n):
    a = itp.read(n.args[0])
    if a.tracked:
        return AVal(lanes=tuple(Info(deps=i.as_data()) for i in a.lanes))
    return _scalar(Info(deps=a.one().as_data()))


def _rule_clamp(itp, n):
    out = itp.read(n.args[0])
    for x in n.args[1:]:
        if x is not None:
            out = _lanewise(_data_combine)(out, itp.read(x))
    return out


def _select_cases(pred: AVal, cases: list) -> AVal:
    out = cases[0]
    for c in cases[1:]:
        out = _lanewise(_join)(out, c)
    pdeps = pred.collapse().as_data()
    if pdeps.is_empty:
        return out
    if out.tracked:
        return AVal(lanes=tuple(
            replace(i, deps=i.deps.union(pdeps)) for i in out.lanes
        ))
    i = out.one()
    return _scalar(replace(i, deps=i.deps.union(pdeps)))


def _rule_where(itp, n):
    pred = itp.read(n.args[0])
    return _select_cases(pred, [itp.read(n.args[2]), itp.read(n.args[1])])


def _rule_select(itp, n):
    """``x[..., i]`` on the last axis picks lane ``i``; on another axis the
    lanes survive."""
    a = itp.read(n.args[0])
    x = n.args[0]
    nd = _ndim(x)
    dim = _norm_dim(n.args[1], nd)
    idx = int(n.args[2])
    if dim == nd - 1:
        if a.tracked and len(a.lanes) == _last(x):
            return _scalar(a.lanes[idx % len(a.lanes)])
        return _scalar(a.collapse()) if a.tracked else a
    if a.tracked and _last(n) == len(a.lanes):
        return a
    return _scalar(a.collapse()) if a.tracked else a


def _rule_slice(itp, n):
    a = itp.read(n.args[0])
    x = n.args[0]
    nd = _ndim(x)
    dim = _norm_dim(n.args[1] if len(n.args) > 1 else 0, nd)
    if dim == nd - 1:
        if a.tracked and len(a.lanes) == _last(x):
            lo = n.args[2] if len(n.args) > 2 and n.args[2] is not None else 0
            hi = n.args[3] if len(n.args) > 3 and n.args[3] is not None \
                else len(a.lanes)
            st = n.args[4] if len(n.args) > 4 else 1
            lanes = a.lanes[slice(int(lo), min(int(hi), len(a.lanes)),
                                  int(st))]
            if len(lanes) == _last(n):
                return AVal(lanes=lanes)
        return _scalar(a.collapse()) if a.tracked else a
    if a.tracked and _last(n) == len(a.lanes):
        return a
    return _scalar(a.collapse()) if a.tracked else a


def _rule_keep_last(itp, n):
    """Shape operations that keep the last axis when its size survives
    (JAX ``_rule_reshape``/``_rule_squeeze``): a tracked value keeps its
    lanes, else collapses; an untracked value passes through."""
    a = itp.read(n.args[0])
    if a.tracked:
        if _last(n) == len(a.lanes) and _ndim(n) >= 1:
            in_shape, out_shape = shape_of(n.args[0]), shape_of(n)
            if in_shape and in_shape[-1] == out_shape[-1]:
                return a
        if len(a.lanes) == 1 and _ndim(n) == _ndim(n.args[0]) - 1:
            return _scalar(a.lanes[0])  # the one-lane axis squeezed away
        return _scalar(a.collapse())
    return a


def _rule_unsqueeze(itp, n):
    a = itp.read(n.args[0])
    nd = _ndim(n)
    dim = _norm_dim(n.args[1], nd)
    if dim < nd - 1:
        return a  # the last axis survives
    if a.tracked:
        return a if len(a.lanes) == 1 else _scalar(a.collapse())
    return a


def _rule_expand(itp, n):
    """JAX ``_rule_broadcast``: a tracked value keeps its lanes where the
    last axis keeps its size; an untracked one becomes that many copies."""
    a = itp.read(n.args[0])
    n_out = _last(n)
    if a.tracked:
        if len(a.lanes) == n_out and shape_of(n.args[0])[-1:] == (n_out,):
            return a
        return _scalar(a.collapse())
    return AVal(lanes=tuple([a.one()] * n_out)) if _ndim(n) >= 1 else a


def _rule_permute(itp, n):
    a = itp.read(n.args[0])
    nd = _ndim(n.args[0])
    if op_name(n) == "permute":
        perm = [_norm_dim(d, nd) for d in n.args[1]]
        keeps = perm and perm[-1] == nd - 1
    else:  # transpose(x, d0, d1)
        d0, d1 = (_norm_dim(d, nd) for d in n.args[1:3])
        keeps = nd - 1 not in (d0, d1) or d0 == d1
    if a.tracked and keeps:
        return a
    return _scalar(a.collapse()) if a.tracked else a


def _rule_convert(itp, n):
    return itp.read(n.args[0])


def _rule_copy(itp, n):
    """``copy(dst, src)``: ``src``'s value in ``dst``'s shape (the value a
    functionalized ``dst[...] = src`` writes)."""
    src = n.args[1]
    a = itp.read(src)
    if shape_of(src) == shape_of(n) or not _ndim(n):
        return a
    n_out = _last(n)
    if a.tracked:
        return a if len(a.lanes) == n_out else _scalar(a.collapse())
    return AVal(lanes=tuple([a.one()] * n_out))


def _rule_cat(itp, n):
    xs = list(n.args[0])
    nd = _ndim(n)
    dim = _norm_dim(n.args[1] if len(n.args) > 1 else 0, nd)
    ins = [itp.read(x) for x in xs]
    if dim == nd - 1:
        lanes = []
        for v, x in zip(ins, xs):
            k = _last(x) if _ndim(x) else 0
            if v.tracked and len(v.lanes) == k:
                lanes.extend(v.lanes)
            else:
                lanes.extend([v.collapse()] * k)
        return AVal(lanes=tuple(lanes))
    # a cat along another axis (the action stack): a sound per-lane join;
    # the per-action decomposition walks back through it separately
    out = ins[0]
    for v in ins[1:]:
        out = _lanewise(_join)(out, v)
    return out


def _rule_stack(itp, n):
    xs = list(n.args[0])
    nd = _ndim(n)
    dim = _norm_dim(n.args[1] if len(n.args) > 1 else 0, nd)
    ins = [itp.read(x) for x in xs]
    if dim == nd - 1:
        return AVal(lanes=tuple(v.collapse() for v in ins))
    out = ins[0]
    for v in ins[1:]:
        out = _lanewise(_join)(out, v)
    return out


def _gather_info(operand: Info, idx: Info) -> AVal:
    """JAX ``_rule_gather``: a table lookup's support is bounded by the
    table's; an all-zero table yields a constant zero with no reads."""
    if operand.supp == 0 and operand.deps.is_empty:
        return _scalar(Info(supp=0, const=0))
    return _scalar(Info(deps=operand.as_data().union(idx.as_data()),
                        supp=operand.supp))


def _lane_pick(a: AVal, x, idx_vals, out) -> Optional[AVal]:
    """Constant indices on the last axis of a tracked value: the picked
    lanes themselves, when they are the output's last axis."""
    if not a.tracked or len(a.lanes) != _last(x) or idx_vals is None:
        return None
    flat = np.asarray(idx_vals).reshape(-1)
    if flat.size != _last(out) or _ndim(out) < 1:
        return None
    return AVal(lanes=tuple(a.lanes[int(i) % len(a.lanes)] for i in flat))


def _rule_index(itp, n):
    """``x[idx...]`` (``index.Tensor``): constant indices on the last axis
    alone stay lane-exact; anything else is a lookup."""
    x, indices = n.args[0], list(n.args[1])
    a = itp.read(x)
    nd = _ndim(x)
    live = [(d, i) for d, i in enumerate(indices) if i is not None]
    if len(live) == 1 and live[0][0] == nd - 1:
        got = _lane_pick(a, x, itp.g.const_value(live[0][1]), n)
        if got is not None:
            return got
    idx = union_all(itp.read(i).collapse().as_data() for _, i in live)
    return _gather_info(a.collapse(), Info(deps=idx))


def _rule_index_select(itp, n):
    x, dim, i = n.args[0], n.args[1], n.args[2]
    a = itp.read(x)
    if _norm_dim(dim, _ndim(x)) == _ndim(x) - 1:
        got = _lane_pick(a, x, itp.g.const_value(i), n)
        if got is not None:
            return got
    return _gather_info(a.collapse(), itp.read(i).collapse())


def _rule_gather(itp, n):
    a, i = itp.read(n.args[0]), itp.read(n.args[2])
    return _gather_info(a.collapse(), i.collapse())


def _scatter_unknown(operand: AVal, upd: FieldSet) -> AVal:
    if operand.tracked:
        return AVal(lanes=tuple(
            Info(deps=i.as_data().union(upd)) for i in operand.lanes
        ))
    return _scalar(Info(deps=operand.collapse().as_data().union(upd)))


def _rule_select_scatter(itp, n):
    """The word write-back ``rows[..., w] = v``: a constant lane replaced,
    exactly; any other target axis may have overwritten every lane."""
    base, src = itp.read(n.args[0]), itp.read(n.args[1])
    nd = _ndim(n.args[0])
    dim = _norm_dim(n.args[2], nd)
    idx = int(n.args[3])
    if base.tracked and dim == nd - 1 and -len(base.lanes) <= idx < len(
            base.lanes):
        lanes = list(base.lanes)
        lanes[idx] = src.collapse()
        return AVal(lanes=tuple(lanes))
    if base.tracked and dim < nd - 1 and src.tracked \
            and len(src.lanes) == len(base.lanes):
        return _lanewise(_join)(base, src)
    return _scatter_unknown(base, src.collapse().as_data())


def _rule_slice_scatter(itp, n):
    base, src = itp.read(n.args[0]), itp.read(n.args[1])
    nd = _ndim(n.args[0])
    dim = _norm_dim(n.args[2] if len(n.args) > 2 else 0, nd)
    if base.tracked and dim == nd - 1:
        lo = n.args[3] if len(n.args) > 3 and n.args[3] is not None else 0
        hi = n.args[4] if len(n.args) > 4 and n.args[4] is not None \
            else len(base.lanes)
        st = n.args[5] if len(n.args) > 5 else 1
        pos = list(range(len(base.lanes)))[slice(int(lo), min(
            int(hi), len(base.lanes)), int(st))]
        lanes = list(base.lanes)
        for j, p in enumerate(pos):
            lanes[p] = (src.lanes[j] if src.tracked and len(src.lanes)
                        == len(pos) else src.collapse())
        return AVal(lanes=tuple(lanes))
    return _scatter_unknown(base, src.collapse().as_data())


def _rule_scatter(itp, n):
    base = itp.read(n.args[0])
    upd = union_all(itp.read(a).collapse().as_data()
                    for a in _tensor_args(n)[1:])
    return _scatter_unknown(base, upd)


def _rule_reduce(itp, n):
    out = _scalar(Info(deps=itp.read(n.args[0]).collapse().as_data()))
    val = n.meta.get("val")
    if isinstance(val, (tuple, list)):
        return [out] * len(val)
    return out


def _rule_iota(itp, n):
    return _scalar(Info(supp=None))


def _rule_eye(itp, n):
    return _scalar(Info(supp=1))


def _rule_fill(n, fill) -> AVal:
    if isinstance(fill, float) and not float(fill).is_integer():
        info = Info(supp=None)
    elif dtype_of(n) == torch.bool:
        info = _const_info(np.asarray(bool(fill)))
    else:
        info = _const_info(np.asarray(int(fill) & ALL64, np.uint64))
    if _ndim(n) >= 1:
        return AVal(lanes=tuple([info] * _last(n)))
    return _scalar(info)


def _rule_getitem(itp, n):
    src = itp.env.get(n.args[0])
    if isinstance(src, list):
        return src[int(n.args[1])]
    return TOP_AVAL


_FP_RULES = {name: _rule_binop for name in _BINARY}
_FP_RULES.update({
    "__lshift__": _rule_binop, "__rshift__": _rule_binop,
    "bitwise_left_shift": _rule_binop, "bitwise_right_shift": _rule_binop,
    "bitwise_not": _rule_not, "logical_not": _rule_not,
    "neg": _rule_unary_data, "abs": _rule_unary_data,
    "clamp": _rule_clamp,
    "where": _rule_where,
    "select": _rule_select,
    "slice": _rule_slice,
    "squeeze": _rule_keep_last,
    "view": _rule_keep_last, "reshape": _rule_keep_last,
    "_unsafe_view": _rule_keep_last,
    "unsqueeze": _rule_unsqueeze,
    "expand": _rule_expand,
    "permute": _rule_permute, "transpose": _rule_permute,
    "_to_copy": _rule_convert, "clone": _rule_convert,
    "alias": _rule_convert, "detach": _rule_convert,
    "lift_fresh_copy": _rule_convert, "contiguous": _rule_convert,
    "to": _rule_convert, "copy": _rule_copy,
    "cat": _rule_cat,
    "stack": _rule_stack,
    "index": _rule_index,
    "index_select": _rule_index_select,
    "gather": _rule_gather, "take_along_dim": _rule_gather,
    "select_scatter": _rule_select_scatter,
    "slice_scatter": _rule_slice_scatter,
    "index_put": _rule_scatter, "scatter": _rule_scatter,
    "scatter_add": _rule_scatter, "index_add": _rule_scatter,
    "any": _rule_reduce, "all": _rule_reduce, "sum": _rule_reduce,
    "amax": _rule_reduce, "amin": _rule_reduce, "max": _rule_reduce,
    "min": _rule_reduce, "argmax": _rule_reduce, "argmin": _rule_reduce,
    "cumsum": _rule_reduce, "prod": _rule_reduce, "sort": _rule_reduce,
    "topk": _rule_reduce, "argsort": _rule_reduce,
    "arange": _rule_iota,
    "eye": _rule_eye,
    "getitem": _rule_getitem,
})


# ---------------------------------------------------------------------------
# per-action decomposition + the driver
# ---------------------------------------------------------------------------

# what the stack walk looks through (JAX: reshape, copy,
# convert_element_type)
_STACK_THROUGH = frozenset({"view", "reshape", "_unsafe_view", "clone",
                            "_to_copy", "alias", "contiguous"})


def _stack_pieces(x, axis: int, depth: int = 6) -> Optional[list]:
    """Flatten nested ``stack``/``cat`` nodes along ``axis`` (of the
    output) into per-slot pieces (JAX ``_flatten_stack``): a piece of
    axis-size k that is not itself a stack or cat gives k copies of itself;
    a stack's piece is one slot (the stack adds the axis).  None when
    ``x`` is neither."""
    for _ in range(8):
        if is_literal(x) or op_name(x) not in _STACK_THROUGH:
            break
        x = x.args[0]
    if is_literal(x):
        return None
    name = op_name(x)
    nd = _ndim(x)
    if name not in ("stack", "cat"):
        return None
    dim = _norm_dim(x.args[1] if len(x.args) > 1 else 0, nd)
    if dim != axis:
        return None
    out = []
    for piece in x.args[0]:
        if name == "stack":
            out.append(piece)
            continue
        sh = shape_of(piece)
        k = sh[axis] if axis < len(sh) else 1
        sub = _stack_pieces(piece, axis, depth - 1) if depth > 0 else None
        if sub is not None:
            out.extend(sub)
        else:
            out.extend([piece] * int(k))
    return out


def _walk(x, depth: int = 8):
    """Walk transparent shape-only operations back (JAX ``_walk_tl``)."""
    for _ in range(depth):
        if is_literal(x) or op_name(x) not in TRANSPARENT:
            return x
        x = x.args[0]
    return x


def _action_footprint_from_lanes(lanes, guard: FieldSet) -> ActionFootprint:
    """Writes/reads of one action's successor row from its lane infos."""
    writes = FieldSet.empty()
    accum = FieldSet.empty()
    reads = FieldSet.empty()
    decided = not guard.top
    for w, info in enumerate(lanes):
        if info.word == w and info.shift == 0:
            dirty = (~info.eq) & ALL64
            accb = info.acc & dirty
            plain = dirty & ~accb
            if plain:
                writes = writes.union(FieldSet.of(w, plain))
            if accb:
                accum = accum.union(FieldSet.of(w, accb))
            reads = reads.union(info.deps)
            if info.deps.top:
                decided = False
        else:
            # the lane is not a recognizable update of its own word:
            # conservatively a full write fed by everything it touches
            writes = writes.union(FieldSet.of(w, ALL64))
            reads = reads.union(info.as_data())
            if info.as_data().top:
                decided = False
    if writes.top or reads.top:
        decided = False
    return ActionFootprint(reads=reads, writes=writes, guard=guard,
                           decided=decided, accum=accum)


# -- guard-conjunct extraction ----------------------------------------------

_MAX_CONJUNCTS = 6  # per action; deeper and-trees fall back to one conjunct


def _and_leaves(x, depth: int = 16) -> Optional[list]:
    """Leaves of the boolean and-tree rooted at ``x``; None when the tree
    is degenerate (literal root)."""
    x = _walk(x)
    if is_literal(x):
        return None
    if (depth > 0 and op_name(x) in ("bitwise_and", "logical_and")
            and dtype_of(x) == torch.bool):
        out = []
        for y in x.args[:2]:
            sub = _and_leaves(y, depth - 1)
            if sub is None:
                return None
            out.extend(sub)
        return out
    return [x]


def _guard_nodes(graph: Graph, arity: int) -> Optional[list]:
    """Per-action ``(guard node, lane)`` pairs from the ``valid`` output's
    action-axis stack; None when it does not decompose.  A ``[B, cap]``
    piece covers ``cap`` consecutive actions (the per-channel kernel's one
    guard array per channel): each gets the same node with its lane."""
    vout = graph.outputs[1]
    pieces = _stack_pieces(vout, _ndim(vout) - 1)
    if pieces is None or len(pieces) != arity:
        return None
    out = []
    prev, lane = None, 0
    for p in pieces:
        v = _walk(p)
        lane = lane + 1 if (prev is not None and v is prev) else 0
        prev = v
        out.append((v, lane))
    return out


def _leaf_nodes_of(graph: Graph, arity: int) -> tuple:
    """(ordered leaf nodes, per-action ``(leaf, lane)`` indices) for the
    conjunct kernel (JAX ``_leaf_vars_of``), re-derivable at any batch
    size.  A ``[B, cap]`` leaf carries one lane per action of its block; a
    ``[B]`` leaf applies to the whole block (lane None)."""
    gnodes = _guard_nodes(graph, arity)
    leaves: list = []
    leaf_pos: dict = {}
    idx: list = []
    for a in range(arity):
        if gnodes is None or is_literal(gnodes[a][0]):
            idx.append(None)
            continue
        gv, lane = gnodes[a]
        lv = _and_leaves(gv)
        if not lv or len(lv) > _MAX_CONJUNCTS or any(
            is_literal(v) for v in lv
        ):
            idx.append(None)
            continue
        cidx = []
        for v in lv:
            sh = shape_of(v)
            if len(sh) == 1:
                ln = None
            elif len(sh) == 2 and lane < sh[-1]:
                ln = lane
            else:  # a shape the kernel cannot index per action
                cidx = None
                break
            if v not in leaf_pos:
                leaf_pos[v] = len(leaves)
                leaves.append(v)
            cidx.append((leaf_pos[v], ln))
        idx.append(cidx)
    return leaves, idx


def _conjunct_info(itp: _FpInterp, arity: int, guards: list) -> ConjunctInfo:
    """:class:`ConjunctInfo` from the captured kernel: the SAME leaf
    selection as :func:`_leaf_nodes_of` (the conjunct kernel compares its
    re-derived indices against these), plus the per-leaf read footprints;
    a laned reference reads the LANE's footprint when the leaf is
    tracked."""

    def conjunct_set(i, ln):
        av = itp.read(leaves[i])
        if ln is not None and av.tracked and ln < len(av.lanes):
            return av.lanes[ln].as_data()
        return av.collapse().as_data()

    leaves, leaf_idx = _leaf_nodes_of(itp.g, arity)
    sets = [
        [guards[a]] if idx is None
        else [conjunct_set(i, ln) for (i, ln) in idx]
        for a, idx in enumerate(leaf_idx)
    ]
    return ConjunctInfo(sets=sets, leaf_idx=leaf_idx, n_leaves=len(leaves))


def conjunct_eval_fn(tensor):
    """An evaluator of the guard-conjunct leaves, any batch size and
    device: ``fn(rows[B, W]) -> [bool[B] | bool[B, cap], ...]``, the raw
    leaf tensors the plan's ``(leaf, lane)`` references index, or None
    when the model has no evaluable leaves (JAX ``conjunct_eval_fn``).

    Per batch size and device, ``step_rows`` is captured on that device
    and the graph's output becomes the leaf nodes, dead code eliminated,
    so the evaluation runs only the guard operations; ``fn.build(batch,
    device)`` does that ahead of the first call (the engine builds its
    batch's when it is made, outside any step).  The modules are cached
    on the twin.  A capture whose leaves drift from the plan's makes
    ``fn`` return None (the caller then uses the union-of-enablers
    pull)."""
    fp = extract_footprints(tensor)
    if fp is None or fp.conjuncts is None or fp.conjuncts.n_leaves == 0:
        return None
    expect_idx = fp.conjuncts.leaf_idx
    cache: dict = getattr(tensor, "_conjunct_fn_cache", None)
    if cache is None:
        cache = {}
        try:
            tensor._conjunct_fn_cache = cache
        except Exception:  # noqa: BLE001 - __slots__ twins
            pass
    arity = tensor.max_actions

    def build(batch: int, device):
        key = (int(batch), str(torch.device(device)))
        built = cache.get(key)
        if built is None:
            g = graph_of(tensor, "step_rows", key[0], device)
            leaves, idx = _leaf_nodes_of(g, arity)
            if idx != expect_idx or not leaves:
                built = False  # the capture drifted: fall back
            else:
                built = torch.fx.GraphModule(g.gm, _leaf_graph(g, leaves))
            cache[key] = built
        return built

    def fn(rows):
        gm = build(rows.shape[0], rows.device)
        if gm is False:
            return None
        return list(gm(rows))

    fn.build = build
    return fn


def _leaf_graph(g: Graph, leaves: list) -> torch.fx.Graph:
    """A copy of ``g``'s graph whose output is the leaf nodes, dead code
    eliminated."""
    new = torch.fx.Graph()
    env: dict = {}
    for n in g.nodes:
        if n.op == "output":
            continue
        env[n] = new.node_copy(n, lambda x: env[x])
    new.output(tuple(env[v] for v in leaves))
    new.eliminate_dead_code()
    new.lint()
    return new


def extract_footprints(tensor, batch: int = 4) -> Optional[ModelFootprints]:
    """:class:`ModelFootprints` for ``tensor`` (cached on the twin: its
    kernels cannot change).  None when the twin has no usable
    ``width``/``max_actions`` or a kernel does not capture."""
    cached = getattr(tensor, "_footprint_cache", None)
    if cached is not None:
        return cached
    width = getattr(tensor, "width", None)
    arity = getattr(tensor, "max_actions", None)
    if not isinstance(width, int) or not isinstance(arity, int):
        return None
    findings: list = []
    try:
        g = graph_of(tensor, "step_rows", batch)
    except Exception:  # noqa: BLE001 - a kernel that does not capture
        return None

    itp = _FpInterp(g)
    try:
        succ_v, valid_v = itp.run(width)[:2]
    except Exception as e:  # noqa: BLE001 - degrade to all-TOP, loudly
        findings.append(AuditFinding(
            "JX300", Severity.WARNING, "step_rows",
            f"footprint pass crashed ({type(e).__name__}: {e}); every "
            "action is conservatively dependent on everything",
        ))
        succ_v = valid_v = None

    top_fp = ActionFootprint(
        reads=FieldSet.top_set(), writes=FieldSet.top_set(),
        guard=FieldSet.top_set(), decided=False,
    )
    actions = [top_fp] * arity
    decomposed = False

    # guards: valid [B, A], whose last axis IS the action axis
    guards = [FieldSet.top_set()] * arity
    if valid_v is not None:
        if valid_v.tracked and len(valid_v.lanes) == arity:
            guards = [i.as_data() for i in valid_v.lanes]
        else:
            guards = [valid_v.collapse().as_data()] * arity

    # the boundary filter takes part in every action's enabledness
    if getattr(tensor, "has_boundary", False):
        try:
            bg = graph_of(tensor, "boundary_rows", batch)
            b_out = _FpInterp(bg).run(width)
            b_deps = b_out[0].collapse().as_data() if b_out else (
                FieldSet.top_set()
            )
        except Exception:  # noqa: BLE001
            b_deps = FieldSet.top_set()
        guards = [x.union(b_deps) for x in guards]

    # successors: walk succ [B, A, W] back to its action-axis stack; each
    # piece is one action's row block
    if succ_v is not None:
        out = g.outputs[0]
        nd = _ndim(out)
        pieces = _stack_pieces(out, nd - 2) if nd >= 2 else None
        if pieces is None and arity == 1:
            pieces = [out]  # a one-action twin stacks nothing
        if pieces is not None and len(pieces) == arity:
            decomposed = True
            actions = []
            for a, piece in enumerate(pieces):
                pv = itp.read(piece)
                if pv.tracked and len(pv.lanes) == width:
                    fp = _action_footprint_from_lanes(pv.lanes, guards[a])
                else:
                    info = pv.collapse()
                    fp = ActionFootprint(
                        reads=info.as_data(), writes=FieldSet.top_set(),
                        guard=guards[a], decided=False,
                    )
                actions.append(fp)
        else:
            actions = [
                replace(top_fp, guard=guards[a]) for a in range(arity)
            ]

    # properties: property_masks [B, P], per-property lane deps
    prop_reads: list = []
    try:
        pg = graph_of(tensor, "property_masks", batch)
        p_out = _FpInterp(pg).run(width)
        pv = p_out[0] if p_out else TOP_AVAL
        n_props = _last(pg.outputs[0])
        if pv.tracked and len(pv.lanes) == n_props:
            prop_reads = [i.as_data() for i in pv.lanes]
        else:
            prop_reads = [pv.collapse().as_data()] * n_props
    except Exception:  # noqa: BLE001 - structural audit reports this
        prop_reads = []

    conjuncts = None
    if succ_v is not None:
        try:
            conjuncts = _conjunct_info(itp, arity, guards)
        except Exception:  # noqa: BLE001 - whole-guard fallback
            conjuncts = ConjunctInfo(
                sets=[[x] for x in guards],
                leaf_idx=[None] * arity, n_leaves=0,
            )

    out = ModelFootprints(
        width=width, n_actions=arity, actions=actions,
        prop_reads=prop_reads, decomposed=decomposed, findings=findings,
        conjuncts=conjuncts,
    )
    try:
        tensor._footprint_cache = out
    except Exception:  # noqa: BLE001 - __slots__ twins
        pass
    return out
