"""Integer interval abstract interpretation over captured aten graphs.

The port's copy of ``stateright_tpu/analysis/interval.py`` (:1-1093), on
the graph of ``analysis/graph.py`` (``make_fx`` over ``functionalize``)
instead of a closed jaxpr: one rule per aten operation in place of JAX's
one rule per primitive (:591-1093).  A forward pass tracks a ``[lo, hi]``
integer interval per value through the kernel's arithmetic, seeded from
the twin's declared :class:`~stateright_tpu_torch.parallel.tensor_model.
RowDomain`; the sanitizer (``sanitizer.py``) drives it and turns site
verdicts into JX2xx findings.

The JAX design points carry over:

 - **Sentinel outliers.**  A slot word's domain is ``[0, max_code] ∪
   {EMPTY}``: abstract values carry up to two exact outlier points beside
   the interval, mapped exactly by unary arithmetic and deleted by guard
   refinement.
 - **Guard refinement.**  ``where(pred, x, y)`` whose predicate compares
   a value against a constant re-evaluates each case with the compared
   value refined by the case's truth (a depth-bounded walk of the
   producing sub-graph).
 - **Field provenance.**  A value picked from a row word remembers
   ``(word, accumulated right shift)``; a later ``& mask`` with a
   contiguous mask at bit 0 is a ``BitPacker.get`` field extraction and
   meets the field's declared bound.

**The port's integers.**  Every value is what torch computes: an int64
in two's complement, so the domain is signed and torch's own semantics
apply unchanged (``add``/``mul`` wrap mod 2^64, ``>>`` is arithmetic,
comparisons are signed).  A row word enters from the ``RowDomain``'s
unsigned bounds as its bit pattern: ``EMPTY`` (held as 2^64 - 1 in the
domain) is the point -1, and a declared bound at or above 2^63 is top.
``lshr(x, k)`` (``ops/hashing.py``) is ``(x >> k) & (2^(64-k) - 1)``:
both operations are exact here, so ``EMPTY >> k`` stays the point -1 and
the mask maps it to ``2^(64-k) - 1``, the logical shift of ``EMPTY``; a
mask that keeps the whole interval keeps its field provenance, so the
field's ``& (2^bits - 1)`` after it still meets the declared bound.
Indices are genuine signed values: a negative index is what torch's own
range says it is (``sanitizer.py``'s :data:`INDEX_RANGES`).

Every transfer function is conservative: an unknown operation widens to
its dtype's hull, which the sanitizer counts as *undecided* (routed to
checked mode), never as proved.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Optional

import numpy as np
import torch

from .graph import (
    Graph, dtype_of, fill_value, literal_value, op_name, shape_of, walk_back,
)

_MAX_OUTLIERS = 2
_REFINE_DEPTH = 48  # guarded re-evaluation walk budget (nodes per case)


def _np_dtype(dtype):
    """numpy dtype of a torch or numpy dtype (None for floats/others)."""
    if isinstance(dtype, torch.dtype):
        if dtype == torch.bool:
            return np.dtype(np.bool_)
        if dtype.is_floating_point or dtype.is_complex:
            return np.dtype(np.float64)
        return np.dtype(str(dtype).replace("torch.", ""))
    return np.dtype(dtype)


def dtype_hull(dtype) -> Optional[tuple]:
    """``(lo, hi)`` of an integer/bool dtype (torch or numpy), None for
    floats/complex (JAX :47)."""
    if dtype is None:
        return None
    dt = _np_dtype(dtype)
    if dt == np.bool_:
        return (0, 1)
    if np.issubdtype(dt, np.signedinteger):
        b = dt.itemsize * 8
        return (-(1 << (b - 1)), (1 << (b - 1)) - 1)
    if np.issubdtype(dt, np.unsignedinteger):
        return (0, (1 << (dt.itemsize * 8)) - 1)
    return None


def _wrap(v: int, dtype) -> int:
    """Exact dtype wrap of a python int (what a convert/overflow does)."""
    dt = _np_dtype(dtype)
    if dt == np.bool_:
        return int(bool(v))
    bits = dt.itemsize * 8
    v &= (1 << bits) - 1
    if np.issubdtype(dt, np.signedinteger) and v >= (1 << (bits - 1)):
        v -= 1 << bits
    return v


@dataclass(frozen=True)
class IVal:
    """Abstract value: interval + exact outlier points + provenance flags
    (JAX :75).

    ``lo``/``hi`` are python ints (None = untracked, e.g. float dataflow).
    ``outliers`` are exact points the value may ALSO take, kept outside the
    interval (the EMPTY-sentinel machinery).  ``arith`` marks derivation
    through real arithmetic (the JX203 overflow-before-mask rule);
    ``word``/``shift`` are the BitPacker field-extraction provenance.
    """

    lo: Optional[int]
    hi: Optional[int]
    outliers: frozenset = frozenset()
    arith: bool = False
    word: Optional[int] = None  # input row word this value derives from
    shift: int = 0  # accumulated right shift since the word

    # -- constructors --------------------------------------------------------

    @staticmethod
    def top(dtype) -> "IVal":
        h = dtype_hull(dtype)
        if h is None:
            return IVal(None, None)
        return IVal(h[0], h[1])

    @staticmethod
    def const(v) -> "IVal":
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        a = np.asarray(v)
        if a.dtype == np.bool_:
            vs = {int(bool(x)) for x in a.reshape(-1)[:4097].tolist()} or {0}
            return IVal(min(vs), max(vs))
        if not np.issubdtype(a.dtype, np.integer):
            return IVal(None, None)
        if a.size == 0:
            return IVal(0, 0)
        return IVal(int(a.min()), int(a.max()))

    @staticmethod
    def point(v: int) -> "IVal":
        return IVal(int(v), int(v))

    # -- queries -------------------------------------------------------------

    @property
    def tracked(self) -> bool:
        return self.lo is not None

    def hull(self) -> Optional[tuple]:
        """``(lo, hi)`` including outliers (what a check must assume)."""
        if not self.tracked:
            return None
        pts = [self.lo, self.hi, *self.outliers]
        return (min(pts), max(pts))

    def is_top_for(self, dtype) -> bool:
        """Nothing learned beyond the dtype itself (=> 'undecided')."""
        h = dtype_hull(dtype)
        if h is None or not self.tracked:
            return True
        lo, hi = self.hull()
        return lo <= h[0] and hi >= h[1]

    def may_contain(self, v: int) -> bool:
        if not self.tracked:
            return True
        return (self.lo <= v <= self.hi) or v in self.outliers

    def singleton(self) -> Optional[int]:
        if self.tracked and self.lo == self.hi and not self.outliers:
            return self.lo
        return None

    # -- algebra -------------------------------------------------------------

    def _norm(self) -> "IVal":
        """Fold outliers into the interval when they stop being outliers
        (inside it, or too many to track exactly)."""
        if not self.tracked:
            return IVal(None, None)
        outs = {o for o in self.outliers if not self.lo <= o <= self.hi}
        if len(outs) > _MAX_OUTLIERS:
            pts = [self.lo, self.hi, *outs]
            return replace(self, lo=min(pts), hi=max(pts),
                           outliers=frozenset())
        return replace(self, outliers=frozenset(outs))

    def join(self, other: "IVal") -> "IVal":
        if not self.tracked or not other.tracked:
            return IVal(None, None)
        return IVal(
            min(self.lo, other.lo),
            max(self.hi, other.hi),
            self.outliers | other.outliers,
            self.arith or other.arith,
        )._norm()

    def clip(self, lo: Optional[int], hi: Optional[int]) -> Optional["IVal"]:
        """Meet with ``[lo, hi]`` (None = unbounded side); None if empty."""
        if not self.tracked:
            return self
        nlo = self.lo if lo is None else max(self.lo, lo)
        nhi = self.hi if hi is None else min(self.hi, hi)
        outs = frozenset(
            o for o in self.outliers
            if (lo is None or o >= lo) and (hi is None or o <= hi)
        )
        if nlo > nhi:
            if not outs:
                return None
            vals = sorted(outs)
            return IVal(vals[0], vals[-1], frozenset(vals[1:-1]),
                        self.arith)._norm()
        return IVal(nlo, nhi, outs, self.arith, self.word, self.shift)._norm()

    def drop_point(self, v: int) -> "IVal":
        """Refine under a ``!= v`` guard: exact only for outliers/endpoints."""
        if not self.tracked:
            return self
        if v in self.outliers:
            return replace(self, outliers=self.outliers - {v})
        if self.lo == self.hi == v:
            # contradiction; caller treats as dead, give the empty-ish point
            return self
        if v == self.lo:
            return replace(self, lo=self.lo + 1)
        if v == self.hi:
            return replace(self, hi=self.hi - 1)
        return self

    def map_exact(self, fn: Callable[[int], int],
                  *, arith: Optional[bool] = None) -> "IVal":
        """Apply a MONOTONE exact unary function to the interval endpoints
        and each outlier (shift/and-mask/add-const class).  Drops field
        provenance; callers that preserve it rebuild explicitly."""
        if not self.tracked:
            return IVal(None, None)
        a, b = fn(self.lo), fn(self.hi)
        return IVal(
            min(a, b), max(a, b),
            frozenset(fn(o) for o in self.outliers),
            self.arith if arith is None else arith,
        )._norm()


def _is_contiguous_mask(m: int) -> Optional[tuple]:
    """``m == (2^bits - 1) << off``?  Returns ``(off, bits)`` or None."""
    if m <= 0:
        return None
    off = (m & -m).bit_length() - 1
    run = m >> off
    if run & (run + 1):
        return None
    return off, run.bit_length()


# ---------------------------------------------------------------------------
# the interpreter
# ---------------------------------------------------------------------------


def _out_dtype(node):
    dt = dtype_of(node)
    if dt is None:
        val = node.meta.get("val") if isinstance(node, torch.fx.Node) else None
        if isinstance(val, (tuple, list)) and val:
            dt = getattr(val[0], "dtype", None)
    return dt if dt is not None else torch.int64


def _top_of(node) -> IVal:
    return IVal.top(_out_dtype(node))


class Interp:
    """One forward pass over a captured graph with an interval environment
    (JAX ``Interp``, :245).

    ``hooks`` (the sanitizer) receives ``site(itp, node, ins)`` at every
    node, ``mask_site`` at field masks and ``dead_branch`` at ``where``
    cases the interval proves dead.  ``row_domain`` seeds the graph's
    first input (the rows)."""

    def __init__(self, hooks=None, row_domain=None):
        self.hooks = hooks
        self.row_domain = row_domain
        self.env: dict = {}
        self.graph: Optional[Graph] = None
        self.input_node = None  # the rows node the domain seeds
        # False while _refine_eval re-walks a sub-graph: rules that report
        # through hooks (mask_site, dead_branch) stay silent there
        self._checking = True

    # -- env -----------------------------------------------------------------

    def arg(self, x, reader=None):
        """The abstract value of one argument: a node's interval, a Python
        int or bool as its point, a list element-wise, anything else
        None (a dtype, a float, None)."""
        if isinstance(x, torch.fx.Node):
            return (reader or self.read)(x)
        if isinstance(x, bool):
            return IVal.point(int(x))
        if isinstance(x, int):
            return IVal.point(x)
        if isinstance(x, float):
            return IVal(None, None)
        if isinstance(x, (list, tuple)):
            return [self.arg(a, reader) for a in x]
        return None

    def read(self, x) -> IVal:
        if not isinstance(x, torch.fx.Node):
            v = self.arg(x)
            return v if isinstance(v, IVal) else IVal(None, None)
        v = self.env.get(x)
        if v is None:
            v = _top_of(x)
            self.env[x] = v
        return v

    def write(self, node, val) -> None:
        if isinstance(val, IVal):
            val = val._norm() if val.tracked else val
        self.env[node] = val

    # -- entry ---------------------------------------------------------------

    def run(self, graph: Graph) -> list:
        """Interpret a captured graph; returns the output IVals."""
        self.graph = graph
        for i, n in enumerate(graph.inputs):
            if i == 0 and self.row_domain is not None:
                self.input_node = n
                self.write(n, self.row_domain.words_ival(
                    0, self.row_domain.width, signed=True))
            else:
                self.write(n, _top_of(n))
        for n in graph.nodes:
            if n.op in ("placeholder", "output"):
                continue
            try:
                self.node(n)
            except Exception:  # noqa: BLE001 - a rule bug must not kill the
                # audit: fall back to top for this node
                self.write(n, _top_of(n))
        return [self.read(o) for o in graph.outputs]

    def node(self, n) -> None:
        if n.op == "get_attr":
            c = self.graph.const_value(n)
            self.write(n, IVal.const(c))
            if self.hooks is not None:
                self.hooks.note_const(n, c)
            return
        ins = [self.arg(a) for a in n.args]
        out = self._transfer(n, ins, check=True)
        self.write(n, out)

    # -- structural walks ----------------------------------------------------

    def row_source(self, node) -> bool:
        """Is ``node`` the rows input, through shape-only operations that
        keep its last (word) axis?"""
        if self.input_node is None:
            return False
        width = self.row_domain.width
        for _ in range(8):
            if node is self.input_node:
                return True
            if (not isinstance(node, torch.fx.Node)
                    or op_name(node) not in _ROW_VIEWS
                    or not shape_of(node) or shape_of(node)[-1] != width):
                return False
            node = node.args[0]
        return False

    # -- guarded re-evaluation -----------------------------------------------

    def _refine_eval(self, node, base, refined: IVal,
                     depth: int = _REFINE_DEPTH) -> IVal:
        """Interval of ``node`` re-derived with ``base``'s value replaced
        by ``refined`` (memoized, depth-bounded walk of producers)."""
        memo: dict = {}
        saved_checking, self._checking = self._checking, False

        def go(v, d):
            if not isinstance(v, torch.fx.Node):
                return self.arg(v)
            if v is base:
                return refined
            if v in memo:
                return memo[v]
            if (d <= 0 or v.op != "call_function"
                    or fill_value(v) is not None):
                return self.read(v)
            memo[v] = self.read(v)  # cycle/width guard: current value
            ins = [self.arg(a, lambda x: go(x, d - 1)) for a in v.args]
            try:
                memo[v] = self._transfer(v, ins, check=False)
            except Exception:  # noqa: BLE001 - keep the current value
                pass
            return memo[v]

        try:
            out = go(node, depth)
            return out if isinstance(out, IVal) else self.read(node)
        finally:
            self._checking = saved_checking

    def _side_const(self, x) -> Optional[int]:
        """Exact constant value of one comparison side, if any."""
        v = literal_value(x)
        if v is not None:
            return v
        if isinstance(x, torch.fx.Node):
            iv = self.env.get(x)
            return iv.singleton() if isinstance(iv, IVal) else None
        return None

    def _guard_of(self, pred):
        """``(base, op, const)`` when the predicate is a comparison of a
        computed value against a constant (either side), else None."""
        n = walk_back(pred)
        if not isinstance(n, torch.fx.Node) or op_name(n) not in _CMP:
            return None
        a, b = n.args[0], n.args[1]
        op = op_name(n)
        cb = self._side_const(b)
        if (cb is not None and isinstance(a, torch.fx.Node)
                and literal_value(a) is None):
            return a, op, cb
        ca = self._side_const(a)
        if (ca is not None and isinstance(b, torch.fx.Node)
                and literal_value(b) is None):
            flip = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le",
                    "eq": "eq", "ne": "ne"}
            return b, flip[op], ca
        return None

    @staticmethod
    def _apply_guard(val: IVal, op: str, c: int, truth: bool):
        """Refine ``val`` under ``val <op> c == truth``; None = dead."""
        eff = {  # (op, truth) -> constraint
            ("lt", True): ("hi", c - 1), ("lt", False): ("lo", c),
            ("le", True): ("hi", c), ("le", False): ("lo", c + 1),
            ("gt", True): ("lo", c + 1), ("gt", False): ("hi", c),
            ("ge", True): ("lo", c), ("ge", False): ("hi", c - 1),
        }
        if (op, truth) in eff:
            side, bound = eff[(op, truth)]
            return val.clip(bound if side == "lo" else None,
                            bound if side == "hi" else None)
        if (op, truth) in (("eq", True), ("ne", False)):
            if not val.may_contain(c):
                return None
            return IVal.point(c)
        # != c: exact for outliers/endpoints, else unchanged
        if val.tracked and val.lo == val.hi == c and not val.outliers:
            return None
        return val.drop_point(c)

    # -- per-node transfer ---------------------------------------------------

    def _transfer(self, n, ins, *, check: bool):
        name = op_name(n)
        if check and self.hooks is not None:
            self.hooks.site(self, n, ins)
        fill = fill_value(n)
        if fill is not None:
            if isinstance(fill, float) and not fill.is_integer():
                return IVal(None, None)
            if dtype_hull(_out_dtype(n)) is None:
                return IVal(None, None)
            return IVal.point(int(fill))
        rule = _RULES.get(name)
        if rule is not None:
            return rule(self, n, ins)
        val = n.meta.get("val")
        if isinstance(val, (tuple, list)):
            return [IVal.top(getattr(v, "dtype", torch.int64)) for v in val]
        return _top_of(n)


# shape-only operations that keep the word axis of the rows (the seed's
# reach): what a twin puts between ``rows`` and ``rows[..., w]``
_ROW_VIEWS = frozenset({
    "unsqueeze", "expand", "clone", "alias", "detach", "lift_fresh_copy",
    "contiguous", "view", "reshape", "_unsafe_view", "slice",
})
_CMP = ("eq", "ne", "lt", "le", "gt", "ge")


# ---------------------------------------------------------------------------
# operation rules
# ---------------------------------------------------------------------------


def _iv(x) -> IVal:
    return x if isinstance(x, IVal) else IVal(None, None)


def _binop(fn_exact, widen_wrap=True):
    """Exact interval combine via ``fn_exact`` on endpoint pairs; widens
    to the output dtype hull when the result escapes it (torch wraps)."""

    def rule(itp: Interp, n, ins):
        a, b = _iv(ins[0]), _iv(ins[1])
        dt = _out_dtype(n)
        hull = dtype_hull(dt)
        if hull is None or not a.tracked or not b.tracked:
            return IVal(None, None) if hull is None else IVal.top(dt)
        cands = [fn_exact(x, y)
                 for x in (a.lo, a.hi) for y in (b.lo, b.hi)]
        lo, hi = min(cands), max(cands)
        arith = True
        # exact outlier propagation when ONE side is a single point
        outs = frozenset()
        bs, as_ = b.singleton(), a.singleton()
        if bs is not None and a.outliers:
            outs = frozenset(_wrap(fn_exact(o, bs), dt) for o in a.outliers)
        elif as_ is not None and b.outliers:
            outs = frozenset(_wrap(fn_exact(as_, o), dt) for o in b.outliers)
        elif a.outliers or b.outliers:
            pts = ([fn_exact(o, y) for o in a.outliers
                    for y in (b.lo, b.hi)]
                   + [fn_exact(x, o) for o in b.outliers
                      for x in (a.lo, a.hi)])
            lo, hi = min([lo, *pts]), max([hi, *pts])
        if widen_wrap and (lo < hull[0] or hi > hull[1]):
            return IVal(hull[0], hull[1], frozenset(), arith)
        return IVal(lo, hi, outs, arith)._norm()

    return rule


def _alpha(n) -> int:
    a = n.kwargs.get("alpha", n.args[2] if len(n.args) > 2 else 1)
    return int(a) if isinstance(a, (int, bool)) else 1


def _rule_add(itp, n, ins):
    k = _alpha(n)
    return _binop(lambda x, y: x + k * y)(itp, n, ins)


def _rule_sub(itp, n, ins):
    k = _alpha(n)
    return _binop(lambda x, y: x - k * y)(itp, n, ins)


def _rule_rsub(itp, n, ins):
    k = _alpha(n)
    return _binop(lambda x, y: y - k * x)(itp, n, ins)


def _rule_mul(itp, n, ins):
    return _binop(lambda x, y: x * y)(itp, n, ins)


def _is_bool(n) -> bool:
    return _out_dtype(n) == torch.bool


def _rule_and(itp: Interp, n, ins):
    a, b = _iv(ins[0]), _iv(ins[1])
    dt = _out_dtype(n)
    if _is_bool(n):
        if a.singleton() == 0 or b.singleton() == 0:
            return IVal.point(0)
        if a.singleton() == 1 and b.singleton() == 1:
            return IVal.point(1)
        return IVal(0, 1)
    if not a.tracked or not b.tracked:
        return IVal.top(dt)
    # mask side: one side an exact constant
    for m, v in ((a, b), (b, a)):
        ms = m.singleton()
        if ms is None:
            continue
        if ms == -1:  # all ones: the identity
            return v
        if ms < 0:
            break  # a clear mask (``w & ~m``): the general rule below
        contig = _is_contiguous_mask(ms)
        if (contig is not None and itp.hooks is not None and itp._checking):
            itp.hooks.mask_site(itp, n, v, ms)
        if v.lo >= 0 and v.hi <= ms:
            # the mask keeps the interval whole: exact, provenance kept
            # (lshr's low-bit mask), outliers mapped exactly
            if not v.outliers:
                return replace(v, arith=False)
            return replace(
                v, arith=False,
                outliers=frozenset(o & ms for o in v.outliers))._norm()
        hi = ms if v.lo < 0 else min(v.hull()[1], ms)
        out = IVal(0, hi)
        if contig is not None:
            off, bits = contig
            # field provenance: declared bound for bits [shift, shift+bits)
            if (itp.row_domain is not None and v.word is not None
                    and off == 0):
                declared = itp.row_domain.field_hi(v.word, v.shift, bits)
                if declared is not None:
                    out = IVal(0, min(out.hi, declared))
        return out
    if a.lo >= 0 or b.lo >= 0:
        his = [x.hull()[1] for x in (a, b) if x.lo >= 0]
        return IVal(0, min(his))
    return IVal.top(dt)


def _rule_or(itp, n, ins):
    a, b = _iv(ins[0]), _iv(ins[1])
    dt = _out_dtype(n)
    if _is_bool(n):
        if a.singleton() == 1 or b.singleton() == 1:
            return IVal.point(1)
        if a.singleton() == 0 and b.singleton() == 0:
            return IVal.point(0)
        return IVal(0, 1)
    if not a.tracked or not b.tracked or a.lo < 0 or b.lo < 0:
        return IVal.top(dt)
    if b.singleton() == 0:
        return a
    if a.singleton() == 0:
        return b
    ah, bh = a.hull()[1], b.hull()[1]
    hi = (1 << max(ah.bit_length(), bh.bit_length())) - 1
    return IVal(max(a.lo, b.lo), max(hi, ah, bh))


def _rule_xor(itp, n, ins):
    a, b = _iv(ins[0]), _iv(ins[1])
    dt = _out_dtype(n)
    if _is_bool(n):
        return IVal(0, 1)
    if not a.tracked or not b.tracked or a.lo < 0 or b.lo < 0:
        return IVal.top(dt)
    hi = (1 << max(a.hull()[1].bit_length(), b.hull()[1].bit_length())) - 1
    return IVal(0, hi)


def _rule_shr(itp: Interp, n, ins):
    a, s = _iv(ins[0]), _iv(ins[1])
    dt = _out_dtype(n)
    if not a.tracked or not s.tracked or s.lo < 0:
        return IVal.top(dt)
    ss = s.singleton()
    if ss is not None:
        # torch's >> is arithmetic, as Python's: exact and monotone
        out = a.map_exact(lambda v: v >> ss)
        if a.word is not None:  # field provenance survives a const rshift
            out = replace(out, word=a.word, shift=a.shift + ss)
        return out
    if a.lo < 0:
        return IVal.top(dt)
    return IVal(a.lo >> s.hi, a.hull()[1] >> s.lo)


def _rule_shl(itp, n, ins):
    a, s = _iv(ins[0]), _iv(ins[1])
    dt = _out_dtype(n)
    hull = dtype_hull(dt)
    if hull is None or not a.tracked or not s.tracked or s.lo < 0:
        return IVal.top(dt)
    ss = s.singleton()
    if ss is not None:
        out = a.map_exact(lambda v: v << ss, arith=a.arith)
    elif a.lo >= 0:
        out = IVal(a.lo << s.lo, a.hull()[1] << s.hi, frozenset(), a.arith)
    else:
        return IVal.top(dt)
    oh = out.hull()
    if oh[0] < hull[0] or oh[1] > hull[1]:
        return IVal(hull[0], hull[1], frozenset(), a.arith)
    return out


def _rule_cmp(name):
    def rule(itp, n, ins):
        a, b = _iv(ins[0]), _iv(ins[1])
        out = IVal(0, 1)
        if a.tracked and b.tracked:
            al, ah = a.hull()
            bl, bh = b.hull()
            verdict = None
            if name == "lt":
                verdict = True if ah < bl else (False if al >= bh else None)
            elif name == "le":
                verdict = True if ah <= bl else (False if al > bh else None)
            elif name == "gt":
                verdict = True if al > bh else (False if ah <= bl else None)
            elif name == "ge":
                verdict = True if al >= bh else (False if ah < bl else None)
            elif name == "eq":
                if ah < bl or al > bh:
                    verdict = False
                elif a.singleton() is not None and a.singleton() == b.singleton():
                    verdict = True
            elif name == "ne":
                if ah < bl or al > bh:
                    verdict = True
                elif (a.singleton() is not None
                      and a.singleton() == b.singleton()):
                    verdict = False
            if verdict is not None:
                out = IVal.point(int(verdict))
        return out

    return rule


def _rule_where(itp: Interp, n, ins):
    """``where(pred, x, y)``: JAX ``select_n(pred, y, x)`` (case 1 is the
    true case)."""
    pred = _iv(ins[0])
    cases = [(n.args[2], _iv(ins[2])), (n.args[1], _iv(ins[1]))]
    dt = _out_dtype(n)
    guard = itp._guard_of(n.args[0])
    taken = []
    for i, (cvar, cval) in enumerate(cases):
        if pred.tracked and not pred.may_contain(i):
            continue  # interval proves this case dead
        if guard is not None:
            base, op, c = guard
            refined = Interp._apply_guard(itp.read(base), op, c,
                                          truth=bool(i))
            if refined is None:
                continue  # guard contradiction: case unreachable
            if isinstance(cvar, torch.fx.Node):
                cval = itp._refine_eval(cvar, base, refined)
        taken.append(cval)
    if (itp.hooks is not None and itp._checking
            and len(taken) < len(cases)):
        itp.hooks.dead_branch(n, pred)
    if not taken:
        return IVal.top(dt)
    out = taken[0]
    for t in taken[1:]:
        out = out.join(t)
    return out


def _rule_convert(itp, n, ins):
    a = _iv(ins[0])
    dt = _out_dtype(n)
    hull = dtype_hull(dt)
    if hull is None:
        return IVal(None, None)
    if not a.tracked:
        return IVal.top(dt)
    if dt == torch.bool:
        if a.singleton() is not None:
            return IVal.point(int(a.singleton() != 0))
        if not a.may_contain(0):
            return IVal.point(1)
        return IVal(0, 1)
    if hull[0] <= a.lo and a.hi <= hull[1]:
        outs = frozenset(_wrap(o, dt) for o in a.outliers)
        return IVal(a.lo, a.hi, outs, a.arith, a.word, a.shift)._norm()
    return IVal.top(dt)


def _rule_identity(itp, n, ins):
    return _iv(ins[0])


def _rule_pick(itp: Interp, n, ins):
    """``select(x, dim, i)`` / ``slice(x, dim, start, end)``: a word (or
    a run of words) of the rows when ``x`` is the rows on their last axis;
    else the operand's value."""
    a = _iv(ins[0])
    x = n.args[0]
    if itp.row_domain is not None and itp.row_source(x):
        nd = len(shape_of(x))
        dim = n.args[1] if len(n.args) > 1 else 0
        dim = int(dim) + nd if int(dim) < 0 else int(dim)
        width = itp.row_domain.width
        if dim == nd - 1:
            if op_name(n) == "select":
                w = int(n.args[2])
                w = w + width if w < 0 else w
                return itp.row_domain.words_ival(w, w + 1, signed=True)
            start = n.args[2] if len(n.args) > 2 else 0
            end = n.args[3] if len(n.args) > 3 else width
            start = 0 if start is None else int(start)
            end = width if end is None else min(int(end), width)
            start = start + width if start < 0 else start
            end = end + width if end < 0 else end
            return itp.row_domain.words_ival(start, end, signed=True)
    return a


def _rule_arange(itp, n, ins):
    vals = [literal_value(a) for a in n.args[:3]]
    if len(n.args) == 1 and vals[0] is not None:
        return IVal(0, max(0, vals[0] - 1))
    if len(n.args) >= 2 and vals[0] is not None and vals[1] is not None:
        step = vals[2] if len(n.args) > 2 and vals[2] is not None else 1
        if step > 0:
            last = vals[0] + ((vals[1] - vals[0] - 1) // step) * step
            return IVal(vals[0], max(vals[0], last))
    return _top_of(n)


def _rule_join_list(itp, n, ins):
    parts = [_iv(v) for v in (ins[0] or [])]
    if not parts:
        return _top_of(n)
    out = parts[0]
    for v in parts[1:]:
        out = out.join(v)
    return out


def _rule_gather_value(itp: Interp, n, ins):
    # value interval: whatever the operand holds (the hooks' JX201 covers
    # the index side)
    return replace(_iv(ins[0]), word=None, shift=0)


def _rule_scatter_value(pos: int):
    def rule(itp, n, ins):
        a = _iv(ins[0])
        upd = ins[pos] if len(ins) > pos else None
        if isinstance(upd, IVal):
            return a.join(upd)
        return _top_of(n)

    return rule


def _reduced_count(n) -> int:
    in_elems = int(np.prod(shape_of(n.args[0]) or (1,)))
    out_elems = int(np.prod(shape_of(n) or (1,)))
    return max(1, in_elems // max(out_elems, 1))


def _rule_sum(itp, n, ins):
    a = _iv(ins[0])
    dt = _out_dtype(n)
    hull = dtype_hull(dt)
    if hull is None or not a.tracked:
        return IVal(None, None) if hull is None else IVal.top(dt)
    k = _reduced_count(n)
    lo, hi = a.hull()
    lo, hi = min(lo * k, lo), max(hi * k, hi)
    if lo < hull[0] or hi > hull[1]:
        return IVal.top(dt)
    return IVal(lo, hi, frozenset(), True)


def _rule_cumsum(itp, n, ins):
    a = _iv(ins[0])
    dt = _out_dtype(n)
    hull = dtype_hull(dt)
    if hull is None or not a.tracked:
        return IVal(None, None) if hull is None else IVal.top(dt)
    shape = shape_of(n.args[0])
    ax = int(n.args[1]) if len(n.args) > 1 else 0
    ax = ax + len(shape) if ax < 0 else ax
    k = int(shape[ax]) if ax < len(shape) else 1
    lo, hi = a.hull()
    lo, hi = min(lo, lo * k), max(hi, hi * k)
    if lo < hull[0] or hi > hull[1]:
        return IVal.top(dt)
    return IVal(lo, hi, frozenset(), True)


def _rule_keep(itp, n, ins):
    return replace(_iv(ins[0]), word=None, shift=0)


def _rule_minmax_value(itp, n, ins):
    """``max``/``min``: one tensor (a reduction, with indices when a dim
    is given) or two (elementwise)."""
    if len(ins) >= 2 and isinstance(ins[1], IVal) and isinstance(
            n.args[1], torch.fx.Node):
        fn = max if op_name(n) == "max" else min
        return _rule_minmax(fn)(itp, n, ins)
    v = replace(_iv(ins[0]), word=None, shift=0)
    val = n.meta.get("val")
    if isinstance(val, (tuple, list)):
        dim = int(n.args[1]) if len(n.args) > 1 else 0
        shape = shape_of(n.args[0])
        k = shape[dim] if shape else 1
        return [v, IVal(0, max(0, int(k) - 1))]
    return v


def _rule_minmax(fn):
    def rule(itp, n, ins):
        a, b = _iv(ins[0]), _iv(ins[1])
        if not a.tracked or not b.tracked:
            return _top_of(n)
        return IVal(fn(a.lo, b.lo), fn(a.hull()[1], b.hull()[1]))

    return rule


def _rule_clamp(itp, n, ins):
    # clamp(x, min, max) = min(max(x, lo), hi) elementwise, monotone
    x = _iv(ins[0])
    lo = ins[1] if len(ins) > 1 else None
    hi = ins[2] if len(ins) > 2 else None
    if op_name(n) == "clamp_min":
        lo, hi = ins[1], None
    elif op_name(n) == "clamp_max":
        lo, hi = None, ins[1]
    if not x.tracked:
        return _top_of(n)
    out_lo, out_hi = x.hull()
    if isinstance(lo, IVal) and lo.tracked:
        out_lo, out_hi = max(out_lo, lo.hull()[0]), max(out_hi, lo.hull()[1])
    if isinstance(hi, IVal) and hi.tracked:
        out_lo, out_hi = min(out_lo, hi.hull()[0]), min(out_hi, hi.hull()[1])
    elif hi is not None:
        return _top_of(n)
    return IVal(out_lo, out_hi)


def _rule_rem(itp, n, ins):
    a, b = _iv(ins[0]), _iv(ins[1])
    if a.tracked and b.tracked and a.lo >= 0 and b.lo > 0:
        return IVal(0, min(a.hull()[1], b.hull()[1] - 1), frozenset(), True)
    return _top_of(n)


def _rule_div(itp, n, ins):
    a, b = _iv(ins[0]), _iv(ins[1])
    dt = _out_dtype(n)
    if dtype_hull(dt) is None:
        return IVal(None, None)
    if a.tracked and b.tracked and a.lo >= 0 and b.lo > 0:
        return IVal(a.lo // b.hull()[1], a.hull()[1] // b.lo,
                    frozenset(), True)
    return IVal.top(dt)


def _rule_argextreme(itp, n, ins):
    shape = shape_of(n.args[0])
    dim = n.args[1] if len(n.args) > 1 else None
    if dim is None:
        k = int(np.prod(shape or (1,)))
    else:
        k = shape[int(dim)] if shape else 1
    return IVal(0, max(0, int(k) - 1))


def _rule_sort(itp, n, ins):
    """``sort`` -> ``(values, indices)``: the values keep the operand's
    interval, the indices run over the sorted axis."""
    shape = shape_of(n.args[0])
    dim = n.args[1] if len(n.args) > 1 and isinstance(n.args[1], int) else -1
    k = shape[int(dim)] if shape else 1
    return [replace(_iv(ins[0]), word=None, shift=0),
            IVal(0, max(0, int(k) - 1))]


def _rule_neg(itp, n, ins):
    a = _iv(ins[0])
    dt = _out_dtype(n)
    hull = dtype_hull(dt)
    if hull is None or not a.tracked:
        return IVal(None, None) if hull is None else IVal.top(dt)
    lo, hi = -a.hull()[1], -a.hull()[0]
    if lo < hull[0] or hi > hull[1]:
        return IVal.top(dt)
    return IVal(lo, hi, frozenset(), True)


def _rule_not(itp, n, ins):
    a = _iv(ins[0])
    dt = _out_dtype(n)
    if _is_bool(n):
        s = a.singleton()
        return IVal.point(1 - s) if s in (0, 1) else IVal(0, 1)
    if a.tracked:
        return a.map_exact(lambda v: _wrap(~v, dt))
    return IVal.top(dt)


def _rule_bool01(itp, n, ins):
    return IVal(0, 1)


def _rule_abs(itp, n, ins):
    a = _iv(ins[0])
    dt = _out_dtype(n)
    if dtype_hull(dt) is None:
        return IVal(None, None)
    if not a.tracked:
        return IVal.top(dt)
    lo, hi = a.hull()
    if lo >= 0:
        return IVal(lo, hi)
    if hi <= 0:
        return IVal(-hi, -lo)
    return IVal(0, max(-lo, hi))


def _rule_sign(itp, n, ins):
    a = _iv(ins[0])
    dt = _out_dtype(n)
    if dtype_hull(dt) is None:
        return IVal(None, None)
    if not a.tracked:
        return IVal(-1, 1)
    lo, hi = a.hull()
    if lo > 0:
        return IVal.point(1)
    if hi < 0:
        return IVal.point(-1)
    return IVal(-1 if lo < 0 else 0, 1 if hi > 0 else 0)


def _rule_pow(itp, n, ins):
    a = _iv(ins[0])
    y = literal_value(n.args[1]) if len(n.args) > 1 else None
    dt = _out_dtype(n)
    hull = dtype_hull(dt)
    if hull is None or y is None or not a.tracked or a.lo < 0 or y < 0:
        return IVal.top(dt) if hull else IVal(None, None)
    lo, hi = a.lo ** y, a.hull()[1] ** y
    if hi > hull[1]:
        return IVal.top(dt)
    return IVal(lo, hi, frozenset(), True)


def _rule_getitem(itp, n, ins):
    src = itp.env.get(n.args[0])
    if isinstance(src, (list, tuple)) and isinstance(n.args[1], int) \
            and n.args[1] < len(src):
        return src[n.args[1]]
    return _top_of(n)


def _rule_copy(itp, n, ins):
    """``copy(self, src)``: the value is ``src``'s."""
    return _iv(ins[1]) if len(ins) > 1 else _top_of(n)


def _rule_masked_fill(itp, n, ins):
    return _iv(ins[0]).join(_iv(ins[2]))


def _rule_select_scatter(itp, n, ins):
    return _iv(ins[0]).join(_iv(ins[1]))


_RULES = {
    "add": _rule_add, "sub": _rule_sub, "rsub": _rule_rsub, "mul": _rule_mul,
    "bitwise_and": _rule_and, "__and__": _rule_and, "logical_and": _rule_and,
    "bitwise_or": _rule_or, "__or__": _rule_or, "logical_or": _rule_or,
    "bitwise_xor": _rule_xor, "__xor__": _rule_xor, "logical_xor": _rule_xor,
    "bitwise_not": _rule_not, "logical_not": _rule_not, "neg": _rule_neg,
    "__rshift__": _rule_shr, "bitwise_right_shift": _rule_shr,
    "__lshift__": _rule_shl, "bitwise_left_shift": _rule_shl,
    "eq": _rule_cmp("eq"), "ne": _rule_cmp("ne"), "lt": _rule_cmp("lt"),
    "le": _rule_cmp("le"), "gt": _rule_cmp("gt"), "ge": _rule_cmp("ge"),
    "where": _rule_where,
    "_to_copy": _rule_convert, "to": _rule_convert,
    "view": _rule_identity, "reshape": _rule_identity,
    "_unsafe_view": _rule_identity, "expand": _rule_identity,
    "squeeze": _rule_identity, "unsqueeze": _rule_identity,
    "permute": _rule_identity, "transpose": _rule_identity,
    "t": _rule_identity, "flip": _rule_identity, "clone": _rule_identity,
    "alias": _rule_identity, "detach": _rule_identity,
    "lift_fresh_copy": _rule_identity, "contiguous": _rule_identity,
    "repeat": _rule_identity, "roll": _rule_identity,
    "select": _rule_pick, "slice": _rule_pick,
    "arange": _rule_arange,
    "cat": _rule_join_list, "stack": _rule_join_list,
    "index": _rule_gather_value, "index_select": _rule_gather_value,
    "gather": _rule_gather_value, "take": _rule_gather_value,
    "take_along_dim": _rule_gather_value,
    "index_put": _rule_scatter_value(2),
    "_index_put_impl": _rule_scatter_value(2),
    # ``(self, dim, index, src)``: the update is the fourth argument
    **{op: _rule_scatter_value(3) for op in (
        "scatter", "scatter_add", "scatter_reduce", "index_add",
        "index_copy", "index_fill")},
    "select_scatter": _rule_select_scatter,
    "slice_scatter": _rule_select_scatter,
    "masked_fill": _rule_masked_fill,
    "copy": _rule_copy,
    "sum": _rule_sum, "cumsum": _rule_cumsum,
    "amax": _rule_keep, "amin": _rule_keep, "cummax": _rule_keep,
    "cummin": _rule_keep, "max": _rule_minmax_value,
    "min": _rule_minmax_value,
    "any": _rule_bool01, "all": _rule_bool01,
    "argmax": _rule_argextreme, "argmin": _rule_argextreme,
    "sort": _rule_sort,
    "maximum": _rule_minmax(max), "minimum": _rule_minmax(min),
    "clamp": _rule_clamp, "clamp_min": _rule_clamp, "clamp_max": _rule_clamp,
    "remainder": _rule_rem, "fmod": _rule_rem,
    "floor_divide": _rule_div, "div": _rule_div,
    "pow": _rule_pow, "abs": _rule_abs, "sign": _rule_sign,
    "getitem": _rule_getitem,
    "eye": _rule_bool01,
}
