"""Soundness sanitizer: interval bounds over the twin's kernels, and
checked execution mode (the dynamic guard).

The port's copy of ``stateright_tpu/analysis/sanitizer.py``.  Two halves,
one contract (JAX :1-47):

 - **Static** (:func:`run_sanitizer`, JAX :77-514): forward interval
   abstract interpretation (``interval.py``) over the captured
   ``step_rows`` and ``property_masks`` graphs (``analysis/graph.py``,
   the capture ``.por()`` and the cost model share), seeded from the
   twin's declared bounds (``RowDomain``, or a discovered ``BitPacker``'s
   field widths).  Decidable violations are findings:

   - ``JX201`` error -- a gather's index interval escapes its operation's
     valid range (``index``, ``index_select``, ``gather``, ``take``);
   - ``JX202`` error -- an indexed write's index may escape
     (``index_put``, ``scatter*``, ``index_add``, ``index_copy``,
     ``index_fill``: the functionalized forms of every indexed write);
   - ``JX203`` warning -- packed-field arithmetic provably overflows its
     declared width before the mask (info when the escape is partial);
   - ``JX204`` warning -- a gather may read an ``EMPTY`` slot (-1) and
     feed it into arithmetic with no ``EMPTY`` comparison in sight;
   - ``JX205`` info -- the interval proves a ``where`` case dead;
   - ``JX200`` warning -- the pass crashed on a kernel (never a clean
     verdict).

   Where the domain cannot decide, the site is counted ``undecided``
   (info) and routed to checked mode; an escape verdict needs a learned
   bound (JAX :152), so "nothing known" is never an error.  The valid
   ranges are torch's own, one table for both halves
   (:data:`INDEX_RANGES`): ``index``, ``index_put``, ``take`` and
   ``index_fill`` take ``-n <= i < n``, the others ``0 <= i < n``.
   torch normalises a negative index inside the operation, so there is
   no JAX-style ``where(i < 0, i + n, i)`` to exempt from ``JX205``.
   On CUDA an out-of-range index is a device-side assert that ends the
   process's CUDA context (XLA clamps silently), so the ``spawn_gpu``
   preflight's ``JX201``/``JX202`` abort is what keeps a defective twin
   off the card.
 - **Dynamic** (:class:`CheckedGuard`, JAX :516-607): checked mode,
   below.

Checked mode is the port's counterpart of the dynamic half of
``stateright_tpu/analysis/sanitizer.py`` (``CheckedExecutionError``,
:516; ``checkify_kernels``, :535; ``error_flag``, :551;
``localize_checked_failure``, :576).

torch has no checkify.  :class:`CheckedGuard` is a ``TorchDispatchMode``
that the engine enters around the twin's ``property_masks`` and
``step_rows`` only, and only under ``.checked()``; the engine's own
gathers and scatters stay unguarded, as in JAX, which wraps the model
kernels alone.  For each operation the checks of
``checkify.index_checks | checkify.float_checks`` (JAX :529-532) apply:

 - **indices** of ``aten.index``, ``index_put(_)``, ``take``,
   ``index_select``, ``gather``, ``scatter*``, ``index_add(_)``,
   ``index_copy(_)`` and ``index_fill(_)``: an index outside its
   operation's valid range raises the flag.  The ranges are torch's, so
   that the clamped operation can never fault: ``index``,
   ``index_put(_)``, ``take`` and ``index_fill(_)`` take ``-n <= i < n``
   (a negative index counts from the end, as a ``jnp`` subscript's
   does); the others take ``0 <= i < n``, where a negative index is out
   of range (``lax.gather``'s own rule).  Boolean-mask indices are not
   checked;
 - **divisors** of ``div``, ``floor_divide``, ``remainder`` and ``fmod``
   (checkify's division check covers every ``lax.div``/``lax.rem``): a
   zero divisor raises the flag;
 - **NaN**: an operation whose floating-point output holds a NaN raises
   the flag.

A flag is a device ``bool`` ORed into :attr:`CheckedGuard.err`; the
guard never reads it on the host (no ``.item()``, ``bool()`` or
``nonzero()``).  Then the operation runs on clamped indices (each into
its valid range, where XLA's gather clamps to ``[0, n - 1]`` after a
``jnp`` subscript wraps negatives: the two agree on every index) or on a
divisor of 1 in place of each zero, so a checked step never trips a CUDA
device-side assert and computes what XLA's clamped gather computes until
the block stops.  The engine ORs the step's flag into the carry's error
word, stops the block at the first failing step, and raises
:class:`CheckedExecutionError` at the next host sync after replaying the
step's window one row at a time (:func:`localize_checked_failure`).

Without ``.checked()`` the port adds no clamp: a twin's out-of-range
gather raises ``IndexError`` on the CPU and hits a device-side assert on
CUDA, which ends the process's CUDA context (JAX clamps silently; README
and ROADMAP record the difference).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .graph import dtype_of, graph_of, literal_value, op_name, shape_of
from .graph import walk_back
from .interval import Interp, dtype_hull
from .report import AuditFinding, Severity

# The indexed operations and their valid ranges, one table for the static
# pass and the guard, by overload packet with the in-place underscore
# dropped: op -> (argument form, negative index valid, static rule).
# ``list``: ``(self, indices, ...)``, one index tensor per dimension;
# ``take``: ``(self, index)`` over the flattened tensor; ``dim``:
# ``(self, dim, index, ...)``.  A negative index counts from the end
# where it is valid (a ``jnp`` subscript's rule); elsewhere it is out of
# range (``lax.gather``'s).
INDEX_RANGES = {
    "index": ("list", True, "JX201"),
    "index_put": ("list", True, "JX202"),
    "_index_put_impl": ("list", True, "JX202"),
    "take": ("take", True, "JX201"),
    "index_select": ("dim", False, "JX201"),
    "gather": ("dim", False, "JX201"),
    "scatter": ("dim", False, "JX202"),
    "scatter_add": ("dim", False, "JX202"),
    "scatter_reduce": ("dim", False, "JX202"),
    "index_add": ("dim", False, "JX202"),
    "index_copy": ("dim", False, "JX202"),
    "index_fill": ("dim", True, "JX202"),
}
_DIM_INDEX_OPS = {op: neg for op, (form, neg, _) in INDEX_RANGES.items()
                  if form == "dim"}
_DIV_OPS = {"div", "floor_divide", "remainder", "fmod"}


class CheckedExecutionError(RuntimeError):
    """A guarded kernel check failed during a checked run.  Carries the
    offending batch row (its index in the replayed window, its raw words
    and, where the twin decodes it, the state) and the check's message
    (JAX ``analysis/sanitizer.py:516``)."""

    def __init__(self, message: str, row_index: Optional[int] = None,
                 row=None, state=None):
        self.row_index = row_index
        self.row = row
        self.state = state
        super().__init__(message)


_KINDS: dict = {}


def _kind(func) -> tuple:
    """``(op, kind)`` of an operation, cached (the guard asks for every
    operation): ``op`` its name with an in-place underscore dropped,
    ``kind`` the check its arguments get (``"list"``, ``"take"``,
    ``"dim"``, ``"div"``), or None for one that runs as it is."""
    got = _KINDS.get(func)
    if got is None:
        op = func.overloadpacket.__name__
        op = op[:-1] if op.endswith("_") else op
        kind = (INDEX_RANGES[op][0] if op in INDEX_RANGES else
                "div" if op in _DIV_OPS else None)
        got = _KINDS[func] = (op, kind)
    return got


class CheckedGuard(TorchDispatchMode):
    """The dynamic guard (module docstring).  ``err`` is the device flag
    the checks OR into; set it before entering and read it after.  With
    ``record=True`` (the host replay) each failed-check candidate is also
    kept in :attr:`records` as ``(flag, message_fn)``, read on the host
    after the replay."""

    def __init__(self, err: Optional[torch.Tensor] = None,
                 record: bool = False):
        super().__init__()
        self.err = err
        self.record = record
        self.records: list = []

    # -- the checks ----------------------------------------------------------

    def _flag(self, bad: torch.Tensor, message_fn) -> None:
        bad = bad.any() if bad.dim() else bad
        self.err = bad if self.err is None else (self.err | bad)
        if self.record:
            self.records.append((bad, message_fn))

    def _checked_index(self, op: str, idx, size: int, axis: int,
                       negative_ok: bool, shape):
        """``idx`` clamped into its valid range, the flag raised for any
        index outside it."""
        if (not isinstance(idx, torch.Tensor) or idx.dtype == torch.bool
                or idx.dtype == torch.uint8 or size <= 0):
            return idx
        lo = -size if negative_ok else 0
        bad = (idx < lo) | (idx >= size)

        def message(idx=idx, bad=bad):
            first = int(idx[bad].reshape(-1)[0])
            return (f"out-of-bounds indexing in aten.{op} for a tensor of "
                    f"shape {tuple(shape)}: index {first} is out of bounds "
                    f"for axis {axis} with size {size}")

        self._flag(bad, message)
        return idx.clamp(lo, size - 1)

    def _index_list(self, op: str, args: tuple) -> tuple:
        self_t, indices = args[0], list(args[1])
        dim = 0
        for k, idx in enumerate(indices):
            if idx is None:
                dim += 1
                continue
            if idx.dtype in (torch.bool, torch.uint8):
                dim += idx.dim()  # a mask spans as many dimensions
                continue
            indices[k] = self._checked_index(op, idx, self_t.shape[dim], dim,
                                             True, self_t.shape)
            dim += 1
        return (self_t, indices) + tuple(args[2:])

    def _dim_index(self, op: str, args: tuple, negative_ok: bool) -> tuple:
        self_t, dim, idx = args[0], args[1], args[2]
        d = dim % max(self_t.dim(), 1)
        size = self_t.shape[d] if self_t.dim() else 1
        idx = self._checked_index(op, idx, size, d, negative_ok,
                                  self_t.shape)
        return (self_t, dim, idx) + tuple(args[3:])

    def _divisor(self, op: str, args: tuple) -> tuple:
        other = args[1]
        if isinstance(other, torch.Tensor):
            zero = other == 0
            self._flag(zero, lambda: f"division by zero in aten.{op}")
            other = torch.where(zero, torch.ones_like(other), other)
        elif other == 0:
            self._flag(torch.ones((), dtype=torch.bool,
                                  device=args[0].device),
                       lambda: f"division by zero in aten.{op}")
            other = 1
        return (args[0], other) + tuple(args[2:])

    def _nan(self, op: str, out) -> None:
        outs = out if isinstance(out, (tuple, list)) else (out,)
        for o in outs:
            if isinstance(o, torch.Tensor) and o.is_floating_point():
                self._flag(torch.isnan(o).any(),
                           lambda: f"nan generated by aten.{op}")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        op, kind = _KINDS.get(func) or _kind(func)
        if kind == "list":
            args = self._index_list(op, args)
        elif kind == "take":
            n = args[0].numel()
            args = (args[0], self._checked_index(op, args[1], n, 0, True,
                                                 (n,)))
        elif kind == "dim":
            args = self._dim_index(op, args, _DIM_INDEX_OPS[op])
        elif kind == "div" and len(args) > 1:
            args = self._divisor(op, args)
        out = func(*args, **(kwargs or {}))
        if isinstance(out, torch.Tensor):
            # the twins' operations are integer: one dtype test each
            if out.is_floating_point():
                self._nan(op, out)
        elif isinstance(out, (tuple, list)):
            self._nan(op, out)
        return out


def checked_kernels(tensor):
    """``(rows, err) -> (err, (masks, succ, valid))``: the twin's model
    kernels under :class:`CheckedGuard`, the flag ORed into ``err`` (a
    0-d device ``bool``), the counterpart of ``checkify_kernels`` (JAX
    :535).  Only the model kernels are guarded: the engine's insert and
    append index with lanes it builds itself."""

    def kernels(rows, err):
        guard = CheckedGuard(err)
        with guard:
            masks = tensor.property_masks(rows)
            succ, valid = tensor.step_rows(rows)
        return error_flag(guard, err), (masks, succ, valid)

    return kernels


def error_flag(guard: CheckedGuard, err: torch.Tensor) -> torch.Tensor:
    """The 0-d device ``bool`` "some check failed": ``err`` ORed with
    every flag the guard raised (JAX ``error_flag``, :551).  No host
    read."""
    return err if guard.err is None else guard.err


def localize_checked_failure(tensor, rows_np, device="cpu", base_exc=None):
    """Re-run the guarded kernels one row at a time on ``device`` to name
    the offending row, then raise :class:`CheckedExecutionError` (JAX
    :576).  Always raises: with the block-level message when no single
    row reproduces the failure (a check that needs the batch)."""
    rows_np = np.asarray(rows_np, np.uint64)
    for i in range(rows_np.shape[0]):
        row = torch.from_numpy(rows_np[i:i + 1].view(np.int64).copy())
        guard = CheckedGuard(record=True)
        msg = None
        try:
            with guard:
                tensor.property_masks(row.to(device))
                tensor.step_rows(row.to(device))
            for bad, message_fn in guard.records:
                if bool(bad):
                    msg = message_fn()
                    break
        except Exception as e:  # noqa: BLE001 - a replay crash names the row
            msg = f"kernel crashed during per-row replay: {e}"
        if msg:
            state = None
            try:
                state = tensor.decode_state(rows_np[i])
            except Exception:  # noqa: BLE001 - decoding is best-effort
                pass
            raise CheckedExecutionError(
                "checked mode: a kernel check failed at batch row "
                f"{i} (state={state!r}, row words="
                f"{[hex(int(w)) for w in rows_np[i]]}):\n{msg}",
                row_index=i, row=rows_np[i], state=state,
            ) from base_exc
    raise CheckedExecutionError(
        "checked mode: a kernel check failed inside the device block but "
        f"per-row replay did not reproduce it (underlying: {base_exc})",
    ) from base_exc


# ---------------------------------------------------------------------------
# the static half: the hooks interval.Interp calls back into (JAX :77-441)
# ---------------------------------------------------------------------------

EMPTY = -1  # the port's EMPTY word: 2^64 - 1 as an int64 bit pattern

_ARITH_OPS = frozenset({
    "add", "sub", "rsub", "mul", "div", "floor_divide", "remainder", "fmod",
    "pow", "cumsum", "sum", "__lshift__", "bitwise_left_shift", "neg",
})
# what a JX204 use-walk looks through (JAX: the transparent set, slice,
# select_n)
_PASS = frozenset({
    "view", "reshape", "_unsafe_view", "expand", "squeeze", "unsqueeze",
    "_to_copy", "clone", "alias", "detach", "contiguous", "permute",
    "select", "slice", "where", "cat", "stack",
})


class _Hooks:
    """Collects the site verdicts of one kernel's graph (JAX ``_Hooks``)."""

    def __init__(self, kernel: str):
        self.kernel = kernel
        self.findings: list = []
        self.sites = 0
        self.proved = 0
        self.undecided = 0
        self.dead_branches = 0
        self._site_no = 0
        self._empty_consts: set = set()  # const nodes holding EMPTY
        self._jx204_candidates: list = []  # (gather node, loc)

    def note_const(self, node, c) -> None:
        try:
            a = np.asarray(c)
        except Exception:  # noqa: BLE001
            return
        if a.dtype == np.uint64:
            a = a.view(np.int64)
        if (a.dtype == np.int64 and a.size > 1
                and bool((a == EMPTY).any()) and bool((a != EMPTY).any())):
            self._empty_consts.add(node)

    def _loc(self, op: str) -> str:
        self._site_no += 1
        return f"{self.kernel}:{op}#{self._site_no}"

    # -- site checks ---------------------------------------------------------

    def site(self, itp, node, ins) -> None:
        op = op_name(node)
        op = op[:-1] if op.endswith("_") else op
        entry = INDEX_RANGES.get(op)
        if entry is None:
            return
        form, negative_ok, rule = entry
        self_t = node.args[0]
        shape = shape_of(self_t)
        pairs = []  # (dim, index node, index IVal, axis size)
        if form == "list":
            dim = 0
            for idx, val in zip(node.args[1], ins[1]):
                if idx is None:
                    dim += 1
                    continue
                if dtype_of(idx) in (torch.bool, torch.uint8):
                    dim += len(shape_of(idx))  # a mask spans its dims
                    continue
                if dim < len(shape):
                    pairs.append((dim, idx, val, int(shape[dim])))
                dim += 1
        elif form == "take":
            pairs.append((0, node.args[1], ins[1], int(np.prod(shape or (1,)))))
        else:
            d = int(node.args[1])
            d = d + len(shape) if d < 0 else d
            size = int(shape[d]) if shape else 1
            pairs.append((d, node.args[2], ins[2], size))
        if not pairs:
            return
        self.sites += 1
        verdicts, details = [], []
        for d, idx, val, size in pairs:
            lo_ok = -size if negative_ok else 0
            v = self._verdict(val, lo_ok, size - 1, dtype_of(idx))
            verdicts.append(v)
            if v != "proved":
                hull = val.hull() if hasattr(val, "hull") else None
                details.append(
                    f"dim {d}: index in "
                    f"{'[%d, %d]' % hull if hull else '<untracked>'} vs "
                    f"valid [{lo_ok}, {size - 1}] (axis {size})")
        if rule == "JX201":
            why = ("gather index interval escapes the operand axis: on CUDA "
                   "the access is a device-side assert that ends the "
                   "process's CUDA context (XLA would silently clamp, "
                   "dropping or duplicating successors)")
        else:
            why = ("indexed write may exceed the target: on CUDA a "
                   "device-side assert (XLA would silently drop the write, "
                   "the buckets.insert failure class)")
        self._finish_site(rule, op, verdicts, details, why)
        if rule == "JX201":
            # JX204: the gather may READ the EMPTY sentinel
            op_val = ins[0]
            may_empty = (hasattr(op_val, "tracked") and op_val.tracked
                         and op_val.may_contain(EMPTY)
                         and not op_val.is_top_for(dtype_of(self_t)))
            if may_empty or walk_back(self_t) in self._empty_consts:
                self._jx204_candidates.append((node, self._loc(op)))

    @staticmethod
    def _verdict(idx, lo_ok: int, hi_ok: int, dtype) -> str:
        """'proved' | 'escape' | 'undecided' for an index against
        ``[lo_ok, hi_ok]`` (JAX ``_verdict``): an escape needs a LEARNED
        bound, an interval narrower than half its dtype's range."""
        if not hasattr(idx, "tracked") or not idx.tracked:
            return "undecided"
        lo, hi = idx.hull()
        if lo_ok <= lo and hi <= hi_ok:
            return "proved"
        dh = dtype_hull(dtype if dtype is not None else torch.int64)
        if dh is None or (hi - lo + 1) * 2 >= (dh[1] - dh[0] + 1):
            return "undecided"
        return "escape"

    def _finish_site(self, rule: str, op: str, verdicts, details,
                     why) -> None:
        if all(v == "proved" for v in verdicts):
            self.proved += 1
            return
        loc = self._loc(op)
        if any(v == "escape" for v in verdicts):
            self.findings.append(AuditFinding(
                rule, Severity.ERROR, loc, f"{why} ({'; '.join(details)})",
            ))
        else:
            self.undecided += 1
            self.findings.append(AuditFinding(
                rule, Severity.INFO, loc,
                "interval domain cannot bound this index "
                f"({'; '.join(details)}); not flagged as an error -- run "
                "checked mode (CheckerBuilder.checked() / --checked) to "
                "guard it dynamically",
            ))

    # -- mask / JX203 --------------------------------------------------------

    def mask_site(self, itp, node, val, mask: int) -> None:
        if not val.arith or not val.tracked:
            return  # extraction of a raw/packed word, not packing arithmetic
        if val.is_top_for(torch.int64):
            return  # nothing learned: the extraction idiom
        lo, hi = val.hull()
        if lo < 0:
            return  # JAX's u64 domain wraps this to top: nothing learned
        if hi <= mask and lo >= 0:
            return
        # provable only when even the MINIMUM escapes the field; a partial
        # escape is the reachability-undecidable case (info + checked mode)
        blatant = lo > mask
        self.findings.append(AuditFinding(
            "JX203",
            Severity.WARNING if blatant else Severity.INFO,
            self._loc("bitwise_and"),
            f"packed-field arithmetic in [{lo}, {hi}] "
            f"{'provably overflows (for every input)' if blatant else 'may overflow'} "
            f"its declared width before the mask 0x{mask:x}: high bits are "
            "silently truncated and the packed field wraps"
            + ("" if blatant else
               " -- if reachability bounds it, checked mode "
               "(CheckerBuilder.checked()) can confirm dynamically"),
        ))

    # -- dead branches / JX205 -----------------------------------------------

    def dead_branch(self, node, pred) -> None:
        self.dead_branches += 1
        if self.dead_branches > 4:  # cap the noise; the count rides metrics
            return
        self.findings.append(AuditFinding(
            "JX205", Severity.INFO, self._loc("where"),
            f"interval proves a branch dead (predicate is constantly "
            f"{pred.singleton()}): dead model logic, or a guard made "
            "redundant by the declared domain -- worth a look",
        ))

    # -- JX204 post-pass -----------------------------------------------------

    def finish(self) -> None:
        """Resolve the JX204 candidates: fire when the sentinel-carrying
        gather output reaches arithmetic without an ``EMPTY`` comparison."""
        for node, loc in self._jx204_candidates:
            frontier, seen, hit, guarded = [node], set(), False, False
            for _ in range(6):
                nxt = []
                for v in frontier:
                    for u in v.users:
                        name = op_name(u)
                        if _is_sentinel_test(u, v):
                            guarded = True
                            continue
                        if name == "where" and u.args[0] is not v and (
                                _is_sentinel_test(walk_back(u.args[0]))):
                            guarded = True  # selected under a sentinel test
                        if name in _ARITH_OPS:
                            hit = True
                        if name in _PASS and u not in seen:
                            seen.add(u)
                            nxt.append(u)
                frontier = nxt
                if hit or not frontier:
                    break
            if hit and not guarded:
                self.findings.append(AuditFinding(
                    "JX204", Severity.WARNING, loc,
                    "gather may read an EMPTY-sentinel (uninitialized) "
                    "slot and feed it into arithmetic with no EMPTY "
                    "comparison in sight: the sentinel's bit pattern "
                    "(-1, 2^64-1 unsigned) silently poisons the derived "
                    "values",
                ))


def _is_sentinel_test(u, v=None) -> bool:
    """Is ``u`` a comparison of ``v`` (any value when None) against
    ``EMPTY`` (-1) or 0?  JAX's guard is an ``eq``/``ne`` against
    ``EMPTY``; in the port's signed words a sign test (``x >= 0``,
    ``x < 0``) tells ``EMPTY`` apart as well."""
    if not isinstance(u, torch.fx.Node) or op_name(u) not in (
            "eq", "ne", "lt", "le", "gt", "ge"):
        return False
    a, b = u.args[0], u.args[1]
    if v is not None and a is not v and b is not v:
        return False
    other = b if (v is None or a is v) else a
    return literal_value(other) in (EMPTY, 0)


# ---------------------------------------------------------------------------
# domain discovery + the static driver (JAX :444-514)
# ---------------------------------------------------------------------------


def resolve_row_domain(tensor):
    """The twin's declared ``RowDomain``: its ``row_domain()`` hook when
    defined, else synthesized from a discovered ``BitPacker`` attribute
    (field widths as bounds), else None (every word top)."""
    from ..parallel.tensor_model import BitPacker, RowDomain

    fn = getattr(tensor, "row_domain", None)
    if callable(fn):
        try:
            dom = fn()
        except Exception:  # noqa: BLE001 - a broken hook must not kill audit
            dom = None
        if dom is not None:
            return dom
    width = getattr(tensor, "width", None)
    packers = [
        v for v in vars(tensor).values()
        if isinstance(v, BitPacker) and v.width <= (width or v.width)
    ]
    if len(packers) != 1 or not isinstance(width, int):
        return None
    dom = RowDomain.from_packer(packers[0])
    if dom.width < width:
        wide = RowDomain(width)
        wide._words[: dom.width] = dom._words
        wide._fields = dom._fields
        return wide
    return dom


def run_sanitizer(tensor, report, model=None, batch: int = 4) -> None:
    """Interval-sanitize ``tensor``'s kernels into ``report`` (findings +
    ``metrics['sanitizer']``; JAX :464).  Cached on the twin, like the
    kernel audit: its kernels cannot change under a fixed twin."""
    cache = getattr(tensor, "_sanitizer_cache", None)
    if cache is not None:
        report.extend(cache[0])
        report.metrics["sanitizer"] = dict(cache[1])
        return
    width = getattr(tensor, "width", None)
    if not isinstance(width, int):
        return  # JX103 (the kernel audit) already reports this
    domain = resolve_row_domain(tensor)
    findings: list = []
    summary = {"sites": 0, "proved": 0, "undecided": 0,
               "dead_branches": 0, "seeded": domain is not None,
               "kernels": {}}
    for kernel in ("step_rows", "property_masks"):
        if getattr(tensor, kernel, None) is None:
            continue
        try:
            graph = graph_of(tensor, kernel, batch)
        except Exception:  # noqa: BLE001 - JX000 already covers it
            continue
        hooks = _Hooks(kernel)
        try:
            Interp(hooks=hooks, row_domain=domain).run(graph)
            hooks.finish()
        except Exception as e:  # noqa: BLE001 - a crash is never clean
            findings.append(AuditFinding(
                "JX200", Severity.WARNING, kernel,
                f"sanitizer pass crashed ({type(e).__name__}: {e}); this "
                "kernel's indices are UNCHECKED -- treat every site as "
                "undecided and use checked mode; please report the crash",
            ))
            summary.setdefault("crashed", []).append(kernel)
            continue
        findings.extend(hooks.findings)
        summary["sites"] += hooks.sites
        summary["proved"] += hooks.proved
        summary["undecided"] += hooks.undecided
        summary["dead_branches"] += hooks.dead_branches
        summary["kernels"][kernel] = {
            "sites": hooks.sites, "proved": hooks.proved,
            "undecided": hooks.undecided,
        }
    summary["rules"] = sorted({f.rule_id for f in findings})
    summary["clean"] = not any(f.severity == Severity.ERROR
                               for f in findings)
    try:
        tensor._sanitizer_cache = (tuple(findings), dict(summary))
    except Exception:  # noqa: BLE001 - __slots__ twins
        pass
    report.extend(findings)
    report.metrics["sanitizer"] = summary
