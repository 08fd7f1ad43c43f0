"""Checked execution mode: the sanitizer's dynamic guard.

The port's counterpart of the dynamic half of
``stateright_tpu/analysis/sanitizer.py`` (``CheckedExecutionError``,
:516; ``checkify_kernels``, :535; ``error_flag``, :551;
``localize_checked_failure``, :576).  The static half (the interval pass
and its JX2xx rules) comes with the ROADMAP item "the analysis stack".

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

# the guarded operations, by overload packet with the in-place underscore
# dropped: ``index``/``index_put`` take a list of indices at position 1,
# one per dimension; the others ``(self, dim, index, ...)``, mapped to
# whether a negative index is valid
_INDEX_LIST_OPS = {"index", "index_put", "_index_put_impl"}
_DIM_INDEX_OPS = {
    "index_select": False, "gather": False, "scatter": False,
    "scatter_add": False, "scatter_reduce": False, "index_add": False,
    "index_copy": False, "index_fill": True,
}
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
        kind = ("list" if op in _INDEX_LIST_OPS else
                "take" if op == "take" else
                "dim" if op in _DIM_INDEX_OPS else
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
