"""Captured aten graphs of a twin's kernels: what the graph passes walk.

The port's counterpart of the JAX package's tracing helpers: the
``jax.make_jaxpr`` trace of ``analysis/footprint.py::_trace`` and
``analysis/interval.py``'s ``aval_of``, ``is_literal`` and
``producers_of``.  A kernel (``step_rows``, ``property_masks``,
``boundary_rows``) is captured with
``torch.fx.experimental.proxy_tensor.make_fx`` over
``torch.func.functionalize``, so the graph holds pure aten operations (an
in-place ``clamp_`` becomes ``clamp``, an indexed write a ``*_scatter``)
and every value is one node.  In an fx graph a node is its own producer:
``node.target`` and ``node.args`` are the JAX equation's primitive and
invars, and ``node.users`` the consumers.  What the walks share
(``footprint.py``, ``kernel_audit.py``, ``interval.py``, ``sanitizer.py``
and ``costmodel.py``): :func:`walk_back` through :data:`TRANSPARENT`
(JAX ``walk_transparent``), :func:`literal_value` (JAX
``IVal.const(x.val)`` of a literal) and :func:`capture_fresh`, a second
capture past the cache (the retrace diff of ``JX104``).

The capture runs on real tensors, not abstract values: the rows are the
twin's init rows, tiled to the batch.  As in JAX (``footprint.py:1131``),
``init_rows()`` and one eager ``step_rows`` (and ``property_masks``) run
first, outside the capture, so a twin that builds its device constants lazily builds them as
real tensors (a constant built inside the capture would be a traced
value, cached on the twin).  The graphs are cached per twin, kernel, batch
and device.
"""

from __future__ import annotations

import contextlib
import operator
import threading
from typing import Optional

import numpy as np
import torch

from ..parallel.prewarm import build_site

# operations whose value needs no input row: a literal of the JAX jaxpr (a
# Python scalar broadcast to a shape), by a fill value
_FILLS = {
    "scalar_tensor": 0, "full": 1, "full_like": 1, "new_full": 1,
}
_ZERO_FILLS = ("zeros", "zeros_like", "new_zeros", "empty", "empty_like",
               "new_empty")
_ONE_FILLS = ("ones", "ones_like", "new_ones")

# shape-only operations a walk back looks through (JAX ``_TRANSPARENT``:
# reshape, broadcast_in_dim, squeeze, convert_element_type, copy,
# expand_dims)
TRANSPARENT = frozenset({
    "view", "reshape", "_unsafe_view", "expand", "squeeze", "unsqueeze",
    "_to_copy", "clone", "alias", "detach", "lift_fresh_copy", "contiguous",
    "to",
})


def op_name(node) -> str:
    """The aten operation's name without its overload (``bitwise_and``),
    ``getitem`` for a tuple pick, the fx op for the rest (``placeholder``,
    ``get_attr``, ``output``)."""
    if not isinstance(node, torch.fx.Node):
        return "literal"
    if node.op != "call_function":
        return node.op
    t = node.target
    if t is operator.getitem:
        return "getitem"
    pkt = getattr(t, "_overloadpacket", None)
    return getattr(pkt, "__name__", str(t)) if pkt is not None else str(t)


def fill_value(node) -> Optional[float]:
    """The fill of a constant-creating node (``full``, ``zeros``,
    ``scalar_tensor``, ...), or None for any other node."""
    name = op_name(node)
    if name in _ZERO_FILLS:
        return 0
    if name in _ONE_FILLS:
        return 1
    if name in _FILLS:
        v = node.args[_FILLS[name]] if len(node.args) > _FILLS[name] else None
        return v if isinstance(v, (bool, int, float)) else None
    return None


def is_literal(x) -> bool:
    """A value the kernel did not compute from its inputs: a Python scalar
    argument, or a node that fills a shape with one (JAX ``is_literal``: a
    jaxpr literal, which a broadcast takes to any shape)."""
    return not isinstance(x, torch.fx.Node) or fill_value(x) is not None


def shape_of(x) -> tuple:
    """The node's shape (``()`` for a scalar argument; JAX ``aval_of``)."""
    val = x.meta.get("val") if isinstance(x, torch.fx.Node) else None
    return tuple(int(s) for s in getattr(val, "shape", ()) or ())


def dtype_of(x):
    """The node's dtype, or None (a Python scalar, a tuple)."""
    val = x.meta.get("val") if isinstance(x, torch.fx.Node) else None
    return getattr(val, "dtype", None)


class Graph:
    """One captured kernel: the ``GraphModule``, its nodes in order, its
    first input (the rows) and its outputs, flattened."""

    def __init__(self, gm: torch.fx.GraphModule):
        self.gm = gm
        self.nodes = list(gm.graph.nodes)
        self.inputs = [n for n in self.nodes if n.op == "placeholder"]
        res = [n for n in self.nodes if n.op == "output"][0].args[0]
        self.outputs = list(res) if isinstance(res, (tuple, list)) else [res]

    def const_value(self, x) -> Optional[np.ndarray]:
        """The value of a graph constant (a ``get_attr`` tensor, through a
        ``lift_fresh_copy``/``clone``/``alias``) or of a Python scalar, as
        numpy; None for anything computed from the inputs."""
        if not isinstance(x, torch.fx.Node):
            return None if x is None else np.asarray(x)
        for _ in range(8):
            if x.op == "get_attr":
                v = getattr(self.gm, x.target)
                return v.detach().cpu().numpy() if isinstance(
                    v, torch.Tensor) else np.asarray(v)
            if op_name(x) in ("lift_fresh_copy", "clone", "alias", "detach"):
                x = x.args[0]
                continue
            return None
        return None


def walk_back(x, ops=TRANSPARENT, depth: int = 8):
    """Follow shape-only operations back from ``x`` (JAX
    ``walk_transparent``): the first node that is not one of ``ops``."""
    for _ in range(depth):
        if not isinstance(x, torch.fx.Node) or op_name(x) not in ops:
            return x
        x = x.args[0]
    return x


def literal_value(x) -> Optional[int]:
    """The exact integer of a literal: a Python int or bool argument, or a
    node that fills its shape with one (``full``, ``zeros``,
    ``scalar_tensor``, ...); None for anything else (a float fill too)."""
    if isinstance(x, bool):
        return int(x)
    if isinstance(x, int):
        return x
    v = fill_value(x) if isinstance(x, torch.fx.Node) else None
    if isinstance(v, bool):
        return int(v)
    if isinstance(v, int) or (isinstance(v, float) and v.is_integer()
                              and dtype_of(x) is not None
                              and not dtype_of(x).is_floating_point):
        return int(v)
    return None


def _tile_rows(init: np.ndarray, batch: int, width: int) -> np.ndarray:
    init = np.asarray(init, np.uint64).reshape(-1, width)
    if init.shape[0] == 0:
        return np.zeros((batch, width), np.uint64)
    return init[np.arange(batch) % init.shape[0]]


class _InplaceOps(torch.overrides.TorchFunctionMode):
    """Routes ``x |= y`` and kin to the named in-place operation
    (``bitwise_or_``): ``aten::__ior__`` returns an alias, which
    ``functionalize`` refuses, while ``bitwise_or_`` it rewrites."""

    _NAMED = {
        torch.Tensor.__ior__: torch.Tensor.bitwise_or_,
        torch.Tensor.__iand__: torch.Tensor.bitwise_and_,
        torch.Tensor.__ixor__: torch.Tensor.bitwise_xor_,
        torch.Tensor.__ilshift__: torch.Tensor.bitwise_left_shift_,
        torch.Tensor.__irshift__: torch.Tensor.bitwise_right_shift_,
    }

    def __torch_function__(self, func, types, args=(), kwargs=None):
        return self._NAMED.get(func, func)(*args, **(kwargs or {}))


# ``make_fx`` keeps process-wide tracing state (the fx patcher), so two
# threads must not capture at once: the fleet's slots spawn engines, each
# with its own preflight capture, in parallel
_CAPTURE_LOCK = threading.RLock()


def capture(fn, *args) -> torch.fx.GraphModule:
    """``fn(*args)`` as an aten graph: ``make_fx`` over ``functionalize``
    (the bound method goes through a lambda: ``make_fx`` counts a bound
    method's ``self`` as an argument).  A host read of a tensor value
    (``.item()``, ``bool()`` of a tensor) is recorded in the graph as
    ``aten._local_scalar_dense`` rather than refused, so the kernel audit
    can name it (``JX101``).  One capture runs at a time in the process;
    its seconds are charged to the calling thread's compile counter
    (``parallel/prewarm.build_site``)."""
    import inspect

    from torch.fx.experimental.proxy_tensor import make_fx
    from torch.func import functionalize

    def run(*a):
        with _InplaceOps():
            return fn(*a)

    kw = {}
    if "_error_on_data_dependent_ops" in inspect.signature(
            make_fx).parameters:
        kw["_error_on_data_dependent_ops"] = False
    traced = make_fx(functionalize(run, remove="mutations"), **kw)
    with build_site(), _CAPTURE_LOCK, _one_fake_mode():
        return traced(*args)


@contextlib.contextmanager
def _one_fake_mode():
    """One ``FakeTensorMode`` for every node's ``meta['val']``: without an
    ambient one, ``make_fx`` builds a new mode per value it records, about
    half of a capture's time.  The same graph and metadata either way;
    a torch without these hooks captures the slow way."""
    try:
        from torch._guards import TracingContext, tracing
        from torch._subclasses.fake_tensor import FakeTensorMode

        ctx = tracing(TracingContext(FakeTensorMode(
            allow_fallback_kernels=True)))
    except Exception:  # noqa: BLE001 - the private hooks moved: no-op
        ctx = contextlib.nullcontext()
    with ctx:
        yield


def example_rows(tensor, batch: int, device="cpu") -> torch.Tensor:
    """``batch`` rows for a capture: the twin's init rows, tiled (int64
    bit patterns on ``device``).  Calls ``init_rows()`` and one eager
    ``step_rows`` and ``property_masks`` on them, outside any capture, so
    constants a kernel builds at its first call exist before the capture
    (else the first capture holds a ``lift_fresh_copy`` the second does
    not, and the retrace diff would call the kernel unstable)."""
    width = int(tensor.width)
    rows_np = _tile_rows(tensor.init_rows(), batch, width)
    rows = torch.from_numpy(rows_np.view(np.int64).copy()).to(device)
    tensor.step_rows(rows)
    if callable(getattr(tensor, "property_masks", None)):
        try:
            tensor.property_masks(rows)
        except Exception:  # noqa: BLE001 - its own capture reports it
            pass
    return rows


def capture_fresh(tensor, kernel: str, batch: int = 4,
                  device="cpu") -> Graph:
    """The twin's ``kernel`` captured anew, past :func:`graph_of`'s cache
    (the second capture of the retrace diff, ``JX104``)."""
    rows = example_rows(tensor, batch, device)
    fn = getattr(tensor, kernel)
    if kernel == "boundary_rows":
        succ, _ = tensor.step_rows(rows)
        return Graph(capture(fn, succ))
    return Graph(capture(fn, rows))


def graph_of(tensor, kernel: str, batch: int = 4, device="cpu") -> Graph:
    """The captured graph of the twin's ``kernel`` (``step_rows``,
    ``property_masks`` or ``boundary_rows``) at ``batch`` rows on
    ``device``, cached on the twin.  ``boundary_rows`` takes the
    successors of the example rows (``[B, A, W]``)."""
    cache = getattr(tensor, "_graph_cache", None)
    if cache is None:
        cache = {}
        try:
            tensor._graph_cache = cache
        except Exception:  # noqa: BLE001 - __slots__ twins
            pass
    key = (kernel, int(batch), str(torch.device(device)))
    g = cache.get(key)
    if g is None:
        g = cache[key] = capture_fresh(tensor, kernel, batch, device)
    return g
