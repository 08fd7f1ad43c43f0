"""The block loop on the device: JAX's ``lax.while_loop`` and its ``cond``
(``stateright_tpu/parallel/wavefront.py:701-710``, ``:748-751``) as one
CUDA graph an engine (kernel ``csrc/block_loop.cu``).

The JAX engine compiles a block of ``steps_per_call`` steps into one
program that stops on the device.  The port's engine issued its step from
Python ``steps`` times a block, every step after the stop a no-op.  On a
CUDA device :class:`BlockGraph` captures the engine's step once (torch's
capture, on a side stream, ``keep_graph=True``), and ``srt_block_graph_create``
wraps the captured graph in a conditional WHILE node whose condition
the ``srt_block_cond`` kernel sets:

    [cond, k = 0] -> WHILE { step -> copy-back -> [cond] }

so a block is one graph launch, and no step runs after ``cond`` turns
false.  The step reads its inputs from the engine's static carry (the
carry the first block was given, adopted) and must leave the next
iteration's inputs there: the table and queue are written in place by the
kernels; every carry entry the step *replaces* (head, tail, the counters,
the discoveries, the status, the optional tail's words) is copied back
into its static tensor at the end of the captured body.

:func:`block_cond_plain` is the cond's plain version: the engine's
``go_of`` and ``k < steps``.  On the CPU the engine runs its eager loop
(``_Engine._run_steps``), which evaluates it once a step.

Launches: a capture runs no kernel, so the wrappers called inside it
count into the capture's tally (``_cuda.capture_tally``), and
:meth:`BlockGraph.account` adds the tally times the block's executed
steps ``k`` after the host read them, and ``1 + k`` cond launches.  A
failure to capture, instantiate or launch raises: there is no fallback
to the eager loop.
"""

from __future__ import annotations

import ctypes
import time
from typing import NamedTuple, Optional

import torch

from . import _cuda

_STATUS_OK = 0

# Why a block-graph engine is traced on the CPU only (the scoped
# profiler's ``cuda_off``): with CUPTI's kernel tracing on
# (``torch.profiler``'s CUDA activity), kernels run inside a conditional
# WHILE body fault the device with an illegal address once a session has
# traced about 349,000 of them, whatever the body's size, the iterations a
# launch or the kernels' grids (H100, NVIDIA 580.159.03, torch
# 2.11.0+cu128).  The same step graph launched without the conditional
# node, and the block graph without CUPTI, run clean.  ``profile_run.py``
# traces a run on the device only below ``CUPTI_KERNEL_BUDGET`` body
# kernels.
CUPTI_FAULT = ("block graph: CUPTI kernel tracing inside a conditional "
               "WHILE body faults the device (illegal address)")
CUPTI_KERNEL_BUDGET = 320_000


class CondInputs(NamedTuple):
    """What ``cond`` reads of a carry: the 0-d int64 head, tail, unique
    count and status, the discoveries (int64[P], None when the model has
    no property), the checked error word (0-d bool, None unless
    ``.checked()``) and the run's target (None: no target)."""

    head: torch.Tensor
    tail: torch.Tensor
    unique: torch.Tensor
    status: torch.Tensor
    disc: Optional[torch.Tensor]
    err: Optional[torch.Tensor]
    target: Optional[int]


def block_go(x: CondInputs) -> torch.Tensor:
    """JAX's ``cond`` without its ``k < steps`` term (0-d bool): the
    status is OK, the queue is not empty, some property is undiscovered,
    the target is not reached and no checked batch failed."""
    all_disc = ((x.disc != 0).all() if x.disc is not None
                else torch.zeros((), dtype=torch.bool, device=x.status.device))
    go = (x.status == _STATUS_OK) & (x.tail > x.head) & ~all_disc
    if x.target is not None:
        go &= x.unique < x.target
    if x.err is not None:
        go &= ~x.err
    return go


def block_cond_plain(x: CondInputs, k: torch.Tensor, steps: int) -> tuple:
    """The cond's plain version: ``(go, k + go)`` with ``go = block_go(x)
    & (k < steps)``; ``k`` is the block's int64[1] step counter."""
    go = block_go(x) & (k < steps)
    return go, k + go.to(k.dtype)


def _cond_args(x: CondInputs) -> tuple:
    """The kernel's pointer arguments for ``x`` (head .. err)."""
    return (x.head.data_ptr(), x.tail.data_ptr(), x.unique.data_ptr(),
            x.status.data_ptr(),
            x.disc.data_ptr() if x.disc is not None else None,
            int(x.disc.numel()) if x.disc is not None else 0,
            x.err.data_ptr() if x.err is not None else None,
            -1 if x.target is None else int(x.target))


def block_cond(x: CondInputs, k: torch.Tensor, steps: int,
               reset: bool = False) -> tuple:
    """One evaluation of the cond by the ``srt_block_cond`` kernel outside a
    graph (on a CPU tensor, :func:`block_cond_plain`): ``(go, k')``, go
    bool[1] and ``k'`` the counter after it (``reset``: counted from 0,
    the graph's first evaluation of a block)."""
    if reset:
        k = torch.zeros_like(k)
    if x.status.device.type != "cuda":
        return block_cond_plain(x, k, steps)
    for t, name in ((x.head, "head"), (x.tail, "tail"),
                    (x.unique, "unique"), (x.status, "status")):
        _cuda.require(t, name, torch.int64, 0, x.status.device)
    kout = k.clone()
    _cuda.require(kout, "k", torch.int64, 1, x.status.device, 1)
    go = torch.empty(1, dtype=torch.uint8, device=x.status.device)
    _cuda.check("block_cond", _cuda.library().srt_block_cond(
        *_cond_args(x), int(steps), kout.data_ptr(), int(reset),
        go.data_ptr(), _cuda.stream_of(kout)))
    _cuda.count_launch(block_cond)
    return go.bool(), kout


block_cond.launches = 0


def _end_quietly(graph) -> None:
    """End a capture that an exception cut short (its own error is the
    one worth raising)."""
    try:
        graph.capture_end()
    except Exception:  # noqa: BLE001 - the step's exception propagates
        pass


def _copy_back(static: list, out: list) -> list:
    """Copy every entry the step replaced into its static tensor (inside
    the capture); returns their indices.  An output that shares a static
    tensor's storage is cloned first, so every copy reads the step's
    value and not one an earlier copy wrote."""
    ptrs = {t.data_ptr() for t in static if t.numel()}
    moved = []
    for i, (s, o) in enumerate(zip(static, out)):
        if o is s:
            continue
        if o.shape != s.shape or o.dtype != s.dtype:
            raise RuntimeError(
                f"block graph: the step changed carry entry {i} from "
                f"{s.dtype}{tuple(s.shape)} to {o.dtype}{tuple(o.shape)}")
        moved.append((i, o.clone() if o.numel() and o.data_ptr() in ptrs
                      else o))
    for i, o in moved:
        static[i].copy_(o)
    return [i for i, _ in moved]


def _adopt(carry: list) -> list:
    """The carry's tensors as the static carry; an entry that shares
    storage with an earlier one is cloned, so each copy-back has a
    tensor of its own."""
    static, seen = [], set()
    for t in carry:
        if t.numel() and (t.data_ptr() in seen or not t.is_contiguous()):
            t = t.clone()
        if t.numel():
            seen.add(t.data_ptr())
        static.append(t)
    return static


def _pool_bytes(pool) -> int:
    """Bytes of the caching allocator's segments in the private pool
    ``pool`` (a graph's)."""
    want = tuple(pool)
    return sum(int(s["total_size"]) for s in torch.cuda.memory_snapshot()
               if tuple(s.get("segment_pool_id", ())) == want)


class BlockGraph:
    """One engine's block as an instantiated CUDA graph (module
    docstring).  ``engine`` gives ``step(c)``, ``stream`` (the raw stream
    its kernels go to, retargeted to the capture's side stream while it
    captures), ``cond_inputs(c)``, ``steps`` and ``warm(c)``; ``carry`` is
    the first block's carry, adopted as the static carry.  Raises when
    the capture, the instantiation or a launch fails."""

    def __init__(self, engine, carry: list):
        dev = carry[0].device
        self.device = dev
        self.static = _adopt(carry)
        self.k = torch.zeros(1, dtype=torch.int64, device=dev)
        t0 = time.perf_counter()
        # per-device caches the step builds lazily (a host-to-device copy
        # from numpy) are built here, outside the capture, by one eager
        # step that the stopped status makes a no-op on the carry
        engine.warm(self.static)
        torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        try:
            self.graph, self.replaced, tally = self._capture(engine)
        except torch.OutOfMemoryError:
            # the capture's pool takes segments of its own, and a capture
            # cannot free the allocator's cached ones to make room: free
            # them (as torch.cuda.graph does before every capture) and
            # capture again
            torch.cuda.empty_cache()
            self.graph, self.replaced, tally = self._capture(engine)
        self.tally = tally
        t2 = time.perf_counter()
        x = engine.cond_inputs(self.static)
        ptrs = _cond_args(x)
        graph, exec_ = ctypes.c_void_p(), ctypes.c_void_p()
        nodes = ctypes.c_int64()
        self._graph = self._exec = None
        _cuda.check("block_graph_create",
                    _cuda.library().srt_block_graph_create(
                        self.graph.raw_cuda_graph(), *ptrs, int(engine.steps),
                        self.k.data_ptr(), ctypes.byref(graph),
                        ctypes.byref(exec_), ctypes.byref(nodes)))
        self._graph, self._exec = graph.value, exec_.value
        self.nodes = int(nodes.value)
        t3 = time.perf_counter()
        self.warm_secs, self.capture_secs = t1 - t0, t2 - t1
        self.instantiate_secs = t3 - t2
        self.pool_bytes = _pool_bytes(self.graph.pool())
        # whether the engine's owner has recorded this capture
        self.reported = False

    def _capture(self, engine) -> tuple:
        """The step captured on a side stream into a kept graph, every
        replaced entry copied back into the static carry; returns the
        graph, the replaced indices and the launches the capture
        recorded."""
        dev = self.device
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        cur = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(cur)
        frozen = engine.stream
        try:
            with torch.cuda.stream(side), _cuda.capture_tally() as tally:
                if frozen is not None:
                    engine.stream = side.cuda_stream
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    replaced = _copy_back(self.static,
                                          engine.step(list(self.static)))
                except BaseException:
                    _end_quietly(graph)
                    raise
                graph.capture_end()
        finally:
            engine.stream = frozen
        cur.wait_stream(side)
        return graph, replaced, tally

    def record(self) -> dict:
        """The capture's costs: seconds of the warm step, the capture and
        the instantiation, the step graph's node count, the launches a
        step records and the private pool's bytes."""
        return {"warm_secs": self.warm_secs, "capture_secs": self.capture_secs,
                "instantiate_secs": self.instantiate_secs,
                "nodes": self.nodes, "pool_bytes": self.pool_bytes,
                "replaced": list(self.replaced),
                "launches_per_step": {w.__name__: n
                                      for w, n in self.tally.items()}}

    def run(self, carry: list) -> tuple:
        """One block: the entries of ``carry`` that are not the static
        ones are copied in, then the graph is launched on the current
        stream.  Returns ``(static carry, k)``, ``k`` the int64[1] count
        of steps executed, on the device."""
        if len(carry) != len(self.static):
            raise ValueError(f"block graph: a carry of {len(carry)} entries, "
                             f"expected {len(self.static)}")
        for i, (s, t) in enumerate(zip(self.static, carry)):
            if t is s or (t.numel() and t.data_ptr() == s.data_ptr()):
                continue
            if t.shape != s.shape or t.dtype != s.dtype:
                raise ValueError(
                    f"block graph: carry entry {i} is {t.dtype}"
                    f"{tuple(t.shape)}, expected {s.dtype}{tuple(s.shape)}")
            s.copy_(t)
        stream = torch.cuda.current_stream(self.device).cuda_stream
        _cuda.check("block_graph_launch",
                    _cuda.library().srt_block_graph_launch(self._exec, stream))
        return list(self.static), self.k

    def account(self, k: int) -> None:
        """Count the launches of a block that executed ``k`` steps: each
        captured wrapper's launches a step times ``k``, and the cond's
        ``1 + k``."""
        for wrapper, n in self.tally.items():
            _cuda.count_launch(wrapper, n * k)
        _cuda.count_launch(block_cond, 1 + k)

    def __del__(self):
        exec_, graph = getattr(self, "_exec", None), getattr(self, "_graph",
                                                             None)
        if exec_ is None and graph is None:
            return
        try:
            _cuda.library().srt_block_graph_destroy(graph, exec_)
        except Exception:  # noqa: BLE001 - never raise under GC
            pass

