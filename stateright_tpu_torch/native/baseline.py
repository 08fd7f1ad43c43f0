"""The compiled-CPU wavefront baseline: ``compiled_cpu_bfs``.

The port's own copy of ``stateright_tpu/native/baseline.py``.  A
single-core BFS over the model's packed tensor rows: successor generation
and property evaluation are the twin's own ``step_rows`` and
``property_masks`` (with ``boundary_rows`` where the twin has one), run
as PyTorch on the CPU at one fixed batch shape (JAX :72-96 runs them
under an XLA-CPU ``jit``), while the visited set and the FIFO queue run
natively in C++ (``bfs.cpp``).  It is the honest denominator for a
device-versus-CPU rate: a pure-Python BFS flatters the device engine by
however slow CPython's per-state loop is.

Returns None when the native module is unavailable (no compiler) or the
model has no tensor twin.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from . import load


def _tensor_of(model):
    cached = getattr(model, "_tensor_cached", None)
    try:
        return cached() if cached is not None else (
            getattr(model, "tensor_model", lambda: None)())
    except Exception:  # noqa: BLE001 - a twin that fails: no baseline
        return None


def compiled_cpu_bfs(model, target: Optional[int] = None,
                     batch: int = 1024) -> Optional[dict]:
    """Single-core compiled BFS over ``model``'s tensor twin.

    ``target`` stops at a clean batch boundary once that many unique
    states are visited (None: exhaust), as the engines' target does, so
    prefix rates compare.  Returns ``{states, unique, wavefronts, secs,
    states_per_sec}``, or None when the native module or the twin is
    missing.

    Work parity per batch: the expansion evaluates the property masks too
    (the engines do, per popped batch) and applies the same boundary
    filter to successors, so the counts follow the engines' ``scount``
    and ``unique`` conventions exactly.  Dedup is on the full row bytes.
    """
    mod = load()
    if mod is None or not hasattr(mod, "bfs_run"):
        return None
    tensor = _tensor_of(model)
    if tensor is None:
        return None
    width, arity = tensor.width, tensor.max_actions
    boundary_fn = (tensor.boundary_rows
                   if getattr(tensor, "has_boundary", False) else None)

    @torch.inference_mode()
    def kernel(rows: torch.Tensor):
        succ, valid = tensor.step_rows(rows)
        if boundary_fn is not None:
            valid = valid & boundary_fn(succ)
        masks = tensor.property_masks(rows)  # evaluated for work parity
        return succ, valid, masks.any()

    init_rows = np.ascontiguousarray(
        np.asarray(tensor.init_rows(), dtype=np.uint64))
    n_init = init_rows.shape[0]
    pad_row = init_rows[0] if n_init else np.zeros((width,), np.uint64)

    def expand(buf: bytes, k: int):
        rows = np.frombuffer(buf, dtype=np.uint64).reshape(k, width)
        # one batch shape for the whole run; a writable copy either way
        # (the callback's bytes are immutable)
        rows = np.concatenate(
            [rows, np.broadcast_to(pad_row, (batch - k, width))])
        succ, valid, _ = kernel(torch.from_numpy(rows.view(np.int64)))
        return (np.ascontiguousarray(succ.numpy().view(np.uint64)),
                np.ascontiguousarray(valid.numpy()))

    # warm-up outside the timed window (the rate is a steady-state claim)
    kernel(torch.from_numpy(np.ascontiguousarray(
        np.broadcast_to(pad_row, (batch, width))).view(np.int64)))
    t0 = time.monotonic()
    states, unique, wavefronts = mod.bfs_run(
        expand, init_rows, n_init, width, arity, batch, int(target or 0))
    secs = max(time.monotonic() - t0, 1e-9)
    return {
        "states": int(states),
        "unique": int(unique),
        "wavefronts": int(wavefronts),
        "secs": round(secs, 4),
        "states_per_sec": round(states / secs, 1),
    }
