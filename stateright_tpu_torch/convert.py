"""Carry the JAX engine's state across: snapshots in, snapshots out.

A JAX-engine snapshot (``stateright_tpu``'s
``TpuChecker._carry_to_snapshot``) is a dict of numpy arrays under
``SNAPSHOT_KEYS`` — ``uint64`` tables and queue, ``uint32`` queue ebits
and depths, and scalar cursors and counters — plus ``cap``, ``qcap``,
``batch`` and ``cand``.  The port's carry is a list of tensors in the same
order, with every 64-bit word an int64 bit pattern (``ops/hashing.py``),
the 32-bit queue lanes as int32 and the scalars as 0-d int64.
:func:`carry_from_snapshot` and :func:`carry_to_snapshot` are inverses: a
port run resumes from a JAX snapshot and a JAX run from a port snapshot.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

# carry layout (the JAX engine's ``_TFP.._STATUS``)
(TFP, TPL, QROWS, QFP, QEBITS, QDEPTH, HEAD, TAIL, UNIQUE, SCOUNT, DISC,
 MAXDEPTH, STATUS) = range(13)
SNAPSHOT_KEYS = (
    "table_fp", "table_parent", "q_rows", "q_fp", "q_ebits",
    "q_depth", "head", "tail", "unique", "scount", "disc", "maxdepth",
    "status",
)
QUEUE = (QROWS, QFP, QEBITS, QDEPTH)
# numpy dtypes of the JAX layout, and the bit-compatible torch dtype
_NP_DTYPES = (
    np.uint64, np.uint64, np.uint64, np.uint64, np.uint32, np.uint32,
    np.int32, np.int32, np.int64, np.int64, np.uint64, np.int32, np.int32,
)
_SIGNED = {np.dtype(np.uint64): np.int64, np.dtype(np.uint32): np.int32}


def _tensor(arr: np.ndarray, device) -> torch.Tensor:
    """A fresh tensor (never sharing the caller's memory: the engine
    updates its carry in place) holding ``arr``'s bits."""
    arr = np.array(arr, copy=True, order="C")
    signed = _SIGNED.get(arr.dtype)
    if signed is not None:
        arr = arr.view(signed)
    t = torch.from_numpy(arr)
    if t.dim() == 0:
        t = t.to(torch.int64)
    return t.to(device)


def repad_queue(carry_np: list, qalloc: int) -> None:
    """Pad (EMPTY/0 fill) or truncate the numpy queue buffers to ``qalloc``
    rows, in place (``stateright_tpu``'s ``_repad_queue``)."""
    for i in QUEUE:
        arr = np.asarray(carry_np[i])
        if arr.shape[0] < qalloc:
            pad_shape = (qalloc - arr.shape[0],) + arr.shape[1:]
            fill = np.iinfo(arr.dtype).max if i == QFP else 0
            arr = np.concatenate([arr, np.full(pad_shape, fill, arr.dtype)])
        carry_np[i] = arr[:qalloc]


def carry_to_arrays(carry: list) -> list:
    """The port's carry as numpy arrays in the JAX layout and dtypes."""
    out = []
    for t, dt in zip(carry, _NP_DTYPES):
        arr = t.detach().cpu().numpy()
        if arr.ndim:
            arr = arr.view(dt)  # same width: int64 -> uint64, int32 -> uint32
        else:
            arr = np.asarray(arr).astype(dt)
        out.append(arr)
    return out


def carry_from_arrays(arrs: list, device,
                      qalloc: Optional[int] = None) -> list:
    """Numpy arrays in the JAX layout -> the port's carry on ``device``,
    queue buffers re-padded to ``qalloc`` rows (default: as given)."""
    arrs = [np.asarray(a) for a in arrs]
    if qalloc is None:
        qalloc = arrs[QFP].shape[0]
    repad_queue(arrs, qalloc)
    return [_tensor(a, device) for a in arrs]


def carry_from_snapshot(snap: dict, device, qalloc: Optional[int] = None):
    """A JAX-engine (or port) snapshot -> the port's carry on ``device``."""
    return carry_from_arrays([snap[k] for k in SNAPSHOT_KEYS], device, qalloc)


def carry_to_snapshot(carry: list, cap: int, qcap: int, batch: int,
                      cand: int, **extra) -> dict:
    """The port's carry -> a snapshot in the JAX engine's layout
    (``extra`` adds manifest keys such as ``model_sig``)."""
    snap = dict(zip(SNAPSHOT_KEYS, carry_to_arrays(carry)))
    snap.update(cap=cap, qcap=qcap, batch=batch, cand=cand, **extra)
    return snap
