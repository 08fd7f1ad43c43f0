"""Carry the JAX engine's state across: snapshots in, snapshots out.

A sweep snapshot (``stateright_tpu``'s ``SweepChecker._carry_to_snapshot``,
``sweep/engine.py``) has the keys of :data:`SWEEP_SNAPSHOT_KEYS`, with the
instance tags (``q_tag``) and per-instance counters, plus the manifest
keys ``cohort``, ``engine``, ``model_sig``, ``sweep_done`` and, with
cartography, ``cart_depth_base``; :func:`sweep_carry_to_arrays` and
:func:`sweep_carry_from_arrays` carry it across both ways.

A sharded snapshot (``ShardedTpuChecker._carry_to_snapshot``,
``parallel/sharded.py``) has the keys of :data:`SHARDED_SNAPSHOT_KEYS`
(the shards' tables and frontiers laid out shard after shard) plus its
manifest; :func:`sharded_carry_to_arrays` and
:func:`sharded_carry_from_arrays` carry it across both ways.

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


# the sweep engine's carry (the JAX sweep engine's ``_TFP.._STATUS``,
# stateright_tpu/sweep/engine.py:77-79) and its snapshot keys
(S_TFP, S_TPL, S_QROWS, S_QFP, S_QTAG, S_QEBITS, S_QDEPTH, S_HEAD, S_TAIL,
 S_UNIQK, S_SCNTK, S_DISC, S_MAXDK, S_STATUS) = range(14)
SWEEP_SNAPSHOT_KEYS = (
    "table_fp", "table_parent", "q_rows", "q_fp", "q_tag", "q_ebits",
    "q_depth", "head", "tail", "unique_k", "scount_k", "disc",
    "maxdepth_k", "status",
)
SWEEP_QUEUE = (S_QROWS, S_QFP, S_QTAG, S_QEBITS, S_QDEPTH)
_SWEEP_NP_DTYPES = (
    np.uint64, np.uint64, np.uint64, np.uint64, np.uint32, np.uint32,
    np.uint32, np.int32, np.int32, np.int64, np.int64, np.uint64, np.int32,
    np.int32,
)


# the sharded engine's carry (JAX ``_SHARDED_SNAPSHOT_KEYS``,
# stateright_tpu/parallel/sharded.py:641-644): the shards' tables and
# frontiers laid out shard after shard, then the replicated scalars; the
# manifest adds ``more``, ``ndev``, ``cap_local``, ``fcap_local``,
# ``bucket_factor``, ``cand_factor``, ``engine``, ``model_sig``,
# ``run_id``, ``footprint_bytes`` and, under their flags, ``por_stats`` and
# the cartography counters ``cart0``..``cart5``
(SH_TFP, SH_TPL, SH_ROWS, SH_FPS, SH_EBITS, SH_UNIQUE, SH_SCOUNT, SH_DISC,
 SH_DEPTH, SH_STATUS) = range(10)
SHARDED_SNAPSHOT_KEYS = (
    "table_fp", "table_parent", "rows", "fps", "ebits",
    "unique", "scount", "disc", "depth", "status",
)
SHARDED_NP_DTYPES = (
    np.uint64, np.uint64, np.uint64, np.uint64, np.uint32, np.int64,
    np.int64, np.uint64, np.int32, np.int32,
)


def sharded_carry_to_arrays(carry: list) -> list:
    """The sharded engine's carry (its first ten tensors) as numpy arrays
    in the JAX layout and dtypes, never sharing the carry's memory."""
    arrs = carry_to_arrays(carry[:len(SHARDED_SNAPSHOT_KEYS)],
                           SHARDED_NP_DTYPES)
    if carry[SH_TFP].device.type == "cpu":
        arrs = [np.array(a, copy=True) for a in arrs]
    return arrs


def sharded_carry_from_arrays(arrs: list, device) -> list:
    """Numpy arrays in the JAX sharded layout -> the sharded engine's
    first ten carry tensors on ``device`` (scalars 0-d int64)."""
    return [signed_tensor(np.asarray(a), device) for a in arrs]


def signed_tensor(arr: np.ndarray, device) -> torch.Tensor:
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


def repad_queue(carry_np: list, qalloc: int, queue=QUEUE,
                fp_index: int = QFP) -> None:
    """Pad (EMPTY/0 fill) or truncate the numpy queue buffers to ``qalloc``
    rows, in place (``stateright_tpu``'s ``_repad_queue``); ``queue`` and
    ``fp_index`` name the buffers of another layout (the sweep's)."""
    for i in queue:
        arr = np.asarray(carry_np[i])
        if arr.shape[0] < qalloc:
            pad_shape = (qalloc - arr.shape[0],) + arr.shape[1:]
            fill = np.iinfo(arr.dtype).max if i == fp_index else 0
            arr = np.concatenate([arr, np.full(pad_shape, fill, arr.dtype)])
        carry_np[i] = arr[:qalloc]


def carry_to_arrays(carry: list, dtypes=_NP_DTYPES) -> list:
    """The port's carry as numpy arrays in the JAX layout and dtypes."""
    out = []
    for t, dt in zip(carry, dtypes):
        arr = t.detach().cpu().numpy()
        if arr.ndim and arr.dtype.itemsize == np.dtype(dt).itemsize:
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
    return [signed_tensor(a, device) for a in arrs]


def carry_from_snapshot(snap: dict, device, qalloc: Optional[int] = None):
    """A JAX-engine (or port) snapshot -> the port's carry on ``device``."""
    return carry_from_arrays([snap[k] for k in SNAPSHOT_KEYS], device, qalloc)


def carry_to_snapshot(carry: list, cap: int, qcap: int, batch: int,
                      cand: int, cart_depth_base=None, **extra) -> dict:
    """The port's carry -> a snapshot in the JAX engine's layout
    (``extra`` adds manifest keys such as ``model_sig``).  The snapshot
    never shares memory with the carry: on the CPU ``.numpy()`` would alias
    the tensors, which a running engine updates in place.
    ``cart_depth_base`` is the cartography depth bank (the depth lanes of
    queue prefixes growth reclaimed, JAX wavefront.py:1896-1900): without
    it a resumed depth histogram forgets every state popped before a
    pre-snapshot growth."""
    arrs = carry_to_arrays(carry[:len(SNAPSHOT_KEYS)])
    if carry[TFP].device.type == "cpu":
        arrs = [a.copy() for a in arrs]
    snap = dict(zip(SNAPSHOT_KEYS, arrs))
    snap.update(cap=cap, qcap=qcap, batch=batch, cand=cand, **extra)
    if cart_depth_base is not None:
        snap["cart_depth_base"] = np.array(cart_depth_base, np.int64)
    return snap


# the spill tier's pending buffers in a snapshot (JAX wavefront.py:1920-
# 1932): key suffix and the JAX dtype of each
PEND_KEYS = (("fp", np.uint64), ("rows", np.uint64), ("parent", np.uint64),
             ("ebits", np.uint32), ("depth", np.uint32))


def pend_to_snapshot(pend: list, n: int) -> dict:
    """The first ``n`` entries of the spill tier's pending buffers (device
    tensors in :data:`PEND_KEYS` order) as ``spill_pend_*`` snapshot
    arrays in the JAX layout, copied off the device."""
    return {f"spill_pend_{k}": t[:n].cpu().numpy().view(dt).copy()
            for (k, dt), t in zip(PEND_KEYS, pend)}


def pend_from_snapshot(snap: dict, cap: int) -> Optional[dict]:
    """A snapshot's pending entries (at most ``cap``) as numpy arrays
    under :data:`PEND_KEYS`'s names, or None when it holds none."""
    if "spill_pend_fp" not in snap:
        return None
    n = min(int(np.asarray(snap["spill_pend_fp"]).shape[0]), cap)
    return {k: np.asarray(snap[f"spill_pend_{k}"], dt)[:n]
            for k, dt in PEND_KEYS}


def cart_depth_base(snap: dict) -> Optional[np.ndarray]:
    """A snapshot's cartography depth bank as a fresh int64 array, or None
    (JAX wavefront.py:1961-1963): either engine's snapshot resumes with
    ``sum(depth_hist) == unique``."""
    base = snap.get("cart_depth_base")
    return None if base is None else np.array(base, np.int64)


def sweep_carry_to_arrays(carry: list) -> list:
    """The sweep engine's carry as numpy arrays in the JAX sweep layout
    (a fresh copy: never the engine's own memory)."""
    arrs = carry_to_arrays(carry[:len(SWEEP_SNAPSHOT_KEYS)], _SWEEP_NP_DTYPES)
    if carry[S_TFP].device.type == "cpu":
        arrs = [np.array(a, copy=True) for a in arrs]
    return arrs


def sweep_carry_from_arrays(arrs: list, device,
                            qalloc: Optional[int] = None) -> list:
    """Numpy arrays in the JAX sweep layout -> the sweep engine's carry on
    ``device`` (scalars and per-instance counters int64), queue buffers
    re-padded to ``qalloc`` rows (default: as given)."""
    arrs = [np.asarray(a) for a in arrs]
    if qalloc is not None:
        repad_queue(arrs, qalloc, SWEEP_QUEUE, S_QFP)
    out = [signed_tensor(a, device) for a in arrs]
    out[S_MAXDK] = out[S_MAXDK].to(torch.int64)
    return out
