"""Search-cartography reductions: cheap on-device counters for *how the
search is going*.

The port's counterpart of ``stateright_tpu/ops/cartography.py``: the same
counters, bins and snapshot schema, with the device functions in plain
PyTorch (they are XLA code in the JAX package, not Pallas kernels: a few
small reductions a step).  They fold into the GPU engine's step
(``parallel/wavefront.py``) as reductions over masks the step already
computes (the enabled-action mask, the live mask, the property masks), and
ride its packed stats tensor: no extra host read.

Contract: with cartography OFF the step dispatches exactly the operations
it did without the feature (pinned by test); ON, each step pays a couple
of column sums, and the depth histogram is derived once per block from
the queue's depth buffer (:func:`queue_depth_hist`).

Reconciliation invariants (pinned by ``tests/test_torch_cartography.py``):

 - ``sum(depth_hist) == unique`` — every fresh insert is counted exactly
   once, at the depth it was inserted (init states at depth 0);
 - ``sum(action_hist) == states - n_init`` — every generated successor is
   counted under its action slot (``states`` counts init states too);
 - with no early exit, ``prop_evaluated[i] == unique`` for every property
   (each unique row is popped and evaluated exactly once).

Growth replays never double-count: the depth histogram reads the queue
(an overflowed batch appended nothing), and the step counters are guarded
with the engine's other counters.
"""

from __future__ import annotations

import numpy as np
import torch

# Per-depth frontier bins.  BFS depths beyond the last bin clamp into it
# (the bin is then a ">= DEPTH_BINS-1" tail); 128 covers every bundled
# model's diameter with wide margin while keeping the per-step reduction
# and the stats-vector ride-along small.
DEPTH_BINS = 128

# Cartography snapshot schema version (the JSONL/report "v" field).
CARTOGRAPHY_V = 1


def cart_shapes(arity: int, n_props: int) -> tuple:
    """Carry-buffer shapes, in carry order: depth histogram, per-action
    successor counts, per-property evaluation / condition-hit tallies.
    Property arrays keep at least one lane so the carry stays non-empty
    (same convention as the engines' ``disc`` vector)."""
    p = max(n_props, 1)
    return ((DEPTH_BINS,), (max(arity, 1),), (p,), (p,))


def cart_carry_shapes(arity: int, n_props: int) -> tuple:
    """The GPU engine's carry-tail shapes: :func:`cart_shapes` WITHOUT the
    depth histogram, which the engine derives from its queue once a block
    (:func:`queue_depth_hist`) instead of paying a per-step counter."""
    return cart_shapes(arity, n_props)[1:]


def queue_depth_hist(qdepth: torch.Tensor, tail: torch.Tensor) -> torch.Tensor:
    """Per-depth fresh-insert histogram, derived from the queue:
    ``qdepth[:tail]`` holds the BFS depth of every unique state ever
    inserted (pops only advance ``head``), in FIFO order.  The JAX
    package's bounded binary search, step for step (``DEPTH_BINS`` searches
    with ``hi = tail``, ``qalloc.bit_length()`` rounds of gather and
    ``where``), so both engines give the same bins even where an append
    window straddles two BFS levels.  ``tail`` stays on the device: the
    search never reads it on the host, and lanes past ``tail`` (unsorted
    after a re-pad) are never compared.  Depths past the last bin clamp
    into it."""
    n = qdepth.shape[0]
    dev = qdepth.device
    vals = torch.arange(1, DEPTH_BINS + 1, dtype=qdepth.dtype, device=dev)
    lo = torch.zeros((DEPTH_BINS,), dtype=torch.int64, device=dev)
    hi = tail.to(torch.int64).expand(DEPTH_BINS)
    for _ in range(max(int(n).bit_length(), 1)):
        mid = (lo + hi) >> 1
        go = (mid < hi) & (qdepth[mid.clamp(max=n - 1)] < vals)
        lo = torch.where(go, mid + 1, lo)
        hi = torch.where(go, hi, mid)
    # lo[i] = #lanes with depth < i+1; diff -> per-bin counts, with the
    # >= DEPTH_BINS tail folded into the last bin
    hist = torch.diff(lo, prepend=lo.new_zeros(1))
    hist[-1] += tail.to(torch.int64) - lo[-1]
    return hist


def queue_depth_hist_exact(qdepth: torch.Tensor,
                           tail: torch.Tensor) -> torch.Tensor:
    """The exact per-depth count of ``qdepth[:tail]`` on the device, with
    no host read: what the JAX engine's host-side stats
    (``_stats_np``, a bincount) give at a sync that follows a growth or a
    resume, where its carry is on the host.  The port's engine reads this
    at those syncs so both engines' snapshots agree there too."""
    n = qdepth.shape[0]
    lane = torch.arange(n, device=qdepth.device)
    dep = torch.where(lane < tail, qdepth.clamp(max=DEPTH_BINS - 1).long(),
                      DEPTH_BINS)
    hist = torch.zeros((DEPTH_BINS + 1,), dtype=torch.int64,
                       device=qdepth.device)
    return hist.scatter_add_(0, dep, torch.ones_like(dep))[:DEPTH_BINS]


def queue_depth_hist_np(qdepth, tail: int) -> np.ndarray:
    """Host mirror of :func:`queue_depth_hist` (same clamp-into-last-bin
    semantics) for syncs served from a host-side carry."""
    dep = np.minimum(
        np.asarray(qdepth[: int(tail)], dtype=np.int64), DEPTH_BINS - 1
    )
    return np.bincount(dep, minlength=DEPTH_BINS).astype(np.int64)


def action_hist_delta(valid: torch.Tensor) -> torch.Tensor:
    """Per-action-slot generated-successor counts for one batch: a column
    sum of the ``[B, A]`` enabled-action mask the step already computed."""
    return valid.sum(dim=0, dtype=torch.int64)


def prop_tally_delta(live: torch.Tensor, masks: torch.Tensor, n_props: int):
    """(d_evals, d_hits) for one batch: rows evaluated (the live count,
    identical for every property) and rows whose condition mask held, per
    property.  Shapes follow :func:`cart_shapes`."""
    p = max(n_props, 1)
    n_live = live.sum(dtype=torch.int64)
    if not n_props:
        zero = torch.zeros((p,), dtype=torch.int64, device=live.device)
        return zero, zero
    d_evals = n_live.expand(p)
    d_hits = (live[:, None] & masks).sum(dim=0, dtype=torch.int64)
    return d_evals, d_hits


def trim_hist(values) -> list:
    """Drop the all-zero tail of a histogram (deterministic, keeps at
    least one bin) — report/JSON ergonomics only."""
    vals = [int(v) for v in np.asarray(values).tolist()]
    last = 0
    for i, v in enumerate(vals):
        if v:
            last = i
    return vals[: last + 1]


def shard_imbalance(loads) -> dict:
    """Imbalance summary over per-shard table loads: max/mean plus their
    ratio (1.0 = perfectly balanced).  The sharded engine
    (``parallel/sharded.py``) produces it from its per-shard loads."""
    arr = np.asarray(loads, dtype=np.float64).reshape(-1)
    if arr.size == 0:
        return {"max": 0, "mean": 0.0, "ratio": 1.0}
    mean = float(arr.mean())
    mx = float(arr.max())
    return {
        "max": int(mx),
        "mean": round(mean, 3),
        "ratio": round(mx / mean, 4) if mean > 0 else 1.0,
    }


def snapshot(
    *,
    depth_hist,
    action_hist,
    prop_evals,
    prop_hits,
    prop_names,
    states: int,
    unique: int,
    shard_load=None,
    route_matrix=None,
    por=None,
) -> dict:
    """Assemble the host-facing cartography block (JSON-safe) from raw
    counter arrays.  ``states``/``unique`` are the engine's cumulative
    totals — the duplicate/fresh split is derived, not separately counted
    (it is exactly ``states - unique`` by construction)."""
    n_props = len(prop_names)
    out = {
        "v": CARTOGRAPHY_V,
        "depth_hist": trim_hist(depth_hist),
        "action_hist": [int(v) for v in np.asarray(action_hist).tolist()],
        "props": [
            {
                "name": prop_names[i],
                "evaluated": int(np.asarray(prop_evals)[i]),
                "condition_hits": int(np.asarray(prop_hits)[i]),
            }
            for i in range(n_props)
        ],
        "fresh_inserts": int(unique),
        "duplicate_hits": max(int(states) - int(unique), 0),
    }
    if shard_load is not None:
        loads = [int(v) for v in np.asarray(shard_load).reshape(-1).tolist()]
        out["shard_load"] = loads
        out["shard_imbalance"] = shard_imbalance(loads)
    if route_matrix is not None:
        mat = np.asarray(route_matrix)
        out["route_matrix"] = [
            [int(v) for v in row] for row in mat.reshape(mat.shape[-2], -1)
        ] if mat.ndim >= 2 else [[int(v) for v in mat.reshape(-1)]]
        out["routed_candidates"] = int(mat.sum())
    if por is not None:
        # partial-order reduction: the reduced-vs-full split (ops/por.py)
        # — rows expanded with a reduced ample set, proviso-forced full
        # re-expansions, and candidates never generated at all
        out["por"] = {k: int(v) for k, v in dict(por).items()}
    return out
