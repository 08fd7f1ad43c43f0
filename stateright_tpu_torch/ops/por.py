"""Ample-set selection for partial-order reduction, on the engine's device.

The port's copy of ``stateright_tpu/ops/por.py``, as plain PyTorch (a
kernel of its own comes only where a measurement on the card calls for
one).  Given the plan of ``analysis/independence.py`` (conflict matrix
``D``, per-action visibility, the guard-conjunct enabler tensor ``EN``),
:func:`ample_mask` computes a per-state **stubborn set** closure and masks
the enabled-action matrix down to its ample subset:

 1. per state, build the pull relation ``P``: an *enabled* action pulls
    every action it conflicts with (``D`` row); a *disabled* action pulls
    the writers of its first FALSE guard conjunct (``EN``: a necessary
    enabling set).  Conjunct truth comes from the conjunct kernel
    (``analysis/footprint.conjunct_eval_fn``: the guard operations of the
    captured step graph);
 2. close ``P`` transitively by boolean matrix squaring (``log2(A)``
    batched products);
 3. every enabled seed yields a candidate ample set ``T(seed) ∩ enabled``;
    take the smallest holding no property-VISIBLE action (the C2
    invisibility condition); no valid candidate, or none smaller than the
    enabled set, means full expansion for that state.

CUDA has no integer batched product, so the products run in ``float32``
and threshold with ``> 0``: the operands are 0/1 and a sum is at most
``A``, so every float dtype gives the same booleans, on either device.
``argmin`` takes the FIRST minimum, as ``jnp.argmin`` does.  The conjunct
truth is one gather through an index built once per :class:`PorConstants`
(leaf columns, the ``enabled`` column of a whole-guard action, a ones
column for padding), a fixed number of operations whatever ``A`` is.

The cycle proviso (fully expand a state whose ample successors are all
duplicates) lives in the engine, which has the insert's novelty verdict;
:func:`candidate_novelty` turns the insert's compacted ``sel``/``n_new``
into the per-candidate novelty mask the proviso reads.
"""

from __future__ import annotations

import numpy as np
import torch


def plan_constants(plan):
    """The plan's constants: ``(D, EN, visible, leaf_idx)`` with ``EN``
    padded to at least one conjunct slot (numpy)."""
    d = np.asarray(plan.conflict, bool)
    a = d.shape[0]
    en = plan.enablers
    if en is None:
        en = np.ones((a, 1, a), bool)
    return d, np.asarray(en, bool), np.asarray(plan.visible, bool), (
        list(plan.leaf_idx) if plan.leaf_idx is not None else [None] * a
    )


class PorConstants:
    """A plan's tensors on one device, built once per engine: the conflict
    matrix, the enablers (float, for the products), their union over
    conjuncts, the visibility row and the identity; and the conjunct
    truth's gather index, built at the first call from the leaves'
    widths."""

    def __init__(self, plan, device):
        d, en, vis, leaf_idx = plan_constants(plan)
        self.a, self.k = en.shape[0], en.shape[1]
        self.leaf_idx = leaf_idx
        dev = torch.device(device)
        self.d = torch.from_numpy(d).to(dev)
        # [A, K, A] -> [A, K, A] float for the batched product per action
        self.en_f = torch.from_numpy(en.astype(np.float32)).to(dev)
        self.en_any = torch.from_numpy(en.any(axis=1)).to(dev)
        self.vis = torch.from_numpy(vis).to(dev)
        self.eye = torch.eye(self.a, dtype=torch.bool, device=dev)
        self.has_leaves = any(idx is not None for idx in leaf_idx)
        self._index: dict = {}

    def gather_index(self, widths: tuple) -> torch.Tensor:
        """``[A * K]`` columns of ``cat(leaves, enabled, ones)`` for leaves
        of these widths (1 for a ``[B]`` leaf, ``cap`` for ``[B, cap]``)."""
        idx = self._index.get(widths)
        if idx is None:
            offs = np.concatenate([[0], np.cumsum(widths)]).astype(int)
            n_leaf_cols = int(offs[-1])
            ones_col = n_leaf_cols + self.a
            cols = np.full((self.a, self.k), ones_col, np.int64)
            for i, ref in enumerate(self.leaf_idx):
                if ref is None or not widths:
                    cols[i, 0] = n_leaf_cols + i  # the enabled bit itself
                    continue
                for kk, (j, lane) in enumerate(ref[:self.k]):
                    cols[i, kk] = offs[j] + (0 if lane is None else lane)
            idx = torch.from_numpy(cols.reshape(-1)).to(self.d.device)
            self._index[widths] = idx
        return idx


def conjunct_truth(enabled, rows, consts: PorConstants, kernel):
    """``bool[B, A, K]`` conjunct truth, or None when the conjunct kernel
    is unavailable or drifted from the plan (the caller then uses the
    union-of-all-enablers pull for disabled actions: pairing one
    whole-guard truth with a multi-conjunct enabler tensor would pull
    only conjunct 0's writers, which is NOT a necessary enabling set).

    Per action: the kernel's leaves where the action has an extracted
    and-tree (lane ``lane`` of a ``[B, cap]`` guard-block leaf, or the
    whole ``[B]`` leaf), the enabled bit for the whole-guard fallback,
    True past the action's conjunct count."""
    leaves = kernel(rows) if kernel is not None else None
    if leaves is None and consts.has_leaves:
        return None
    b = enabled.shape[0]
    parts = [x.reshape(b, -1) for x in (leaves or [])]
    widths = tuple(int(p.shape[1]) for p in parts)
    ones = torch.ones((b, 1), dtype=torch.bool, device=enabled.device)
    table = torch.cat(parts + [enabled, ones], dim=1)
    return table.index_select(1, consts.gather_index(widths)).reshape(
        b, consts.a, consts.k)


def ample_mask(enabled, rows, consts: PorConstants, kernel):
    """Ample subset of ``enabled`` (``bool[B, A]``) under the plan.  Full
    expansion falls out wherever no valid reduction exists: every seed's
    closure visible, or the smallest candidate no smaller than the
    enabled set."""
    b, a = enabled.shape
    ct = conjunct_truth(enabled, rows, consts, kernel)  # [B, A, K] | None
    if ct is None:
        # no conjunct truths: a disabled action pulls the UNION of every
        # conjunct's writers, a sound necessary-enabling superset
        pull_dis = consts.en_any.expand(b, a, a)
    else:
        # first-false one-hot per action (an all-true row selects nothing;
        # the fallback below unions every conjunct's enablers)
        prev_true = torch.cumprod(ct.to(torch.int32), dim=-1)
        prev_true = torch.cat(
            [torch.ones_like(prev_true[..., :1]), prev_true[..., :-1]],
            dim=-1)
        first_false = ~ct & (prev_true > 0)  # [B, A, K]
        # "bak,akj->baj", batched over the action: [A, B, K] @ [A, K, A]
        pull_dis = torch.bmm(first_false.to(torch.float32).transpose(0, 1),
                             consts.en_f).transpose(0, 1) > 0
        no_false = ct.all(dim=-1)
        pull_dis = torch.where(no_false[:, :, None], consts.en_any, pull_dis)
    pull = torch.where(enabled[:, :, None], consts.d, pull_dis)  # [B, A, A]

    reach = pull | consts.eye
    for _ in range(max(int(a).bit_length(), 1)):
        rf = reach.to(torch.float32)
        reach = reach | (torch.bmm(rf, rf) > 0)

    cand = reach & enabled[:, None, :]  # [B, seed, A]
    size = cand.sum(dim=-1)
    has_visible = (cand & consts.vis).any(dim=-1)
    n_enabled = enabled.sum(dim=-1)
    big = a + 1
    score = torch.where(enabled & ~has_visible, size, big)
    best = torch.argmin(score, dim=-1, keepdim=True)  # the first minimum
    best_score = score.gather(1, best)[:, 0]
    amp = cand.gather(1, best[:, :, None].expand(b, 1, a))[:, 0]
    full = (best_score >= big) | (best_score >= n_enabled)
    return torch.where(full[:, None], enabled, amp)


def candidate_novelty(m: int, sel, n_new):
    """Per-candidate novelty mask (``bool[m]``) from the insert's compacted
    ``sel``/``n_new``: True exactly on the candidate lanes the insert
    claimed fresh table slots for.  An add on purpose: ``sel`` past
    ``n_new`` holds stale in-range indices that may collide with novel
    ones, and a write of their False could clobber a True; adding 0
    cannot."""
    fresh = (torch.arange(sel.shape[0], device=sel.device) < n_new).to(
        torch.int64)
    out = torch.zeros((m,), dtype=torch.int64, device=sel.device)
    return out.index_add_(0, sel, fresh) > 0
