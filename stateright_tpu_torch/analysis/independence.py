"""Static independence analysis -> the per-model conflict matrix.

The port's copy of ``stateright_tpu/analysis/independence.py``, built on
the port's footprint pass (``footprint.py``, on a captured aten graph).
Two actions are **independent** iff each one's write set is disjoint from
the other's read ∪ write set *and* from the other's enabledness-guard
footprint: their updates commute bit-for-bit, and neither can enable or
disable the other.  Everything the footprint pass could not decide is
conservatively **dependent**: undecidability costs reduction, never
soundness.

The matrix is a constant per twin; the engine consumes it through
:func:`por_plan`, which also decides whether partial-order reduction is
*usable* for the model at all and which actions are **visible** to the
declared properties (an ample set holding a visible action is never a
valid reduction: the C2 invisibility condition).  Like the JAX audit,
``audit_model`` does not run this pass; ``.por()``, the ``independence``
verb and :func:`fold_into_report` do.

Rule catalogue (``JX3xx``, the JAX package's ``docs/analysis.md``):

 - ``JX300`` warning -- the footprint pass crashed; every action is
   conservatively dependent (from ``footprint.py``).
 - ``JX301`` info -- an action's footprint is undecidable (collapsed to
   TOP): conservatively dependent on every action.
 - ``JX302`` info -- the successor stack does not decompose per action
   (data-dependent assembly, the slot-multiset network twins): the whole
   matrix is conservatively dependent.
 - ``JX303`` warning -- a declared property reads no field any action
   ever writes: the property is constant over the reachable space.
 - ``JX304`` info -- ``por()`` would fall back to full expansion for this
   model.
 - ``JX305`` info -- the non-decomposition is the slot-multiset actor
   packing: names the per-channel encoding escape hatch.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..core import Expectation
from .footprint import FieldSet, ModelFootprints, extract_footprints, union_all
from .report import AuditFinding, Severity

_MAX_LISTED = 4  # cap per-action JX301 noise; the count rides the metrics


@dataclass
class IndependenceReport:
    """The conflict matrix plus what the engine and the CLI verb surface
    about it."""

    n_actions: int
    conflict: np.ndarray  # bool [A, A], symmetric, diagonal True
    visible: np.ndarray  # bool [A]: writes intersect any property read
    footprints: Optional[ModelFootprints]
    findings: list = field(default_factory=list)
    #: network packing of the analyzed twin ("slot-multiset" /
    #: "per-channel" for compiled actor twins, None for hand-written ones)
    encoding: Optional[str] = None

    @property
    def independent_pairs(self) -> int:
        a = self.n_actions
        return int((a * a - int(self.conflict.sum())) // 2)

    def summary(self) -> dict:
        fp = self.footprints
        return {
            "actions": self.n_actions,
            "independent_pairs": self.independent_pairs,
            "visible_actions": int(self.visible.sum()),
            "undecided_actions": (
                len(fp.undecided_actions) if fp is not None
                else self.n_actions
            ),
            "decomposed": bool(fp.decomposed) if fp is not None else False,
            "encoding": self.encoding,
            "rules": sorted({f.rule_id for f in self.findings}),
        }


@dataclass
class PorPlan:
    """What a ``por()`` run needs: the conflict matrix, per-action
    visibility, the guard-conjunct enabler tensor for the stubborn-set
    closure, and whether reduction is sound and useful for this model.

    ``enablers[i, k, j]`` -- action ``j`` writes into conjunct ``k`` of
    action ``i``'s guard (a *necessary enabling set*).  Rows past ``i``'s
    conjunct count are all-False padding (their truth is padded True, so
    they are never selected).  ``leaf_idx`` -- per action, ``(leaf,
    lane)`` references into the conjunct kernel's leaf outputs (None: one
    whole-guard conjunct whose truth is the enabled bit itself)."""

    conflict: np.ndarray
    visible: np.ndarray
    usable: bool
    fallback_reason: Optional[str] = None
    enablers: Optional[np.ndarray] = None  # bool [A, K, A]
    leaf_idx: Optional[list] = None
    n_leaves: int = 0


def _conflicts(fa, fb) -> bool:
    """May ``a`` and ``b`` interfere?  Independence needs BOTH directions
    write-vs-(read ∪ write ∪ guard) disjoint; undecided is dependent.
    ``accum`` bits (monotone OR-accumulates) get one exemption: accum ∩
    accum commutes bit-for-bit; against everything else an accum bit is a
    write."""
    if not fa.decided or not fb.decided:
        return True
    return (
        fa.writes.intersects(fb.reads)
        or fa.writes.intersects(fb.writes)
        or fa.writes.intersects(fb.guard)
        or fa.writes.intersects(fb.accum)
        or fb.writes.intersects(fa.reads)
        or fb.writes.intersects(fa.guard)
        or fb.writes.intersects(fa.accum)
        or fa.accum.intersects(fb.reads)
        or fa.accum.intersects(fb.guard)
        or fb.accum.intersects(fa.reads)
        or fb.accum.intersects(fa.guard)
    )


def run_independence(tensor, props, model_name: str = "") -> IndependenceReport:
    """The conflict matrix for ``tensor`` (cached on the twin); ``props``
    is the object model's ``properties()`` list (names and kinds, for
    visibility and the JX303/JX304 diagnostics)."""
    cached = getattr(tensor, "_independence_cache", None)
    if cached is not None:
        return cached
    arity = int(getattr(tensor, "max_actions", 0) or 0)
    encoding = getattr(tensor, "network_encoding", None)
    fps = extract_footprints(tensor)
    findings: list = []
    if fps is None:
        conflict = np.ones((arity, arity), bool)
        visible = np.ones((arity,), bool)
        findings.append(AuditFinding(
            "JX302", Severity.INFO, "step_rows",
            "no footprints (kernel does not capture or twin contract "
            "missing): every action pair is conservatively dependent",
        ))
        out = IndependenceReport(arity, conflict, visible, None, findings,
                                 encoding=encoding)
        _cache(tensor, out)
        return out

    findings.extend(fps.findings)
    conflict = np.zeros((arity, arity), bool)
    for i in range(arity):
        conflict[i, i] = True
        for j in range(i + 1, arity):
            c = _conflicts(fps.actions[i], fps.actions[j])
            conflict[i, j] = conflict[j, i] = c

    prop_union = union_all(fps.prop_reads) if fps.prop_reads else (
        FieldSet.top_set()
    )
    visible = np.asarray([
        (not a.decided)
        or a.writes.intersects(prop_union)
        or a.accum.intersects(prop_union)
        for a in fps.actions
    ], bool)

    if not fps.decomposed:
        findings.append(AuditFinding(
            "JX302", Severity.INFO, "step_rows",
            "successor assembly does not decompose per action (data-"
            "dependent writes, the slot-multiset network idiom): the "
            "conflict matrix is conservatively all-dependent; por() runs "
            "as full expansion",
        ))
        if encoding == "slot-multiset":
            findings.append(AuditFinding(
                "JX305", Severity.INFO, "step_rows",
                "this is the slot-multiset network packing: a delivery's "
                "destination is message DATA, so its writes cannot be "
                "statically confined.  Re-compile with the per-channel "
                "layout (ActorModel.per_channel_() / --per-channel / "
                "STATERIGHT_TPU_PER_CHANNEL=1) to make the action stack "
                "decompose and turn por() into real reduction",
            ))
    else:
        und = fps.undecided_actions
        for a in und[:_MAX_LISTED]:
            findings.append(AuditFinding(
                "JX301", Severity.INFO, f"step_rows:action#{a}",
                "action footprint is undecidable (collapsed to top): "
                "conservatively dependent on every action",
            ))
        if len(und) > _MAX_LISTED:
            findings.append(AuditFinding(
                "JX301", Severity.INFO, "step_rows",
                f"... and {len(und) - _MAX_LISTED} more undecidable "
                "action footprints (count in metrics)",
            ))

    # JX303 -- vacuous property: reads only fields no action ever writes;
    # needs every write footprint decided (an undecided action could write
    # anything)
    if all(a.decided for a in fps.actions) and props and fps.prop_reads:
        writes_union = union_all(
            a.writes.union(a.accum) for a in fps.actions
        )
        for p, reads in zip(props, fps.prop_reads):
            if reads.top or reads.is_empty:
                continue
            if not reads.intersects(writes_union):
                findings.append(AuditFinding(
                    "JX303", Severity.WARNING,
                    f"property:{getattr(p, 'name', '?')}",
                    "property read footprint contains no field any action "
                    "ever writes: its truth value is frozen at the init "
                    "states -- a dead/vacuous (likely miswired) property",
                ))

    out = IndependenceReport(arity, conflict, visible, fps, findings,
                             encoding=encoding)

    # JX304 -- the por() fallback preview for this model
    plan = _plan_from(out, props, tensor)
    if not plan.usable:
        out.findings.append(AuditFinding(
            "JX304", Severity.INFO, "por",
            f"partial-order reduction falls back to full expansion for "
            f"this model: {plan.fallback_reason}",
        ))
    _cache(tensor, out)
    return out


def _cache(tensor, report: IndependenceReport) -> None:
    try:
        tensor._independence_cache = report
    except Exception:  # noqa: BLE001 - __slots__ twins
        pass


def _plan_from(report: IndependenceReport, props, tensor=None) -> PorPlan:
    """The soundness and usefulness gate of a ``por()`` run:

     - an ``eventually`` property disables reduction (the terminal-state
       liveness flush is not stutter-closed under ample-set exploration);
     - a boundary filter disables it (it disables actions the guard
       admits, so the closure's enabled/disabled split would lie);
     - a matrix with no independent pair, or with every action visible,
       reduces nothing;
     - no guard-conjunct decomposition, no closure.
    """
    has_eventually = any(
        getattr(p, "expectation", None) is Expectation.EVENTUALLY
        for p in (props or [])
    )
    if has_eventually:
        return PorPlan(report.conflict, report.visible, False,
                       "the model declares eventually/liveness properties")
    if tensor is not None and getattr(tensor, "has_boundary", False):
        return PorPlan(report.conflict, report.visible, False,
                       "the twin declares a boundary filter")
    if report.independent_pairs == 0:
        return PorPlan(report.conflict, report.visible, False,
                       "the conflict matrix admits no independent pair")
    if bool(report.visible.all()):
        return PorPlan(report.conflict, report.visible, False,
                       "every action is visible to a property footprint")
    fps = report.footprints
    cj = fps.conjuncts if fps is not None else None
    if cj is None:
        return PorPlan(report.conflict, report.visible, False,
                       "no guard-conjunct decomposition")
    a = report.n_actions
    k = cj.max_conjuncts
    en = np.zeros((a, k, a), bool)
    for i in range(a):
        for ki, cset in enumerate(cj.sets[i]):
            for j in range(a):
                fj = fps.actions[j]
                en[i, ki, j] = (
                    (not fj.decided)
                    or fj.writes.intersects(cset)
                    or fj.accum.intersects(cset)
                )
    return PorPlan(
        report.conflict, report.visible, True,
        enablers=en, leaf_idx=list(cj.leaf_idx), n_leaves=cj.n_leaves,
    )


def por_plan(tensor, props) -> PorPlan:
    """The engine's entry point: conflict matrix, visibility and the
    usable/fallback verdict for this twin (cached with the report)."""
    return _plan_from(run_independence(tensor, props), props, tensor)


def plan_digest(plan) -> str:
    """A short digest of a plan's conflict matrix, visibility and enablers
    (shapes and bits): what ``chip_smoke.py`` holds the card's plan to,
    recomputed by a CPU test from the JAX package's plan (any object with
    those three attributes), so a capture that drifts between torch
    versions cannot pass unseen."""
    h = hashlib.sha256()
    for a in (plan.conflict, plan.visible, plan.enablers):
        if a is None:
            h.update(b"none")
            continue
        a = np.asarray(a, bool)
        h.update(repr(a.shape).encode())
        h.update(np.packbits(a.reshape(-1)).tobytes())
    return h.hexdigest()[:16]


def fold_into_report(tensor, props, report) -> None:
    """Merge the independence findings and summary into an
    ``AuditReport`` (the ``independence`` CLI verb)."""
    ind = run_independence(tensor, props)
    report.extend(ind.findings)
    report.metrics["independence"] = ind.summary()
