"""Persistent run registry: the append-only ledger behind cross-run
observability.

The port's own copy of ``stateright_tpu/telemetry/registry.py``.

Layout under the registry root (``CheckerBuilder.runs(DIR)`` /
``STATERIGHT_TPU_RUN_DIR``):

 - ``runs/<run_id>.json`` — the archived run-report document: the same
   deterministic body ``telemetry/report.py`` writes, plus the volatile
   identity header (``generated_at``, ``run_id``, ``parent_run_id``).
 - ``index.jsonl`` — one append-only, versioned index record per run
   (``v`` = :data:`REGISTRY_V`): the canonical ``config_key`` (model,
   instance signature, engine, flag set, encoding, device spec, git rev
   — ``report.build_config``) plus the headline metrics
   (states/unique/depth/done/discoveries, and wall-clock throughput +
   per-stage attribution when a flight recorder was attached).

Contract (pinned by ``tests/test_torch_run_ledger.py``): the registry is
pure host-side post-run I/O — on or off, the step dispatches the same
operations and the engine key is unchanged.

Consumers: the diff engine (``telemetry/diff.py``) and the ``compare``
CLI verb (``models/_cli.py``).
"""

from __future__ import annotations

import json
import os
from typing import Optional

REGISTRY_V = 1
ENV_RUN_DIR = "STATERIGHT_TPU_RUN_DIR"


def resolve_run_dir(builder_dir: Optional[str] = None) -> Optional[str]:
    """The effective registry root: the builder's ``runs(DIR)`` wins,
    else the ``STATERIGHT_TPU_RUN_DIR`` env knob; None = registry off."""
    return builder_dir or os.environ.get(ENV_RUN_DIR) or None


def index_record(doc: dict, checker=None, leg: Optional[str] = None) -> dict:
    """One versioned index line for an archived report document.

    The headline carries the count-derived totals plus — when the run had
    a flight recorder — the wall-clock throughput and per-stage
    attribution, so trend views and perf diffs read the index alone."""
    totals = doc.get("totals") or {}
    headline = {
        "states": totals.get("states"),
        "unique": totals.get("unique"),
        "max_depth": totals.get("max_depth"),
        "done": totals.get("done"),
        "discoveries": sorted(
            p["name"] for p in doc.get("properties") or []
            if p.get("discovery")
        ),
    }
    if checker is not None:
        rec_ = getattr(checker, "flight_recorder", None)
        if rec_ is not None:
            summ = rec_.summary()
            if summ.get("states_per_sec") is not None:
                headline["states_per_sec"] = summ["states_per_sec"]
            if summ.get("wall_secs") is not None:
                headline["wall_secs"] = summ["wall_secs"]
            stages = rec_.stages()
            if stages:
                headline["stages"] = stages
    cfg = doc.get("config") or {}
    rec = {
        "v": REGISTRY_V,
        "run_id": doc.get("run_id"),
        "config_key": cfg.get("key"),
        "model": doc.get("model"),
        "engine": doc.get("engine"),
        "generated_at": doc.get("generated_at"),
        "path": f"runs/{doc.get('run_id')}.json",
        "headline": headline,
    }
    if doc.get("parent_run_id"):
        rec["parent_run_id"] = doc["parent_run_id"]
    if doc.get("sweep_id"):
        # sweep-instance archive (stateright_tpu/sweep/, docs/sweep.md):
        # the sweep id groups the family's members in `_cli runs` and
        # the Explorer run list; instance_key names this member
        rec["sweep_id"] = doc["sweep_id"]
        if doc.get("instance_key"):
            rec["instance_key"] = doc["instance_key"]
    if doc.get("campaign_id"):
        # fleet-campaign archive (stateright_tpu/fleet/, docs/fleet.md):
        # the campaign id groups a fleet's jobs under one expandable
        # row in `_cli runs` and the Explorer run list (the sweep
        # pattern); job_key names the tenant
        rec["campaign_id"] = doc["campaign_id"]
        if doc.get("job_key"):
            rec["job_key"] = doc["job_key"]
    if leg:
        rec["leg"] = leg
    return rec


class RunRegistry:
    """Append-only run ledger rooted at ``root`` (created on demand)."""

    def __init__(self, root: str):
        self.root = str(root)
        self.runs_dir = os.path.join(self.root, "runs")
        self.index_path = os.path.join(self.root, "index.jsonl")

    # -- writing -------------------------------------------------------------

    def record(
        self,
        checker,
        *,
        leg: Optional[str] = None,
        body: Optional[dict] = None,
    ) -> dict:
        """Archive one completed run; returns the appended index record.

        ``body`` reuses a report the caller already built (``report()``'s
        write, bench's embeds) — else :func:`report.build_report` runs on
        the checker (it reconstructs discovery paths, so callers holding
        a body should pass it); ``leg`` tags the record (bench legs)."""
        from .report import build_report, identity_doc

        if body is None:
            body = build_report(checker)
        doc = identity_doc(checker, body)
        # fleet-campaign tags ride the checker (set by the scheduler's
        # spawn wrapper) into the doc + index — volatile identity, like
        # run_id/sweep_id (report.VOLATILE_KEYS)
        cid = getattr(checker, "_campaign_id", None)
        if cid:
            doc["campaign_id"] = str(cid)
            jk = getattr(checker, "_job_key", None)
            if jk:
                doc["job_key"] = str(jk)
        return self.record_doc(doc, checker=checker, leg=leg)

    def record_doc(
        self,
        doc: dict,
        *,
        checker=None,
        leg: Optional[str] = None,
    ) -> dict:
        """Archive an already-assembled report document (a ``run_id``-
        bearing ``identity_doc``, or a checkpoint-derived stub for a run
        killed before its own join — ``checkpoint.stub_report_doc``).

        Crash-safe (docs/robustness.md): the archive lands via the
        atomic replace write and the index line via the durable append
        (``telemetry/_atomic.py``) — a killed writer can tear at most
        the ledger's LAST line, which :meth:`index` skips on read, so
        prior records are never lost and resume is never poisoned."""
        from ._atomic import atomic_write_json, durable_append_line

        run_id = doc.get("run_id")
        if not run_id:
            raise ValueError("report document carries no run_id")
        os.makedirs(self.runs_dir, exist_ok=True)
        atomic_write_json(
            os.path.join(self.runs_dir, f"{run_id}.json"), doc
        )
        rec = index_record(doc, checker=checker, leg=leg)
        durable_append_line(self.index_path, json.dumps(rec))
        return rec

    # -- reading -------------------------------------------------------------

    def index(self) -> list:
        """Every parseable index record, in append order.  Malformed
        lines are skipped: the ledger is append-only, and a torn tail
        line (killed writer) must not hide the rest of the history."""
        try:
            with open(self.index_path) as f:
                lines = f.read().splitlines()
        except OSError:
            return []
        out = []
        for ln in lines:
            if not ln.strip():
                continue
            try:
                rec = json.loads(ln)
            except json.JSONDecodeError:
                continue
            if isinstance(rec, dict) and rec.get("run_id"):
                out.append(rec)
        return out

    def load(self, run_id: str) -> dict:
        """The archived report document for ``run_id`` (raises on a
        missing/corrupt archive; use :meth:`find` for the soft form)."""
        with open(os.path.join(self.runs_dir, f"{run_id}.json")) as f:
            return json.load(f)

    def find(self, run_id: str) -> Optional[dict]:
        try:
            return self.load(run_id)
        except (OSError, json.JSONDecodeError):
            return None

    def headline(
        self, run_id: str, records: Optional[list] = None
    ) -> Optional[dict]:
        """The index headline for ``run_id`` (wall-clock metrics the
        archived body deliberately excludes), or None.  ``records``
        reuses an already-loaded :meth:`index` list instead of
        re-parsing the ledger."""
        for rec in records if records is not None else self.index():
            if rec.get("run_id") == run_id:
                return rec.get("headline")
        return None

    def chain(self, run_id: str) -> list:
        """The kill+resume lineage ending at ``run_id``, oldest first:
        ``parent_run_id`` links walked through the index."""
        by_id = {r["run_id"]: r for r in self.index()}
        out: list = []
        seen: set = set()
        cur = by_id.get(run_id)
        while cur is not None and cur["run_id"] not in seen:
            seen.add(cur["run_id"])
            out.append(cur)
            cur = by_id.get(cur.get("parent_run_id"))
        out.reverse()
        return out

    def trends(self, records: Optional[list] = None) -> dict:
        """``config_key -> chronological [{run_id, generated_at, leg,
        unique, states, states_per_sec}]`` — the per-configuration trend
        series the Explorer's sparklines and the ``runs`` verb read.
        ``records`` reuses an already-loaded :meth:`index` list instead
        of re-parsing the ledger."""
        out: dict = {}
        for r in records if records is not None else self.index():
            key = r.get("config_key")
            if not key:
                continue
            h = r.get("headline") or {}
            entry = {
                "run_id": r["run_id"],
                "generated_at": r.get("generated_at"),
                "unique": h.get("unique"),
                "states": h.get("states"),
                "states_per_sec": h.get("states_per_sec"),
            }
            if r.get("leg"):
                entry["leg"] = r["leg"]
            out.setdefault(key, []).append(entry)
        return out
