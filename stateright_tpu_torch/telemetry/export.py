"""Flight-recorder export: JSONL (lossless round-trip) and Chrome trace.

The port's own copy of ``stateright_tpu/telemetry/export.py``: the same
layouts, so a JSONL written by either package's recorder reads in the
other's.

JSONL layout: line 1 is a header object ``{"kind": "header", "meta": {...},
"summary": {...}, "capacity": N}``; every following line is one record in
ring order.  ``from_jsonl`` rebuilds a recorder whose ring, meta and
derived summary match the exported one (aggregate counters are restored
from the header's summary scalars), pinned by the round-trip test.

Chrome-trace layout (`chrome://tracing` / Perfetto "JSON object format"):
``step`` records become complete events (``ph: "X"``) whose duration is the
step's ``dt``; point events (growth, occupancy, compile) become instant
events (``ph: "i"``); aggregate counters ride a final metadata event.
Resource pressure rides COUNTER tracks (``ph: "C"`` — the viewer plots
them as stacked series over the timeline): ``throughput``
(states_per_sec + load_factor, per step), ``pressure`` (queue depth +
table load, per step), and ``hbm_bytes`` (the memory ledger's analytic
bytes + live ``bytes_in_use``, one point per ``memory`` record) — so a
growth transient or a queue ramp is visible in the same view as the
steps that caused it.  Timestamps are microseconds, as the format
requires.
"""

from __future__ import annotations

import json

from .recorder import FlightRecorder


# JSONL export schema version: the golden-schema test
# (tests/test_telemetry_schema.py) pins field names/types per record kind
# against this number — bump it when the schema changes shape.
SCHEMA_V = 1


def to_jsonl(rec: FlightRecorder, path, append: bool = False) -> None:
    header = {
        "kind": "header",
        "v": SCHEMA_V,
        "meta": rec.meta_snapshot(),
        "capacity": rec.capacity,
        "summary": rec.summary(),
        "counters": rec.counters(),
        # clock origin (monotonic): lets a merged multi-run export
        # (fleet scheduler + per-job recorders appended to one file)
        # re-align every run's relative ``t`` onto one shared timeline
        "t0": round(rec.t0_monotonic, 6),
    }
    with open(path, "a" if append else "w") as f:
        f.write(json.dumps(header) + "\n")
        for r in rec.records():
            f.write(json.dumps(r) + "\n")


def from_jsonl(path) -> FlightRecorder:
    """Rebuild a recorder from a JSONL export (ring + counters + meta).
    Single-run files round-trip the derived summary exactly even when the
    ring evicted records: totals the replayed window cannot reconstruct
    (seq, step/growth counts, cumulative states/unique, wall time) are
    reconciled from the header's summary.  Multi-run files
    (``append=True``) fold every run's records into one recorder, later
    headers overriding meta — their summaries are window-approximate by
    design."""
    rec = None
    headers = []
    # multi-run alignment: later runs' relative timestamps shift by the
    # difference of their monotonic clock origins against the FIRST
    # run's (headers carry ``t0``; absent — an older export — the shift
    # is zero, the pre-alignment behavior)
    t0_first = None
    t_shift = 0.0

    def replaying(r):
        # exported health events replay verbatim; replayed steps must not
        # REgenerate them (the ring would then carry each event twice)
        r._replaying = True
        return r

    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            obj = json.loads(line)
            if obj.get("kind") == "header":
                headers.append(obj)
                h_t0 = obj.get("t0")
                if rec is None:
                    if isinstance(h_t0, (int, float)):
                        t0_first = float(h_t0)
                    rec = replaying(FlightRecorder(
                        capacity=int(obj.get("capacity", 4096)),
                        meta=obj.get("meta") or {},
                    ))
                else:
                    rec.update_meta(**(obj.get("meta") or {}))
                    # run boundary in an appended file: the next run's
                    # cumulative counters restart from zero — reset the
                    # delta baseline so they are not clamped/diffed
                    # against the previous run's totals
                    rec._reset_step_baseline()
                    if (
                        t0_first is not None
                        and isinstance(h_t0, (int, float))
                    ):
                        t_shift = float(h_t0) - t0_first
                for k, v in (obj.get("counters") or {}).items():
                    rec.add(k, v)
                continue
            if rec is None:  # record lines before any header: tolerate
                rec = replaying(FlightRecorder())
            kind = obj.get("kind", "note")
            fields = {
                k: v for k, v in obj.items() if k not in ("seq", "t", "kind")
            }
            t_in = obj.get("t")
            if t_in is not None and t_shift:
                t_in = round(float(t_in) + t_shift, 6)
            if kind == "step":
                stored = rec.step(t=t_in, **fields)
            else:
                stored = rec.record(kind, t=t_in, **fields)
            if "seq" in obj:
                # keep the original sequence numbers (replay renumbers
                # from 1, which would mislabel a ring that had evicted)
                stored["seq"] = obj["seq"]
    if rec is None:
        return FlightRecorder()
    if len(headers) == 1:
        rec._reconcile_totals(headers[0].get("summary") or {})
    rec._replaying = False
    return rec


def _span_lanes(records: list) -> tuple:
    """Lane (``tid``) assignment for span-structured records: every span
    renders on the lane of its ROOT ancestor, so one fleet job and all
    its descendants (supervisor attempts, engine runs, step blocks, host
    seams) share a track and the viewer nests them by time containment —
    while concurrent sibling jobs land on separate tracks and never
    corrupt each other's nesting.  Returns ``(lane_of_span_id, lanes)``
    where lanes start at 100 (the plain step lane stays 1)."""
    by_id = {}
    for r in records:
        if r["kind"] == "span" and r.get("span_id"):
            by_id[r["span_id"]] = r
    roots: dict = {}

    def root_of(sid: str) -> str:
        seen = set()
        while True:
            r = by_id.get(sid)
            if r is None:
                return sid
            parent = r.get("parent_id")
            if not parent or parent not in by_id or parent in seen:
                return sid
            seen.add(sid)
            sid = parent

    lane_of: dict = {}
    for sid in by_id:
        root = root_of(sid)
        if root not in roots:
            roots[root] = 100 + len(roots)
        lane_of[sid] = roots[root]
    return lane_of, roots


def to_chrome_trace(rec: FlightRecorder, path) -> None:
    events = []
    pid = 1
    all_records = rec.records()
    span_lane, _ = _span_lanes(all_records)
    for r in all_records:
        ts_us = r["t"] * 1e6
        args = {
            k: v for k, v in r.items() if k not in ("seq", "t", "kind")
        }
        if r["kind"] == "step":
            dur_us = max(float(r.get("dt", 0.0)) * 1e6, 1.0)
            events.append({
                "name": f"step:{r.get('engine', '?')}",
                "cat": "step",
                "ph": "X",
                # complete events anchor at their START time (clamped:
                # a first step with dt=0 gets dur 1us, which must not
                # push ts below the trace origin)
                "ts": round(max(ts_us - dur_us, 0.0), 3),
                "dur": round(dur_us, 3),
                "pid": pid,
                # a step bound to an engine-run span renders on that
                # span's lane, nesting as its child step-block
                "tid": span_lane.get(r.get("span"), 1),
                "args": args,
            })
            # counter track: throughput + table load, plotted by the viewer
            counters = {}
            if r.get("dt", 0) and r.get("d_states") is not None:
                counters["states_per_sec"] = round(
                    r["d_states"] / r["dt"], 1
                )
            if r.get("load_factor") is not None:
                counters["load_factor"] = r["load_factor"]
            if counters:
                events.append({
                    "name": "throughput",
                    "cat": "step",
                    "ph": "C",
                    "ts": round(ts_us, 3),
                    "pid": pid,
                    "args": counters,
                })
            # resource-pressure counter track: queue depth + table load
            # per step, so the timeline shows WHERE the memory pressure
            # built, not just that it did (docs/telemetry.md)
            pressure = {}
            if r.get("queue") is not None:
                pressure["queue"] = r["queue"]
            if r.get("load_factor") is not None:
                pressure["table_load"] = r["load_factor"]
            if pressure:
                events.append({
                    "name": "pressure",
                    "cat": "step",
                    "ph": "C",
                    "ts": round(ts_us, 3),
                    "pid": pid,
                    "args": pressure,
                })
        elif r["kind"] == "spill":
            # spill-tier events (docs/spill.md): the instant event keeps
            # the record browsable; two counter tracks plot the tier byte
            # series (spill_bytes) and the Bloom/pending traffic
            # (bloom_filter) over the same timeline as the steps
            events.append({
                "name": r["kind"],
                "cat": r["kind"],
                "ph": "i",
                "s": "p",
                "ts": round(ts_us, 3),
                "pid": pid,
                "tid": 1,
                "args": args,
            })
            sb = {}
            for k in ("host_bytes", "disk_bytes"):
                if r.get(k) is not None:
                    sb[k] = r[k]
            if sb:
                events.append({
                    "name": "spill_bytes",
                    "cat": "spill",
                    "ph": "C",
                    "ts": round(ts_us, 3),
                    "pid": pid,
                    "args": sb,
                })
            bf = {}
            for k in ("spilled_fps", "pending", "dups", "novel"):
                if r.get(k) is not None:
                    bf[k] = r[k]
            if bf:
                events.append({
                    "name": "bloom_filter",
                    "cat": "spill",
                    "ph": "C",
                    "ts": round(ts_us, 3),
                    "pid": pid,
                    "args": bf,
                })
        elif r["kind"] == "memory":
            # memory-ledger samples: the instant event keeps the full
            # record browsable, the counter track plots the byte series
            events.append({
                "name": r["kind"],
                "cat": r["kind"],
                "ph": "i",
                "s": "p",
                "ts": round(ts_us, 3),
                "pid": pid,
                "tid": 1,
                "args": args,
            })
            hbm = {}
            if r.get("total_bytes") is not None:
                hbm["analytic_bytes"] = r["total_bytes"]
            live = r.get("device") or {}
            if live.get("bytes_in_use") is not None:
                hbm["bytes_in_use"] = live["bytes_in_use"]
            if hbm:
                events.append({
                    "name": "hbm_bytes",
                    "cat": "memory",
                    "ph": "C",
                    "ts": round(ts_us, 3),
                    "pid": pid,
                    "args": hbm,
                })
        elif r["kind"] == "span":
            # span-structured tracing (telemetry/spans.py): proper
            # nested duration events — the record's ``t`` is the close
            # time, so the event anchors at ``t - dur``; every span in
            # one lineage shares its root's lane, and the viewer nests
            # by time containment
            dur_us = max(float(r.get("dur", 0.0)) * 1e6, 1.0)
            events.append({
                "name": str(r.get("name", "span")),
                "cat": "span",
                "ph": "X",
                "ts": round(max(ts_us - dur_us, 0.0), 3),
                "dur": round(dur_us, 3),
                "pid": pid,
                "tid": span_lane.get(r.get("span_id"), 100),
                "args": args,
            })
        else:
            events.append({
                "name": r["kind"],
                "cat": r["kind"],
                "ph": "i",
                "s": "p",
                "ts": round(ts_us, 3),
                "pid": pid,
                "tid": 1,
                "args": args,
            })
    doc = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"meta": rec.meta_snapshot(), "summary": rec.summary()},
    }
    with open(path, "w") as f:
        json.dump(doc, f)


def from_chrome_trace(path) -> dict:
    """Parse a Chrome-trace export back into ``{events, meta, summary}`` —
    the round-trip half used by tests (the trace format is lossy by design:
    ``seq`` is dropped, step starts are shifted by ``dt``)."""
    with open(path) as f:
        doc = json.load(f)
    return {
        "events": doc.get("traceEvents", []),
        "meta": doc.get("otherData", {}).get("meta", {}),
        "summary": doc.get("otherData", {}).get("summary", {}),
    }
