"""Contract-aware structural diff over two run reports.

The port's own copy of ``stateright_tpu/telemetry/diff.py``, with the
same flag classes: a report of either package diffs against one of the
other (the port's GPU engine reports ``engine: gpu-wavefront``, so a
JAX-vs-port pair is an engine delta, class *identical*; a cpu-vs-cuda
pair of the port differs in ``device``, class *perf*).

Every observability layer before this one explains a *single* run; this
module is the comparison half (docs/telemetry.md "Comparing runs"): a
deterministic, machine-readable diff of two run-report documents
(``telemetry/report.py``) that KNOWS what each configuration delta
promises — and classifies the pair

 - ``IDENTICAL`` — every count-derived field agrees (and the flag delta,
   if any, promised exactly that);
 - ``ISOMORPHIC`` — property verdicts agree while explored counts differ,
   under a flag delta that promises verdict-isomorphism only
   (``--por``, ``--per-channel``, ``symmetry()``);
 - ``PERF-ONLY`` — the delta is pure perf knobs (prewarm, pallas,
   compile cache, device/git drift): counts still must agree, and the
   interesting difference is throughput;
 - ``DIVERGENT`` — a promised contract is broken; the ``violations``
   list names every break (machine-readable: rule + field + both sides).

Flag classes (each promise is pinned by its own feature's tests — this
table is the single place the diff engine encodes them):

 - *observability* (``telemetry``/``cartography``/``memory``/
   ``roofline``): bit-identical counts; blocks may appear/disappear.
 - *identical* (``checked``/``prededup``/``spill``, and an engine
   delta — wavefront/sharded/host parity is pinned): bit-identical
   counts and verdicts.
 - *isomorphic* (``por``/``symmetry``, and an ``encoding`` delta):
   identical verdicts, explored counts may shrink (a reduction that
   GROWS the space is a violation).
 - *perf* (``prewarm``/``pallas``/``compile_cache``, ``device``/
   ``git_rev`` drift): bit-identical counts; only wall-clock may move.
 - *incomparable* (different model or instance): no contract applies —
   the pair diverges with a single named ``incomparable`` violation.

Volatile identity fields (``generated_at``, ``run_id``, ...) are scrubbed
BY SCHEMA — :data:`telemetry.report.VOLATILE_KEYS` is consulted at diff
time, so a new volatile header field is ignored here automatically.

Kill+resume lineage: when ``b`` carries ``parent_run_id == a.run_id``
(snapshot-manifest propagation), the pair is the SAME logical run
continued — the gates become monotonicity (the resumed run must carry at
least the parent's totals and every parent discovery) plus exact-totals
equality when the parent itself completed.  A passing lineage pair
classifies ``IDENTICAL``; lost work is a ``resume_lost_work`` violation
(the PR-8/PR-10 exact-totals pins as one command).
"""

from __future__ import annotations

from typing import Optional

from . import report as _report

DIFF_V = 1

IDENTICAL = "IDENTICAL"
ISOMORPHIC = "ISOMORPHIC"
PERF_ONLY = "PERF-ONLY"
DIVERGENT = "DIVERGENT"

# flag -> contract class (module docstring table)
FLAG_CLASS = {
    "telemetry": "observability",
    "cartography": "observability",
    "memory": "observability",
    "roofline": "observability",
    "checked": "identical",
    "prededup": "identical",
    "spill": "identical",
    # sweep membership (stateright_tpu/sweep/): per-instance counts and
    # verdicts are contractually bit-identical to the sequential run
    "sweep": "identical",
    "por": "isomorphic",
    "symmetry": "isomorphic",
    "prewarm": "perf",
    "pallas": "perf",
    "compile_cache": "perf",
    # the MXU recast knobs (ops/mxu.py): counts bit-identical by
    # contract, program shapes differ — a pure perf delta
    "mxu": "perf",
}

# non-flag config aspects -> contract class
_TOP_CLASS = {
    "model": "incomparable",
    "instance": "incomparable",
    "engine": "identical",
    "encoding": "isomorphic",
    "device": "perf",
    "git_rev": "perf",
}

# weakest-promise ordering: the pair's contract is the least committal
# class present in the delta
_RANK = {
    "same": 0, "observability": 1, "identical": 2, "perf": 3,
    "isomorphic": 4, "unknown": 5, "incomparable": 6,
}

# contracts under which every count-derived field must agree
_COUNT_CONTRACTS = ("same", "observability", "identical", "perf")


def scrub(doc: dict) -> dict:
    """A report document minus its volatile identity header — consulted
    from the report schema (:data:`report.VOLATILE_KEYS`), never
    hand-listed here."""
    return {
        k: v for k, v in doc.items() if k not in _report.VOLATILE_KEYS
    }


def config_delta(a_cfg: Optional[dict], b_cfg: Optional[dict]) -> dict:
    """``{aspect: {a, b, class}}`` for every config aspect that differs
    between the two reports' ``config`` blocks."""
    a_cfg, b_cfg = a_cfg or {}, b_cfg or {}
    out: dict = {}
    fa = a_cfg.get("flags") or {}
    fb = b_cfg.get("flags") or {}
    for k in sorted(set(fa) | set(fb)):
        if bool(fa.get(k)) != bool(fb.get(k)):
            out[f"flags.{k}"] = {
                "a": fa.get(k), "b": fb.get(k),
                "class": FLAG_CLASS.get(k, "unknown"),
            }
    for k, cls in _TOP_CLASS.items():
        if a_cfg.get(k) != b_cfg.get(k):
            out[k] = {"a": a_cfg.get(k), "b": b_cfg.get(k), "class": cls}
    return out


def contract_of(delta: dict) -> str:
    """The pair's contract: the weakest promise among the differing
    aspects (``same`` when the configs agree entirely)."""
    if not delta:
        return "same"
    return max((d["class"] for d in delta.values()), key=_RANK.get)


def _pair(a, b) -> dict:
    out = {"a": a, "b": b, "match": a == b}
    if isinstance(a, (int, float)) and isinstance(b, (int, float)) and \
            not isinstance(a, bool) and not isinstance(b, bool):
        out["delta"] = b - a
    return out


def _violation(rule: str, field: str, a, b, detail: str) -> dict:
    return {"rule": rule, "field": field, "a": a, "b": b, "detail": detail}


_CART_KEYS = ("depth_hist", "action_hist", "fresh_inserts",
              "duplicate_hits")


def _cartography_block(ca: Optional[dict], cb: Optional[dict]) -> dict:
    """Common-key cartography delta (engine-specific extras like shard
    loads are reported by presence only)."""
    out: dict = {"present": {"a": ca is not None, "b": cb is not None}}
    if ca is None or cb is None:
        return out
    for k in ("fresh_inserts", "duplicate_hits"):
        out[k] = _pair(ca.get(k), cb.get(k))
    for k in ("depth_hist", "action_hist"):
        ha, hb = ca.get(k) or [], cb.get(k) or []
        out[k] = {"match": ha == hb, "bins": _pair(len(ha), len(hb))}
        if ha != hb and len(ha) == len(hb):
            out[k]["delta"] = [y - x for x, y in zip(ha, hb)]
    out["match"] = all(
        out[k].get("match") for k in _CART_KEYS if k in out
    )
    return out


def _scalar_block(a: Optional[dict], b: Optional[dict], keys) -> dict:
    out: dict = {"present": {"a": a is not None, "b": b is not None}}
    if a is None or b is None:
        return out
    for k in keys:
        out[k] = _pair(a.get(k), b.get(k))
    out["match"] = a == b
    return out


def _lineage_of(a: dict, b: dict) -> Optional[dict]:
    rid = a.get("run_id")
    if rid and b.get("parent_run_id") == rid:
        return {"parent": rid, "resumed": b.get("run_id")}
    return None


def diff_reports(
    a: dict,
    b: dict,
    a_headline: Optional[dict] = None,
    b_headline: Optional[dict] = None,
) -> dict:
    """Diff two run-report documents (``write_report`` docs, archived
    registry entries, or bare ``build_report`` bodies).

    ``a_headline``/``b_headline`` optionally attach the registry index
    records' wall-clock headline (throughput, per-stage attribution) —
    never part of the deterministic report body, so it rides in as a
    separate ``perf`` block and gates nothing.

    Returns ``{v, verdict, contract, config_delta, lineage?, blocks,
    violations}`` — deterministic for fixed inputs, JSON-safe."""
    lineage = _lineage_of(a, b)
    a_s, b_s = scrub(a), scrub(b)
    known_cfg = bool(a_s.get("config")) and bool(b_s.get("config"))
    delta = config_delta(a_s.get("config"), b_s.get("config"))
    violations: list = []
    blocks: dict = {}

    if lineage is not None:
        # the same logical run continued: config deltas below the
        # isomorphic class (and the parent's target_states prefix) are
        # resume mechanics, not an A/B — but the MODEL must still match
        contract = "lineage"
        am = (a_s.get("config") or {}).get("model")
        bm = (b_s.get("config") or {}).get("model")
        if known_cfg and am != bm:
            violations.append(_violation(
                "incomparable", "model", am, bm,
                "resumed run reports a different model than its parent",
            ))
    elif not known_cfg:
        contract = "unknown"
    else:
        contract = contract_of(delta)
        for k, d in delta.items():
            if d["class"] == "incomparable":
                violations.append(_violation(
                    "incomparable", k, d["a"], d["b"],
                    f"reports describe different {k}s — no cross-run "
                    "contract applies",
                ))

    # -- per-block deltas (always computed; gating depends on contract) --
    ta, tb = a_s.get("totals") or {}, b_s.get("totals") or {}
    blocks["totals"] = {
        k: _pair(ta.get(k), tb.get(k))
        for k in ("states", "unique", "max_depth", "done")
    }
    pa = {p.get("name"): p for p in a_s.get("properties") or []}
    pb = {p.get("name"): p for p in b_s.get("properties") or []}
    props = []
    for name in sorted(set(pa) | set(pb)):
        ea, eb = pa.get(name), pb.get(name)
        props.append({
            "name": name,
            "expectation": (ea or eb or {}).get("expectation"),
            "a": None if ea is None else bool(ea.get("discovery")),
            "b": None if eb is None else bool(eb.get("discovery")),
            "match": (
                ea is not None and eb is not None
                and bool(ea.get("discovery")) == bool(eb.get("discovery"))
            ),
        })
    blocks["properties"] = props
    blocks["cartography"] = _cartography_block(
        a_s.get("cartography"), b_s.get("cartography")
    )
    blocks["memory"] = _scalar_block(
        a_s.get("memory"), b_s.get("memory"),
        ("total_bytes", "capacity"),
    )
    ra, rb = a_s.get("roofline"), b_s.get("roofline")
    blocks["roofline"] = _scalar_block(
        (ra or {}).get("totals") if ra else None,
        (rb or {}).get("totals") if rb else None,
        ("flops", "bytes"),
    )
    blocks["por"] = _scalar_block(
        a_s.get("por"), b_s.get("por"),
        ("enabled", "rows_reduced", "rows_full_proviso",
         "candidates_masked"),
    )
    blocks["spill"] = _scalar_block(
        a_s.get("spill"), b_s.get("spill"),
        ("evictions", "spilled_fps"),
    )
    ga, gb = a_s.get("growth_events"), b_s.get("growth_events")
    blocks["growth_events"] = {
        "present": {"a": ga is not None, "b": gb is not None},
        "count": _pair(
            len(ga) if ga is not None else None,
            len(gb) if gb is not None else None,
        ),
        "match": ga == gb,
    }
    ha = a_s.get("health_timeline")
    hb = b_s.get("health_timeline")
    blocks["health_timeline"] = {
        "present": {"a": ha is not None, "b": hb is not None},
        "phases": _pair(
            _phase_seq(ha) if ha is not None else None,
            _phase_seq(hb) if hb is not None else None,
        ),
        "match": ha == hb,
    }
    if a_headline or b_headline:
        ah, bh = a_headline or {}, b_headline or {}
        perf: dict = {
            k: _pair(ah.get(k), bh.get(k))
            for k in ("states_per_sec", "wall_secs")
        }
        sa, sb = ah.get("stages") or {}, bh.get("stages") or {}
        if sa or sb:
            perf["stages"] = {
                k: _pair(sa.get(k), sb.get(k))
                for k in sorted(set(sa) | set(sb))
            }
        blocks["perf"] = perf

    # -- contract gates ------------------------------------------------------
    if lineage is not None and not violations:
        # monotonicity: the resumed run continues the parent, so it must
        # carry at least the parent's totals and every parent discovery.
        # (A parent's `done: true` only means it STOPPED cleanly — a
        # stop()/target_states cut still reports done — so exact-totals
        # equality is checked by comparing the resumed run against a
        # fresh FULL run of the same config instead: contract `same`.)
        for k in ("states", "unique", "max_depth"):
            va, vb = ta.get(k), tb.get(k)
            if not isinstance(va, int) or not isinstance(vb, int):
                continue
            if vb < va:
                violations.append(_violation(
                    "resume_lost_work", f"totals.{k}", va, vb,
                    "the resumed run carries less than its parent's "
                    "snapshot — work was lost across kill+resume",
                ))
        lost = [
            p["name"] for p in props if p["a"] is True and p["b"] is not True
        ]
        for name in lost:
            violations.append(_violation(
                "resume_lost_discovery", f"properties.{name}", True, False,
                "a discovery recorded before the snapshot vanished in "
                "the resumed run (first-wins fps never change)",
            ))
    elif contract != "incomparable" and not violations:
        # verdict parity holds under EVERY comparable contract
        for p in props:
            if not p["match"]:
                violations.append(_violation(
                    "verdict_parity", f"properties.{p['name']}",
                    p["a"], p["b"],
                    "property verdicts must agree for every comparable "
                    "flag delta",
                ))
        if contract in _COUNT_CONTRACTS:
            # a cross-ENGINE pair gates unique + verdicts only: host
            # checkers count generated states differently and do not
            # track max_depth (the engine-parity pin is the unique
            # count + discoveries, exactly like bench's gates)
            engine_differs = "engine" in delta
            gated = ("unique", "done")
            if not engine_differs:
                gated = ("states", "unique", "max_depth", "done")
            for k in gated:
                if not blocks["totals"][k]["match"]:
                    violations.append(_violation(
                        "counts_must_match", f"totals.{k}",
                        ta.get(k), tb.get(k),
                        "this flag delta promises bit-identical counts",
                    ))
            cart = blocks["cartography"]
            # a sweep-instance side estimates its depth histogram with
            # an exact per-instance bincount, while the wavefront's live
            # histogram is the sorted-prefix approximation
            # (ops/cartography.queue_depth_hist) — two estimators of the
            # same quantity, equal only when append windows never
            # straddle BFS levels, so depth-profile parity is not gated
            # across a sweep pair (docs/sweep.md)
            # (the JAX sweep's engine is "sweep", the port's "gpu-sweep")
            sweep_pair = any(
                str((x.get("config") or {}).get("engine")).endswith("sweep")
                for x in (a_s, b_s)
            )
            cart_drift = (
                cart.get("match") is False
                if not engine_differs
                # same narrowing across engines: the depth histogram and
                # fresh-insert count are unique-derived and comparable;
                # duplicate_hits/action_hist are generated-state-derived
                else (
                    (
                        not sweep_pair
                        and cart.get("depth_hist", {}).get("match")
                        is False
                    )
                    or cart.get("fresh_inserts", {}).get("match") is False
                )
            )
            if cart_drift:
                violations.append(_violation(
                    "counts_must_match", "cartography",
                    None, None,
                    "search-shape counters must agree when counts are "
                    "promised bit-identical",
                ))
        if contract in ("same", "observability"):
            # strongest form: every deterministic block present on BOTH
            # sides must agree verbatim (presence may differ — the
            # observability flags add/remove blocks, nothing else)
            for key in ("memory", "roofline", "por", "spill",
                        "growth_events", "audit", "sanitizer"):
                va, vb = a_s.get(key), b_s.get(key)
                if va is not None and vb is not None and va != vb:
                    violations.append(_violation(
                        "block_must_match", key, None, None,
                        f"the deterministic {key!r} block differs under "
                        "a same-config/observability-only delta",
                    ))
        if contract == "isomorphic":
            # a reduction may only shrink the explored space: when
            # exactly one side runs the reducing flag, it must not
            # explore MORE than the full-expansion side
            for flag in ("flags.por", "flags.symmetry"):
                d = delta.get(flag)
                if d is None:
                    continue
                red, full = (tb, ta) if d["b"] else (ta, tb)
                # generated-state counts are engine-specific (the totals
                # gate's rule): across an engine delta only the unique
                # count carries the reduction-direction promise
                grow_keys = (
                    ("unique",) if "engine" in delta
                    else ("states", "unique")
                )
                for k in grow_keys:
                    if (
                        isinstance(red.get(k), int)
                        and isinstance(full.get(k), int)
                        and red[k] > full[k]
                    ):
                        violations.append(_violation(
                            "reduction_grew", f"totals.{k}",
                            full[k], red[k],
                            f"the {flag.split('.')[1]} side explored MORE "
                            "than full expansion — a reduction can only "
                            "shrink the space",
                        ))
        # (contract "unknown" — pre-registry reports with no config
        # block — adds no gate beyond the verdict-parity loop above)

    counts_equal = all(
        blocks["totals"][k]["match"]
        for k in ("states", "unique", "max_depth")
    )
    if violations:
        verdict = DIVERGENT
    elif lineage is not None:
        verdict = IDENTICAL
    elif contract in ("same", "observability", "identical"):
        verdict = IDENTICAL
    elif contract == "perf":
        verdict = PERF_ONLY
    else:  # isomorphic / unknown
        verdict = IDENTICAL if counts_equal else ISOMORPHIC

    out = {
        "v": DIFF_V,
        "verdict": verdict,
        "contract": contract,
        "config_delta": delta,
        "blocks": blocks,
        "violations": violations,
    }
    if lineage is not None:
        out["lineage"] = lineage
    return out


def _phase_seq(timeline) -> list:
    """Deduplicated phase sequence of a health timeline (the rendering
    the report's markdown uses)."""
    out: list = []
    for e in timeline or []:
        if not out or out[-1] != e.get("phase"):
            out.append(e.get("phase"))
    return out


def render_diff(d: dict, label_a: str = "a", label_b: str = "b") -> str:
    """Human rendering of a :func:`diff_reports` result: verdict first,
    then the deltas a reader acts on."""
    lines = [f"verdict: {d['verdict']} (contract: {d['contract']})"]
    for k, dd in (d.get("config_delta") or {}).items():
        lines.append(
            f"  config {k}: {dd['a']!r} -> {dd['b']!r} [{dd['class']}]"
        )
    lin = d.get("lineage")
    if lin:
        lines.append(
            f"  lineage: {label_b} resumed from {label_a} "
            f"(parent run {lin['parent']})"
        )
    t = d["blocks"]["totals"]
    bits = []
    for k in ("states", "unique", "max_depth"):
        p = t[k]
        if p["match"]:
            bits.append(f"{k}={p['a']}")
        else:
            bits.append(f"{k} {p['a']} -> {p['b']} ({p.get('delta'):+d})"
                        if isinstance(p.get("delta"), int)
                        else f"{k} {p['a']} -> {p['b']}")
    lines.append("  totals: " + ", ".join(bits))
    for p in d["blocks"]["properties"]:
        mark = "parity" if p["match"] else "MISMATCH"
        lines.append(
            f"  property `{p['name']}` ({p['expectation']}): "
            f"a={p['a']} b={p['b']} — {mark}"
        )
    perf = d["blocks"].get("perf")
    if perf:
        sp = perf.get("states_per_sec") or {}
        if sp.get("a") is not None or sp.get("b") is not None:
            lines.append(
                f"  throughput: {sp.get('a')} -> {sp.get('b')} states/s"
            )
    if d["violations"]:
        lines.append(f"  violations ({len(d['violations'])}):")
        for v in d["violations"]:
            lines.append(
                f"    [{v['rule']}] {v['field']}: a={v['a']!r} "
                f"b={v['b']!r} — {v['detail']}"
            )
    else:
        lines.append("  violations: none")
    return "\n".join(lines)
