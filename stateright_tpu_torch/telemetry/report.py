"""Post-run report: the artifact a human reads after an unattended run.

The port's own copy of ``stateright_tpu/telemetry/report.py``.  Two
differences: :func:`build_config` names the device from the checker's own
``torch.device`` (``torch.cuda.get_device_name`` for a ``cuda`` run,
``"cpu"`` otherwise) and never imports ``jax``; and the port's GPU engine
reports itself as ``gpu-wavefront`` (:func:`engine_tag`), so a JAX report
and a port report of the same instance share a ``config_key`` apart from
the engine and device aspects.  The ``roofline`` block is the cost
model's static block (``analysis/costmodel.py``: walks of the captured
kernels and the hand-written kernels' counts), and the ``audit`` and
``sanitizer`` blocks summarize ``model._audit_report``, which the
``spawn_gpu`` preflight leaves (JAX report.py:274-284, :337-351).

``write_report(checker, path)`` renders one completed check into a JSON
document at ``path`` plus a sibling markdown rendering (``path`` with the
extension swapped for ``.md``) — combining the run totals, the search
cartography (``ops/cartography.py``), the deterministic health timeline
(``health.phase_timeline``), growth events, the memory ledger's analytic
block and the durability config.  Wired as ``CheckerBuilder.report(PATH)``
(written at the first ``join()`` after completion) and the per-example
``report`` CLI verb.

Determinism contract (pinned by ``tests/test_torch_run_ledger.py``): for a
fixed model/config the JSON body is byte-stable across runs — every field
is count-derived (state totals, histograms, phase transitions at step
granularity, growth capacity ladders), and the single volatile field is
the ``generated_at`` header stamped at write time.  Wall-clock data
(stage attribution, throughput, EWMA series) varies run to run and lives
in the MARKDOWN rendering only, clearly sectioned as non-deterministic.

Schema versioning: ``v`` (:data:`REPORT_V`) at the top level; the
embedded cartography block carries its own ``v``
(``ops.cartography.CARTOGRAPHY_V``).

Run identity (docs/telemetry.md "Comparing runs"): the deterministic
body carries a ``config`` block — the canonical run configuration
(model, instance signature, engine, flag set, encoding, device spec,
git rev) plus its 16-hex ``key`` (:func:`config_key`) — and the written
document additionally carries a ``run_id`` (and, for runs resumed from
a snapshot, the parent's ``parent_run_id``) in the volatile header next
to ``generated_at``.  :data:`VOLATILE_KEYS` is the SCHEMA for what is
volatile: the diff engine (``telemetry/diff.py``) scrubs exactly this
tuple, so a new volatile header field is ignored there automatically
instead of by hand-listing.
"""

from __future__ import annotations

import json
import os
from typing import Optional

from .health import phase_timeline

REPORT_V = 1

# volatile identity/header fields stamped at write time — everything a
# cross-run diff must ignore lives HERE (telemetry/diff.py consults this
# tuple at diff time; never hand-list these downstream)
VOLATILE_KEYS = (
    "generated_at", "run_id", "parent_run_id",
    # sweep-instance archives (stateright_tpu/sweep/, docs/sweep.md):
    # the sweep's run id + the member key ride the header so a sweep
    # instance diffs cleanly against its sequential oracle run
    "sweep_id", "instance_key",
    # fleet-campaign archives (stateright_tpu/fleet/, docs/fleet.md):
    # the campaign id + tenant key group a fleet's jobs in the run
    # list, and a fleet job must diff IDENTICAL against its solo run
    "campaign_id", "job_key",
)

# growth-record fields that are count-derived (the record's ``t``/``seq``
# are wall-clock/ordering bookkeeping and stay out of the report body)
_GROWTH_KEYS = ("status", "unique", "cap", "qcap", "cand", "fcap", "bucket")


def _expectation_name(prop) -> str:
    # Expectation is a proper enum; its .name is ALWAYS/SOMETIMES/...
    return getattr(prop.expectation, "name", str(prop.expectation)).lower()


def _git_dir(root) -> Optional["pathlib.Path"]:
    """The git directory of the checkout at ``root``: ``root/.git`` when
    it is a directory, the target of its ``gitdir:`` line when it is a
    file (a ``git worktree``), else None."""
    import pathlib

    dot = root / ".git"
    if dot.is_dir():
        return dot
    if dot.is_file():
        line = dot.read_text().strip()
        if line.startswith("gitdir:"):
            target = pathlib.Path(line.split(":", 1)[1].strip())
            target = target if target.is_absolute() else root / target
            if target.is_dir():
                return target
    return None


def _git_rev(root=None) -> Optional[str]:
    """Short git revision of the checkout this package runs from, or None.

    Looks only at the package's own checkout root (the directory that
    holds ``stateright_tpu_torch/``), never above it: a ``git archive``
    copy has no ``.git`` and gets None, not the revision of whatever
    repository happens to enclose it.  Plain file reads, no subprocess —
    the report writer must never fork."""
    import pathlib

    root = pathlib.Path(root) if root is not None else (
        pathlib.Path(__file__).resolve().parents[2])
    try:
        gd = _git_dir(root)
        if gd is None:
            return None
        head = gd / "HEAD"
        if not head.is_file():
            return None
        ref = head.read_text().strip()
        if not ref.startswith("ref:"):
            return ref[:12]  # detached HEAD: the hash itself
        name = ref.split(None, 1)[1]
        # a worktree's refs live in the main repository's git dir
        dirs = [gd]
        common = gd / "commondir"
        if common.is_file():
            c = pathlib.Path(common.read_text().strip())
            dirs.append(c if c.is_absolute() else gd / c)
        for d in dirs:
            ref_path = d / name
            if ref_path.is_file():
                return ref_path.read_text().strip()[:12]
        for d in dirs:
            packed = d / "packed-refs"
            if packed.is_file():
                for line in packed.read_text().splitlines():
                    if line.endswith(" " + name):
                        return line.split()[0][:12]
        return None
    except OSError:
        return None


def engine_tag(checker) -> str:
    """The engine's name in reports and registry records: the GPU engine's
    ``_report_engine`` (``gpu-wavefront``), else the checker's class name
    (the host checkers, as in the JAX package)."""
    return getattr(checker, "_report_engine", None) or type(checker).__name__


def device_name(checker) -> str:
    """The device a run used: the CUDA device's name for a ``cuda`` run,
    ``"cpu"`` for a CPU run and for every host checker."""
    dev = getattr(checker, "device", None)
    if dev is not None and getattr(dev, "type", None) == "cuda":
        import torch

        return str(torch.cuda.get_device_name(dev))
    return "cpu"


def config_key(config: dict) -> str:
    """Canonical 16-hex key over a ``config`` block (minus the ``key``
    field itself): sorted-key compact JSON, sha256-truncated.  Two runs
    share a ``config_key`` iff they are the same measurement
    configuration — the grouping key for registry trends."""
    import hashlib

    body = {k: v for k, v in config.items() if k != "key"}
    blob = json.dumps(body, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def build_config(checker) -> dict:
    """The report's deterministic ``config`` block: the canonical run
    configuration the diff engine classifies flag deltas over
    (``telemetry/diff.py``; docs/telemetry.md "Comparing runs").

    ``instance.sig`` hashes the init-state fingerprints + tensor shape +
    property count, so different instance arguments (paxos-2 vs paxos-3)
    get different keys without per-model plumbing; ``flags`` records the
    feature set the engines actually resolved (builder + env knobs);
    ``device``/``git_rev`` pin where and at what revision the run
    happened (perf-class aspects for the diff)."""
    import hashlib

    model = checker.model
    # instance identity must be ENGINE-INDEPENDENT (a wavefront-vs-BFS
    # pair of the same instance is comparable): host checkers carry no
    # .tensor, so fall back to the model's cached twin — init
    # fingerprints alone can coincide across instance sizes (all-zero
    # init rows; the _model_sig rationale), the tensor shape breaks the
    # tie
    tensor = getattr(checker, "tensor", None)
    if tensor is None:
        try:
            from ..parallel.tensor_model import twin_or_none

            tensor = twin_or_none(model)
        except Exception:  # noqa: BLE001 - identity must never break
            tensor = None
    props = list(model.properties())
    try:
        fps = sorted(
            int(model.fingerprint_state(s)) for s in model.init_states()
        )
    except Exception:  # noqa: BLE001 - identity must never break a report
        fps = []
    sig_src = fps + [
        int(getattr(tensor, "width", 0) or 0),
        int(getattr(tensor, "max_actions", 0) or 0),
        len(props),
    ] + sorted(p.name for p in props)
    sig = hashlib.sha256(json.dumps(sig_src).encode()).hexdigest()[:16]
    flags = {
        "telemetry": getattr(checker, "flight_recorder", None) is not None,
        "cartography": bool(getattr(checker, "_cartography", False)),
        "memory": getattr(checker, "_mem_ledger", None) is not None,
        "roofline": getattr(checker, "_roofline_ledger", None) is not None,
        "checked": bool(getattr(checker, "_checked", False)),
        "prededup": bool(getattr(checker, "_prededup", False)),
        "spill": bool(getattr(checker, "_spill", False)),
        # MXU recast round (ops/mxu.py): a perf-class knob — counts are
        # contractually bit-identical, only the step program's shapes
        # change (the diff engine classifies an on/off pair PERF-ONLY)
        "mxu": getattr(checker, "_mxu", None) is not None,
        # sweep membership (stateright_tpu/sweep/): per-instance counts
        # are contractually bit-identical to the sequential run, so the
        # diff engine classes the flag "identical" (docs/sweep.md)
        "sweep": bool(getattr(checker, "_is_sweep_instance", False)),
        # active reduction only: a por() run that FELL BACK ran full
        # expansion and must diff as such (the fallback reason lives in
        # the por block)
        "por": bool(getattr(checker, "_por", False)),
        "symmetry": getattr(checker, "_symmetry", None) is not None,
        "prewarm": bool(getattr(checker, "_prewarm", False)),
        "pallas": bool(getattr(checker, "_pallas", False)),
        "compile_cache": bool(
            getattr(checker, "_compile_cache_dir", None)
        ),
    }
    try:
        device = device_name(checker)
    except Exception:  # noqa: BLE001 - identity must never break a report
        device = None
    # the prefix target is instance identity (a 4000-state prefix is a
    # different measurement than the full enumeration): device engines
    # and mp store it as _target, the thread-pool checkers keep only the
    # builder options
    target = getattr(checker, "_target", None)
    if target is None:
        target = getattr(
            getattr(checker, "_options", None), "target_state_count", None
        )
    cfg = {
        "model": type(model).__name__,
        "instance": {
            "sig": sig,
            "target": target,
        },
        "engine": engine_tag(checker),
        "encoding": getattr(tensor, "network_encoding", None),
        "flags": flags,
        "device": device,
        "git_rev": _git_rev(),
    }
    cfg["key"] = config_key(cfg)
    return cfg


def build_report(checker) -> dict:
    """The deterministic report body (no ``generated_at``; JSON-safe).

    Works on any completed checker; sections appear only when their data
    source exists (cartography needs ``.telemetry(cartography=True)``,
    growth/health need a flight recorder, memory needs the ledger)."""
    model = checker.model
    props = list(model.properties())
    disc = checker.discoveries()
    # is_done() means STOPPED, not "space exhausted": a deadline-cut run
    # is done-in-that-sense but incomplete, and the report is exactly the
    # artifact that must not claim otherwise
    timed_out = bool(getattr(checker, "timed_out", False))
    done = checker.is_done() and not timed_out
    totals = {
        "states": checker.state_count(),
        "unique": checker.unique_state_count(),
        "max_depth": getattr(checker, "max_depth", lambda: None)(),
        "done": done,
    }
    if timed_out:
        totals["timed_out"] = True
    out: dict = {
        "v": REPORT_V,
        "model": type(model).__name__,
        "engine": engine_tag(checker),
        # canonical run configuration + config_key (deterministic for a
        # fixed model/config/machine/checkout): what the registry indexes
        # and the diff engine classifies flag deltas over
        "config": build_config(checker),
        "totals": totals,
        "properties": [
            {
                "name": p.name,
                "expectation": _expectation_name(p),
                "discovery": p.name in disc,
            }
            for p in props
        ],
    }
    cart = None
    if hasattr(checker, "cartography"):
        cart = checker.cartography()
    if cart is not None:
        out["cartography"] = cart
    # memory ledger (telemetry/memory.py): the DETERMINISTIC analytic
    # block only — per-buffer bytes at the final capacities + the next
    # rung's growth-transient forecast.  Live device stats and the
    # machine-local budget stay OUT of the JSON body (they vary by
    # machine and moment; the markdown rendering carries them instead).
    mem_fn = getattr(checker, "memory", None)
    if callable(mem_fn):
        mem = mem_fn(live=False)
        if mem is not None:
            out["memory"] = mem
    # roofline cost ledger (telemetry/roofline.py): the DETERMINISTIC
    # static block only -- per-stage FLOPs/bytes, op classes, per-action
    # attribution, the tensor-core candidates.  The kernels' counts beside
    # their plain walks, the card's spec and the achieved share stay out of
    # the JSON body; the markdown carries the latter two
    roof_fn = getattr(checker, "roofline", None)
    if callable(roof_fn):
        roof = roof_fn(live=False)
        if roof is not None:
            out["roofline"] = roof
    # partial-order reduction (JAX report.py:285-293): the network
    # encoding, the fallback reason when reduction is off, and the
    # reduced-vs-full tallies, count-derived for a fixed model and
    # configuration, so the block stays as deterministic as the cartography
    por_fn = getattr(checker, "por_status", None)
    if callable(por_fn):
        por = por_fn()
        if por is not None:
            out["por"] = por
    # spill tier (spill/): count-derived for a fixed model, configuration
    # and budget (evictions fire at deterministic growth boundaries and the
    # Bloom words are a function of the spilled set), so the block stays
    # as deterministic as the cartography
    sp_fn = getattr(checker, "spill_status", None)
    if callable(sp_fn):
        sp = sp_fn()
        if sp is not None:
            out["spill"] = sp
    # durability (stateright_tpu/checkpoint.py + supervisor.py,
    # docs/robustness.md): the DETERMINISTIC subset only — the autosave
    # cadence config, the supervised restart count, and the degradation
    # events.  Generation counts / checkpoint ages are wall-clock-shaped
    # and live in the markdown rendering, like throughput.
    dur_fn = getattr(checker, "durability_status", None)
    if callable(dur_fn):
        dur = dur_fn(live=False)
        if dur is not None:
            out["durability"] = dur
    rec = getattr(checker, "flight_recorder", None)
    if rec is not None:
        growth = []
        for r in rec.records("growth"):
            growth.append(
                {k: r[k] for k in _GROWTH_KEYS if k in r}
            )
        out["growth_events"] = growth
        if rec.kind_count("growth") > len(growth):
            out["growth_events_truncated"] = True
        # the COUNT-derived health replay (health.py separates this from
        # the wall-clock EWMA/ETA signals, which never enter the report).
        # The ring is a bounded window: a run with more syncs than the
        # telemetry capacity loses its earliest steps, and a timeline
        # replayed from a mid-run prefix misclassifies phases (the true
        # peak is gone) — flag it instead of silently presenting the
        # window as the whole run.
        steps = rec.records("step")
        out["health_timeline"] = phase_timeline(steps)
        if rec.kind_count("step") > len(steps):
            out["health_timeline_truncated"] = True
        out["final_phase"] = (
            "done" if done else rec.health().get("phase")
        )
    audit = getattr(model, "_audit_report", None)
    if audit is not None:
        out["audit"] = {
            "ok": audit.ok,
            "errors": len(audit.errors),
            "warnings": len(audit.warnings),
            "rules": sorted({f.rule_id for f in audit.findings}),
        }
        sanitizer = (audit.metrics or {}).get("sanitizer")
        if sanitizer is not None:
            out["sanitizer"] = {
                k: sanitizer.get(k)
                for k in ("sites", "proved", "undecided", "rules")
            }
            out["sanitizer"]["checked_run"] = bool(
                getattr(checker, "_checked", False))
    return out


def _bar(n: int, peak: int, width: int = 30) -> str:
    if peak <= 0:
        return ""
    return "#" * max(1 if n else 0, round(width * n / peak))


def _hist_lines(values, label_of) -> list:
    peak = max(values) if values else 0
    return [
        f"  {label_of(i):>12}  {v:>10}  {_bar(v, peak)}"
        for i, v in enumerate(values)
    ]


def render_markdown(report: dict, rec=None, roofline_live=None) -> str:
    """Human rendering of a report body.  ``rec`` (the run's live
    FlightRecorder) adds the WALL-CLOCK section — stage attribution,
    throughput and the live device memory — which is deliberately absent
    from the JSON body (it varies run to run).  ``roofline_live``
    (``checker.roofline()``'s default view) adds the card's spec, the
    stage verdicts and the achieved estimate."""
    t = report.get("totals", {})
    lines = [
        f"# Run report — {report.get('model')} ({report.get('engine')})",
        "",
        f"- states generated: **{t.get('states')}**",
        f"- unique states: **{t.get('unique')}**",
        f"- max depth: **{t.get('max_depth')}**",
        f"- completed: **{t.get('done')}**"
        + (" (cut short by the run deadline)" if t.get("timed_out") else ""),
        "",
        "## Properties",
        "",
    ]
    for p in report.get("properties", []):
        verdict = (
            "discovery found" if p["discovery"] else "no discovery"
        )
        lines.append(f"- `{p['name']}` ({p['expectation']}): {verdict}")
    cart = report.get("cartography")
    if cart:
        lines += ["", "## Search cartography", "", "Depth histogram "
                  "(fresh inserts per BFS depth):", "```"]
        lines += _hist_lines(cart.get("depth_hist", []), lambda i: f"d={i}")
        lines += ["```", "", "Action histogram (successors generated per "
                  "action slot):", "```"]
        lines += _hist_lines(
            cart.get("action_hist", []), lambda i: f"a{i}"
        )
        lines += ["```", ""]
        lines.append(
            f"- fresh inserts: {cart.get('fresh_inserts')}  /  "
            f"duplicate hits: {cart.get('duplicate_hits')}"
        )
        for p in cart.get("props", []):
            lines.append(
                f"- property `{p['name']}`: evaluated {p['evaluated']} "
                f"rows, condition held on {p['condition_hits']}"
            )
    mem = report.get("memory")
    if mem:
        from .memory import fmt_bytes

        lines += ["", "## Memory (analytic)", ""]
        lines.append(
            f"- device-resident carry: **{fmt_bytes(mem.get('total_bytes'))}**"
            f" at capacity {mem.get('capacity')}"
            + (
                f" over {mem['devices']} device(s) "
                f"({fmt_bytes(mem.get('per_device_bytes'))}/device)"
                if mem.get("devices")
                else ""
            )
        )
        nxt = mem.get("next_rung") or {}
        if nxt:
            lines.append(
                f"- next growth rung (capacity {nxt.get('capacity')}): "
                f"{fmt_bytes(nxt.get('total_bytes'))} steady, "
                f"{fmt_bytes(nxt.get('transient_bytes'))} migration "
                "transient (old + new carry live across the swap)"
            )
        buffers = mem.get("buffers") or {}
        if buffers:
            top = sorted(
                buffers.items(), key=lambda kv: kv[1], reverse=True
            )[:6]
            lines.append(
                "- largest buffers: "
                + ", ".join(f"{k}={fmt_bytes(v)}" for k, v in top)
            )
    roof = report.get("roofline")
    if roof:
        from .memory import fmt_bytes

        lines += ["", "## Roofline (static cost model)", ""]
        lines.append(
            f"- per-step analytic totals: **{roof['totals'].get('flops'):,}"
            f" FLOPs**, **{fmt_bytes(roof['totals'].get('bytes'))} moved**"
            + (f" (intensity {roof['totals']['intensity']} FLOPs/byte)"
               if roof["totals"].get("intensity") is not None else ""))
        lines += ["", "| stage | FLOPs | bytes | intensity | top class |",
                  "|---|---|---|---|---|"]
        for name, st in (roof.get("stages") or {}).items():
            classes = st.get("classes") or {}
            top = max(classes, key=lambda k: classes[k]["bytes"],
                      default="-") if classes else "-"
            lines.append(
                f"| {name} | {st.get('flops'):,} | "
                f"{fmt_bytes(st.get('bytes_read', 0) + st.get('bytes_written', 0))}"
                f" | {st.get('intensity', '-')} | {top} |")
        for c in (roof.get("mxu_candidates") or [])[:4]:
            lines.append(
                f"- tensor-core candidate #{c['rank']}: `{c['op']}` in "
                f"`{c['stage']}` moving {fmt_bytes(c['bytes'])}/step "
                f"({c['rule']})")
    por = report.get("por")
    if por:
        lines += ["", "## Partial-order reduction", ""]
        enc = por.get("encoding")
        lines.append(
            f"- network encoding: **{enc or 'model-specific twin'}**"
            + (
                "" if enc != "slot-multiset" else
                " (delivery writes are message DATA here — re-compile "
                "with per_channel_() for real reduction; JX305)"
            )
        )
        if por.get("enabled"):
            lines.append(
                f"- rows expanded with a reduced ample set: "
                f"**{por.get('rows_reduced', 0)}** "
                f"({por.get('candidates_masked', 0)} candidates never "
                f"generated; {por.get('rows_full_proviso', 0)} "
                "proviso-forced full re-expansions)"
            )
        else:
            lines.append(
                f"- reduction fell back to full expansion: "
                f"{por.get('fallback')}"
            )
    sp = report.get("spill")
    if sp:
        from .memory import fmt_bytes

        lines += ["", "## Spill tier", ""]
        lines.append(
            f"- evictions: **{sp.get('evictions')}** — "
            f"{sp.get('spilled_fps')} fingerprints off-device "
            f"(host {fmt_bytes(sp.get('host_bytes'))}, "
            f"disk {fmt_bytes(sp.get('disk_bytes'))}, "
            f"index {fmt_bytes(sp.get('index_bytes'))})"
        )
        lines.append(
            f"- Bloom filter: {sp.get('bloom_bits')} bits, "
            f"k={sp.get('bloom_k')}, est. false-positive rate "
            f"{sp.get('bloom_est_false_pos')}"
        )
        lines.append(
            f"- deferred to host resolution: {sp.get('deferred')} "
            f"candidates ({sp.get('resolved_dups')} true duplicates, "
            f"{sp.get('resolved_novel')} Bloom false positives "
            "re-injected)"
        )
        if sp.get("queue_offloaded"):
            lines.append(
                f"- queue overflow: {sp.get('queue_offloaded')} frontier "
                f"rows offloaded to host, {sp.get('queue_refilled')} "
                "refilled"
            )
    dur = report.get("durability")
    if dur:
        lines += ["", "## Durability", ""]
        auto = dur.get("autosave")
        if auto:
            lines.append(
                f"- autosave: every {auto.get('every_secs')}s, newest "
                f"{auto.get('keep')} generations kept"
                + (
                    f" ({auto.get('generations')} written this run"
                    + (
                        f", last age {auto.get('last_checkpoint_age_secs')}s"
                        if auto.get("last_checkpoint_age_secs") is not None
                        else ""
                    )
                    + ")"
                    if auto.get("generations") is not None
                    else ""
                )
            )
            if auto.get("failures"):
                lines.append(
                    f"- **{auto['failures']} checkpoint write(s) FAILED** "
                    "— durability degraded (docs/robustness.md)"
                )
        lines.append(f"- supervised restarts: **{dur.get('restarts', 0)}**")
        for d in dur.get("degradations", []):
            lines.append(f"- degradation: `{d}`")
    timeline = report.get("health_timeline")
    # a truncated-to-empty window (a tiny ring whose tail slots went to
    # span/health records) still owes the reader the truncation note —
    # hiding the whole section would present the mid-run cut as "no
    # timeline recorded"
    if timeline or report.get("health_timeline_truncated"):
        lines += ["", "## Health timeline (count-derived)", ""]
        if report.get("health_timeline_truncated"):
            lines.append(
                "- **truncated**: the run outlived the telemetry ring; "
                "this timeline starts mid-run (raise "
                "`.telemetry(capacity=...)` for the full series)"
            )
        prev = None
        for e in timeline or []:
            if e["phase"] != prev:
                lines.append(
                    f"- step {e['step']}: phase `{e['phase']}` "
                    f"(unique={e['unique']}, novelty={e['novelty']})"
                )
                prev = e["phase"]
        lines.append(f"- final phase: `{report.get('final_phase')}`")
    growth = report.get("growth_events")
    if growth is not None:
        lines += ["", "## Growth events", ""]
        if report.get("growth_events_truncated"):
            lines.append("- **truncated**: earliest growths evicted "
                         "from the telemetry ring")
        if not growth:
            lines.append("- none (buffers pre-sized for the space)")
        for g in growth:
            caps = ", ".join(
                f"{k}={v}" for k, v in g.items()
                if k not in ("status", "unique")
            )
            lines.append(
                f"- `{g.get('status')}` at unique={g.get('unique')} "
                f"({caps})"
            )
    audit = report.get("audit")
    if audit:
        lines += ["", "## Audit / sanitizer", "",
                  f"- audit: {'CLEAN' if audit['ok'] else 'ERRORS'} "
                  f"({audit['errors']} error(s), {audit['warnings']} "
                  f"warning(s); rules: "
                  f"{', '.join(audit['rules']) or 'none'})"]
        san = report.get("sanitizer")
        if san:
            lines.append(
                f"- sanitizer: {san.get('sites')} indexed site(s), "
                f"{san.get('proved')} proved in range, "
                f"{san.get('undecided')} undecided; checked run: "
                f"{san.get('checked_run')}")
    if rec is not None:
        # everything below varies run to run — markdown only, never JSON
        lines += ["", "## Wall clock (non-deterministic)", ""]
        summary = rec.summary()
        if summary.get("wall_secs") is not None:
            lines.append(f"- wall: {summary['wall_secs']}s")
        if summary.get("states_per_sec") is not None:
            lines.append(
                f"- throughput: {summary['states_per_sec']} states/s"
            )
        stages = rec.stages()
        if stages:
            for k, v in stages.items():
                lines.append(f"- {k}: {v}")
        # the roofline's wall-clock half (telemetry/roofline.py): the
        # card's spec, per-stage verdicts and the achieved estimate
        roofl = roofline_live or (
            rec.roofline() if hasattr(rec, "roofline") else None)
        if roofl:
            spec = roofl.get("device_spec")
            if spec:
                lines.append(
                    f"- roofline device spec: {spec.get('name')} "
                    f"(tensor-core peak {spec.get('mxu_peak'):.3g} FLOP/s, "
                    f"CUDA-core peak {spec.get('vpu_peak'):.3g} FLOP/s, "
                    f"memory {spec.get('hbm_bytes_per_sec'):.3g} B/s; "
                    f"{spec.get('src')})")
            verdicts = roofl.get("verdicts") or {}
            bound = [f"{k}={v['verdict']}" for k, v in verdicts.items()
                     if v.get("verdict") != "unknown"]
            if bound:
                lines.append("- stage roofline verdicts: " + ", ".join(bound))
            ach = roofl.get("achieved")
            if ach:
                bits = [f"{ach['bytes_per_sec']:.3g} B/s",
                        f"{ach['flops_per_sec']:.3g} FLOP/s"]
                if ach.get("frac_of_hbm_ceiling") is not None:
                    bits.append(f"{100 * ach['frac_of_hbm_ceiling']:.2f}% of "
                                "the memory ceiling")
                lines.append("- achieved (est., device time): "
                             + ", ".join(bits))
        live = rec.memory()
        if live and (live.get("device") or live.get("budget_bytes")):
            from .memory import fmt_bytes

            dev = live.get("device") or {}
            bits = []
            if dev.get("bytes_in_use") is not None:
                bits.append(f"in use {fmt_bytes(dev['bytes_in_use'])}")
            if dev.get("peak_bytes_in_use") is not None:
                bits.append(f"peak {fmt_bytes(dev['peak_bytes_in_use'])}")
            if live.get("budget_bytes"):
                bits.append(
                    f"budget {fmt_bytes(live['budget_bytes'])} "
                    f"({live.get('budget_src')})"
                )
            if bits:
                lines.append("- device memory: " + ", ".join(bits))
    lines.append("")
    return "\n".join(lines)


def identity_doc(checker, body: dict) -> dict:
    """The written run-report document: the volatile identity header
    (exactly :data:`VOLATILE_KEYS` — the stamp, the run id, and for
    snapshot-resumed runs the parent's id, so the registry links
    kill+resume chains) ahead of the deterministic ``body``.  The ONE
    header assembly, shared by :func:`write_report` and the run
    registry — a new volatile field lands here and in
    :data:`VOLATILE_KEYS` together."""
    import datetime

    doc = {
        "generated_at": datetime.datetime.now(datetime.timezone.utc)
        .isoformat(timespec="seconds"),
        "run_id": getattr(checker, "run_id", None),
    }
    parent = getattr(checker, "parent_run_id", None)
    if parent:
        doc["parent_run_id"] = parent
    doc.update(body)
    return doc


def write_report(checker, path: str) -> dict:
    """Render ``checker`` into ``path`` (JSON) + the sibling markdown.

    Returns the deterministic body (without the ``generated_at`` header
    stamped into the file).  The JSON is written with sorted keys OFF —
    insertion order is part of the pinned byte layout — and a trailing
    newline."""
    if os.path.splitext(path)[1] == ".md":
        # The markdown sibling is derived by swapping the extension; a .md
        # target would collapse both renderings onto one file and the JSON
        # body would be silently overwritten.
        raise ValueError(
            f"report path {path!r} ends in .md — pass the JSON path; the "
            "markdown rendering lands next to it as <path-stem>.md"
        )
    from ._atomic import atomic_write_json, atomic_write_text

    body = build_report(checker)
    doc = identity_doc(checker, body)
    # atomic (docs/robustness.md): a crash mid-write leaves the previous
    # report intact, never a torn JSON a later diff/regress gate chokes on
    atomic_write_json(path, doc)
    md_path = os.path.splitext(path)[0] + ".md"
    rec = getattr(checker, "flight_recorder", None)
    roof_fn = getattr(checker, "roofline", None)
    roofline_live = roof_fn() if callable(roof_fn) else None
    # the live durability view (generation counts, checkpoint age) rides
    # the markdown like the rest of the wall-clock data
    md_body = dict(body)
    dur_fn = getattr(checker, "durability_status", None)
    if callable(dur_fn):
        live_dur = dur_fn(live=True)
        if live_dur is not None:
            md_body["durability"] = live_dur
    atomic_write_text(
        md_path,
        render_markdown(md_body, rec=rec, roofline_live=roofline_live),
    )
    return body
