"""The Explorer: a web UI for interactively browsing a state space.

The port's own copy of ``stateright_tpu/explorer.py``.  Its HTTP surface
mirrors the reference server (``src/checker/explorer.rs``):

 - ``GET /.status`` — JSON ``{done, model, state_count, unique_state_count,
   properties: [[expectation, name, encoded_discovery_path|null], ...],
   recent_path}`` (reference ``StatusView``, ``explorer.rs:12-22,133-157``),
   plus the ``audit``, ``sanitizer``, ``por``, ``independence`` and
   ``table`` blocks of the JAX Explorer (:113).
 - ``GET /.states/`` — one view per init state (``explorer.rs:186-198``).
 - ``GET /.states/{fp1}/{fp2}/...`` — follows the fingerprint path by
   re-executing the model (``Path.from_fingerprints``), then returns one view
   per enabled action of the final state: ``{action, outcome, state,
   fingerprint, svg}``; ignored (no-op) actions are returned with no state
   (``explorer.rs:199-232``); unknown fingerprints give 404
   (``explorer.rs:233-237``).
 - ``GET /.metrics`` — the run's flight-recorder telemetry
   (``telemetry/``): ``{summary, series, occupancy, counters, health,
   cartography, memory, spill, roofline, durability, fleet}`` for runs
   spawned with ``.telemetry()``; telemetry off returns the stable error
   body ``{"error": "telemetry_disabled", "hint": ...}`` with 404.
 - ``GET /.runs``, ``/.runs/{run_id}``, ``/.runs/diff/{a}/{b}`` — the run
   registry's index and per-config trends, one archived report, and the
   contract-aware diff of two archived runs (``telemetry/registry.py``,
   ``telemetry/diff.py``).  Errors use the same stable ``{"error",
   "hint"}`` shape: ``registry_disabled``, ``unknown_run``,
   ``bad_diff_request``.
 - ``GET /metrics`` — the Prometheus text exposition of the metrics bus
   (``telemetry/metrics.py``): the engine families published at host syncs
   and the fleet's pool families.  Always 200.
 - ``GET /.progress`` / ``GET /.progress/{job}`` — the ``progress.json``
   heartbeat (``checkpoint.ProgressHeartbeat``) of the served root or of
   one fleet job under ``<root>/jobs/``, with its liveness verdict
   (``progress_disabled``, ``bad_job_key`` and ``no_heartbeat`` are its
   error bodies).
 - ``GET /`` — the bundled single-page UI (``ui/``).

The strategies are ``"bfs"`` (the default: host BFS with a rate-limited
snapshot visitor that records the most recently visited path, reference
``explorer.rs:57-88``) and ``"gpu"`` (the GPU wavefront engine,
``spawn_gpu(**spawn_kw)``; JAX's ``"tpu"``).  A device run's discoveries
come from ``live_discoveries``: the HTTP thread reads host copies only
(the last sync's counters and discovery fingerprints, and a checkpoint
that the engine's thread serves at its next host sync), never a CUDA
tensor.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path as FsPath
from typing import Optional

from .checker.path import Path
from .checker.visitor import CheckerVisitor
from .core import Expectation

_UI_DIR = FsPath(__file__).parent / "ui"
_SNAPSHOT_INTERVAL = 4.0  # seconds between recent-path refreshes


def _error_body(error: str, hint: str) -> dict:
    """The one stable machine-readable error shape every JSON endpoint
    returns: tooling keys on ``error``, humans read ``hint``."""
    return {"error": error, "hint": hint}


class _Snapshot(CheckerVisitor):
    """Keeps the most recently visited path, refreshed at most every
    :data:`_SNAPSHOT_INTERVAL` seconds (reference ``explorer.rs:57-84``)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._last_update = 0.0
        self.recent_path: Optional[str] = None

    def visit(self, model, path) -> None:
        now = time.monotonic()
        with self._lock:
            if now - self._last_update < _SNAPSHOT_INTERVAL and self.recent_path:
                return
            self._last_update = now
            self.recent_path = (
                "[" + ", ".join(model.format_action(a) for a in path.actions()) + "]"
            )


_EXPECTATION_NAME = {
    Expectation.ALWAYS: "always",
    Expectation.SOMETIMES: "sometimes",
    Expectation.EVENTUALLY: "eventually",
}


def _path_cache(checker) -> dict:
    """Per-checker encoded-path cache, stored ON the checker object so it
    dies with it.  A module-level dict keyed on ``id(checker)`` would go
    stale when CPython reuses the address of a collected checker — a later
    server in the same process could then serve a previous run's path for a
    same-named property."""
    return checker.__dict__.setdefault("_explorer_encoded_cache", {})


def _status_view(model, checker, snapshot: _Snapshot) -> dict:
    # Discoveries are read live, while the check is still running, as in the
    # reference (``explorer.rs:133-157`` reads the live discovery map):
    # BfsChecker's discovery map and parent pointers are safely readable
    # mid-run, so counterexample links appear in the UI as soon as found.
    # Encoded paths are cached per discovery fingerprint — reconstruction
    # re-executes the model along the whole trace, and the UI polls /.status
    # continuously.
    raw = getattr(checker, "_discoveries", None)
    if raw is not None:
        cache = _path_cache(checker)
        encoded = {}
        for name, fp in dict(raw).items():
            key = (name, fp)
            if key not in cache:
                cache[key] = Path.from_fingerprints(
                    model, checker._trace(fp)
                ).encode(model)
            encoded[name] = cache[key]
    elif hasattr(checker, "live_discoveries"):
        # device engines: discovery fps ride the per-sync stats, paths
        # parent-walk a checkpointed table + re-execute the object form.
        # First-wins discovery fps never change, so reconstruction happens
        # once per discovery: cached names are passed as ``skip`` and the
        # engine takes no checkpoint at all when nothing new is recorded.
        cache = _path_cache(checker)
        encoded = {
            name: cache[name]
            for name in (p.name for p in model.properties())
            if name in cache
        }
        fresh = checker.live_discoveries(skip=frozenset(encoded))
        for name, path in fresh.items():
            cache[name] = path.encode(model)
            encoded[name] = cache[name]
    else:  # other strategies: full (joining) reconstruction
        encoded = {
            name: path.encode(model)
            for name, path in checker.discoveries().items()
        }
    props = []
    for prop in model.properties():
        props.append(
            [
                _EXPECTATION_NAME[prop.expectation],
                prop.name,
                encoded.get(prop.name),
            ]
        )
    # Last preflight audit report (analysis/): populated by
    # the spawn_gpu preflight or an explicit builder.audit(); None when no
    # audit ran (e.g. the BFS strategy on an un-audited model).  Device
    # runs additionally expose the visited-table bucket-occupancy counters
    # (ops/buckets.occupancy_stats) once the run has results.
    audit = getattr(model, "_audit_report", None)
    table = None
    occ = getattr(checker, "occupancy_stats", None)
    if occ is not None:
        table = occ()
    # soundness-sanitizer verdict (JX2xx): the interval pass's site
    # counts + fired rules from the model's last audit, plus whether this
    # run executed under the checked-mode guard
    sanitizer = None
    if audit is not None:
        sanitizer = (audit.metrics or {}).get("sanitizer")
        if sanitizer is not None:
            sanitizer = dict(sanitizer)
            sanitizer["checked_run"] = bool(
                getattr(checker, "_checked", False)
            )
    # partial-order reduction: whether por() is active
    # on this run, the fallback reason when not, and the live
    # reduced-vs-full tallies; None when never requested
    por = None
    por_fn = getattr(checker, "por_status", None)
    if por_fn is not None:
        por = por_fn()
    # independence summary, when a pass was folded into the model's
    # report (independence.fold_into_report) — the audit tiers do not run
    # it (it re-traces every kernel; see analysis/audit.py)
    independence = None
    if audit is not None:
        independence = (audit.metrics or {}).get("independence")
    return {
        "done": checker.is_done(),
        "model": type(model).__name__,
        "state_count": checker.state_count(),
        "unique_state_count": checker.unique_state_count(),
        "properties": props,
        "recent_path": snapshot.recent_path,
        "audit": audit.to_json() if audit is not None else None,
        "sanitizer": sanitizer,
        "por": por,
        "independence": independence,
        "table": table,
    }


def _metrics_view(checker) -> Optional[dict]:
    """``GET /.metrics``: the run's flight-recorder telemetry
    (``telemetry/``) — summary + the recent per-step series
    the UI sparklines draw, the live health snapshot
    (``telemetry/health.py``), and the search-cartography block
    (``ops/cartography.py``; null unless the run was spawned with
    ``.telemetry(cartography=True)``).  None (-> the stable
    ``telemetry_disabled`` error body) when the run has no recorder: the
    endpoint never fabricates numbers."""
    rec = getattr(checker, "flight_recorder", None)
    if rec is None:
        return None
    dur_fn = getattr(checker, "durability_status", None)
    steps = rec.records("step")[-120:]
    series: dict = {
        "t": [], "states_per_sec": [], "unique": [], "load_factor": [],
        "dedup": [],
    }
    for r in steps:
        series["t"].append(r["t"])
        dt = r.get("dt") or 0.0
        series["states_per_sec"].append(
            round(r.get("d_states", 0) / dt, 1) if dt > 0 else None
        )
        series["unique"].append(r.get("unique"))
        series["load_factor"].append(r.get("load_factor"))
        series["dedup"].append(r.get("dedup"))
    occ = rec.records("occupancy")
    return {
        "summary": rec.summary(),
        "series": series,
        "occupancy": occ[-1] if occ else None,
        "counters": rec.counters(),
        "health": rec.health(),
        "cartography": rec.cartography(),
        # HBM ledger block (telemetry/memory.py): analytic footprint +
        # growth forecast + live device stats; null unless the run was
        # spawned with .telemetry(memory=True).  The UI's headroom panel
        # reads it.
        "memory": rec.memory(),
        # spill-tier block (spill/):
        # per-tier bytes, Bloom load, deferral tallies; null unless the
        # run was spawned with .spill()
        "spill": rec.spill(),
        # roofline cost ledger (telemetry/roofline.py): per-stage
        # FLOPs/bytes, op classes, reconciliation verdict and the card's
        # verdicts (no MXU-candidate ranking in the port); null unless the
        # run was spawned with
        # .telemetry(roofline=True).  The UI's stage-roofline panel
        # reads it.
        "roofline": rec.roofline(),
        # durability block (checkpoint.py + supervisor.py): autosave cadence/generations/last-
        # checkpoint-age + supervised restart count; null unless the run
        # has autosave armed or a supervision trail.  Read LIVE off the
        # checker (the age ticks between autosaves); the recorder's
        # snapshot is the fallback for replayed recorders.
        "durability": (
            (dur_fn() if callable(dur_fn) else None) or rec.durability()
        ),
        # fleet pool/queue block (fleet/):
        # slots, running/queued job keys, completion + preemption
        # tallies; null unless the recorder belongs to a fleet
        # scheduler (the UI's pool panel reads it)
        "fleet": rec.fleet(),
    }


def _runs_view(registry) -> dict:
    """``GET /.runs``: the registry index + per-config trend series
    (``telemetry/registry.py``) — the multi-run dashboard's data."""
    from .telemetry.registry import REGISTRY_V

    records = registry.index()  # one ledger parse serves both views
    return {
        "v": REGISTRY_V,
        "root": registry.root,
        "runs": records,
        "trends": registry.trends(records),
    }


def _runs_diff_view(registry, a_id: str, b_id: str):
    """``GET /.runs/diff/{a}/{b}``: the contract-aware diff of two
    archived runs (``telemetry/diff.py``), with the index headlines
    attached so throughput deltas render too.  Returns ``(code, body)``."""
    from .telemetry.diff import diff_reports

    docs = {}
    for rid in (a_id, b_id):
        doc = registry.find(rid)
        if doc is None:
            return 404, _error_body(
                "unknown_run",
                f"run {rid!r} is not archived in this registry "
                "(GET /.runs lists the known ids)",
            )
        docs[rid] = doc
    records = registry.index()  # one ledger parse for both headlines
    return 200, diff_reports(
        docs[a_id],
        docs[b_id],
        a_headline=registry.headline(a_id, records),
        b_headline=registry.headline(b_id, records),
    )


def _pretty(state) -> str:
    return _indent_repr(repr(state))


def _indent_repr(text: str, max_width: int = 100) -> str:
    """Break a long repr into an indented multi-line form (stands in for
    Rust's ``{:#?}`` pretty debug formatting, ``explorer.rs:47``)."""
    if len(text) <= max_width:
        return text
    out: list[str] = []
    depth = 0
    at_line_start = False
    for ch in text:
        if at_line_start and ch == " ":
            continue  # swallow pre-existing spacing after our line breaks
        at_line_start = False
        if ch in ")]}":
            depth = max(depth - 1, 0)
            out.append("\n" + "  " * depth)
        out.append(ch)
        if ch in "([{":
            depth += 1
            out.append("\n" + "  " * depth)
            at_line_start = True
        elif ch == ",":
            out.append("\n" + "  " * depth)
            at_line_start = True
    return "".join(out)


def _state_views(model, fingerprints: list[int]) -> Optional[list[dict]]:
    """Build the step views for ``/.states``; None means 404."""
    views: list[dict] = []
    if not fingerprints:
        for state in model.init_states():
            fp = model.fingerprint_state(state)
            svg = model.as_svg(Path([(state, None)]))
            view = {"state": _pretty(state), "fingerprint": str(fp)}
            if svg:
                view["svg"] = svg
            views.append(view)
        return views
    try:
        path = Path.from_fingerprints(model, fingerprints)
    except RuntimeError:
        return None
    last_state = path.final_state()
    prefix = path.into_vec()[:-1]  # [(state, action), ...] up to last_state
    for action in model.actions(last_state):
        outcome = model.format_step(last_state, action)
        nxt = model.next_state(last_state, action)
        if nxt is not None:
            fp = model.fingerprint_state(nxt)
            view = {
                "action": model.format_action(action),
                "state": _pretty(nxt),
                "fingerprint": str(fp),
            }
            if outcome is not None:
                view["outcome"] = outcome
            # child path built by appending, not by re-executing from init
            svg = model.as_svg(Path(prefix + [(last_state, action), (nxt, None)]))
            if svg:
                view["svg"] = svg
        else:
            # ignored action: still listed, for debugging (explorer.rs:225)
            view = {"action": model.format_action(action)}
        views.append(view)
    return views


def _make_handler(model, checker, snapshot: _Snapshot, registry=None,
                  progress_root=None):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet by default
            pass

        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, obj, code: int = 200):
            self._send(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):
            path = self.path.split("?", 1)[0]
            if path == "/.status":
                self._send_json(_status_view(model, checker, snapshot))
                return
            if path == "/metrics":
                # Prometheus text exposition: the
                # run recorder's attached bus when there is one, else the
                # process-wide default bus (the fleet scheduler and any
                # .telemetry(metrics=True) run publish into it).  An
                # empty exposition is a valid scrape, not an error.
                rec = getattr(checker, "flight_recorder", None)
                bus = getattr(rec, "metrics_bus", None) if rec else None
                if bus is None:
                    from .telemetry.metrics import default_bus

                    bus = default_bus()
                self._send(
                    200, bus.expose().encode(),
                    "text/plain; version=0.0.4; charset=utf-8",
                )
                return
            if path == "/.progress" or path.startswith("/.progress/"):
                # per-job live progress (checkpoint.ProgressHeartbeat):
                # /.progress reads the root heartbeat (a fleet pool, or
                # a standalone autosaved run); /.progress/<job> reads
                # <root>/jobs/<job>/progress.json
                if progress_root is None:
                    self._send_json(
                        _error_body(
                            "progress_disabled",
                            "serve with progress_root=DIR (a fleet "
                            "root or an autosave dir) to enable the "
                            "live-progress endpoints",
                        ),
                        404,
                    )
                    return
                from .checkpoint import read_progress

                job = path[len("/.progress"):].strip("/")
                if not job:
                    doc = read_progress(progress_root)
                else:
                    import os as _os

                    if "/" in job or ".." in job:
                        self._send_json(
                            _error_body(
                                "bad_job_key",
                                "use /.progress/<job-slug> (one path "
                                "segment)",
                            ),
                            404,
                        )
                        return
                    doc = read_progress(
                        _os.path.join(progress_root, "jobs", job)
                    )
                if doc is None:
                    self._send_json(
                        _error_body(
                            "no_heartbeat",
                            "no progress.json here yet — the run has "
                            "not reached its first host sync, or the "
                            "job key is unknown",
                        ),
                        404,
                    )
                    return
                self._send_json(doc)
                return
            if path == "/.metrics":
                view = _metrics_view(checker)
                if view is None:
                    # STABLE machine-readable body (_error_body):
                    # telemetry off is an expected state, not a routing
                    # failure — downstream pollers must be able to
                    # distinguish it from a typo'd URL without parsing
                    # prose
                    self._send_json(
                        _error_body(
                            "telemetry_disabled",
                            "spawn the run with .telemetry() "
                            "(add cartography=True for the search "
                            "counters) to enable /.metrics",
                        ),
                        404,
                    )
                    return
                self._send_json(view)
                return
            if path == "/.runs" or path.startswith("/.runs/"):
                if registry is None:
                    # same stable shape as telemetry_disabled: a server
                    # without a registry is an expected state
                    self._send_json(
                        _error_body(
                            "registry_disabled",
                            "serve with runs_dir=DIR (or set "
                            "STATERIGHT_TPU_RUN_DIR) to enable the "
                            "multi-run endpoints",
                        ),
                        404,
                    )
                    return
                rest = path[len("/.runs"):].strip("/")
                if not rest:
                    self._send_json(_runs_view(registry))
                    return
                parts = rest.split("/")
                if parts[0] == "diff":
                    if len(parts) != 3:
                        self._send_json(
                            _error_body(
                                "bad_diff_request",
                                "use /.runs/diff/{run_id_a}/{run_id_b}",
                            ),
                            404,
                        )
                        return
                    code, body = _runs_diff_view(
                        registry, parts[1], parts[2]
                    )
                    self._send_json(body, code)
                    return
                doc = registry.find(parts[0])
                if doc is None:
                    self._send_json(
                        _error_body(
                            "unknown_run",
                            f"run {parts[0]!r} is not archived in this "
                            "registry (GET /.runs lists the known ids)",
                        ),
                        404,
                    )
                    return
                self._send_json(doc)
                return
            if path == "/.states" or path.startswith("/.states/"):
                raw = path[len("/.states") :].strip("/")
                fps: list[int] = []
                if raw:
                    for part in raw.split("/"):
                        try:
                            fps.append(int(part))
                        except ValueError:
                            self._send_json(
                                {"error": f"Unable to parse fingerprints {raw}"},
                                404,
                            )
                            return
                views = _state_views(model, fps)
                if views is None:
                    self._send_json(
                        {
                            "error": "Unable to find state following "
                            f"fingerprints {raw}"
                        },
                        404,
                    )
                    return
                self._send_json(views)
                return
            # static UI
            name = {
                "/": "index.html",
                "/app.js": "app.js",
                "/app.css": "app.css",
            }.get(path)
            if name is None:
                self._send(404, b"not found", "text/plain")
                return
            f = _UI_DIR / name
            ctype = {
                "index.html": "text/html",
                "app.js": "application/javascript",
                "app.css": "text/css",
            }[name]
            self._send(200, f.read_bytes(), ctype)

    return Handler


class ExplorerServer:
    """A running Explorer; ``addr`` like ``"localhost:3000"``.

    ``strategy`` — ``"bfs"`` (default; reference parity: the reference
    Explorer wraps only ``BfsChecker``, ``explorer.rs:85-88``) or ``"gpu"``
    (JAX's ``"tpu"``): the GPU wavefront engine, on ``cuda`` unless
    ``device="cpu"`` is among the spawn keywords, with live ``/.status``
    counters and discovery paths rebuilt by a parent walk and object-form
    re-execution (``/.states`` re-executes the object model either way, so
    browsing is identical)."""

    def __init__(
        self,
        builder,
        addr: str = "localhost:3000",
        strategy: str = "bfs",
        runs_dir: Optional[str] = None,
        progress_root: Optional[str] = None,
        **spawn_kw,
    ):
        host, _, port = addr.partition(":")
        self.snapshot = _Snapshot()
        # persistent run registry (telemetry/registry.py): the multi-run
        # dashboard's data source — explicit runs_dir wins, else the
        # CheckerBuilder.runs(DIR), else STATERIGHT_TPU_RUN_DIR; absent =
        # the /.runs endpoints answer registry_disabled
        from .telemetry.registry import RunRegistry, resolve_run_dir

        root = resolve_run_dir(
            runs_dir or getattr(builder, "run_dir", None)
        )
        self.registry = RunRegistry(root) if root else None
        if strategy == "gpu":
            # no per-state visitor on device (states never materialize);
            # recent_path stays empty, the counters are live
            self.checker = builder.spawn_gpu(**spawn_kw)
        elif strategy == "bfs":
            if spawn_kw:
                raise TypeError(
                    "spawn keyword arguments are only supported with "
                    f"strategy='gpu' (got {sorted(spawn_kw)})"
                )
            self.checker = builder.visitor(self.snapshot).spawn_bfs()
        else:
            raise ValueError(f"unknown Explorer strategy {strategy!r}")
        self.model = builder.model
        # live-progress root: explicit wins,
        # else the CheckerBuilder's autosave dir (the heartbeat lives next to
        # the generations); absent = /.progress answers
        # progress_disabled
        if progress_root is None:
            aopts = getattr(builder, "autosave_opts", None)
            if aopts and aopts.get("dir"):
                progress_root = str(aopts["dir"])
        self.progress_root = progress_root
        handler = _make_handler(
            self.model, self.checker, self.snapshot,
            registry=self.registry, progress_root=progress_root,
        )
        self.httpd = ThreadingHTTPServer((host, int(port or "3000")), handler)
        self.addr = f"{self.httpd.server_address[0]}:{self.httpd.server_address[1]}"

    def serve_forever(self):
        print(f"Exploring state space at http://{self.addr}")
        self.httpd.serve_forever()

    def start_background(self) -> "ExplorerServer":
        t = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        t.start()
        return self

    def shutdown(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def serve(
    builder,
    addr: str = "localhost:3000",
    block: bool = True,
    strategy: str = "bfs",
    runs_dir: Optional[str] = None,
    progress_root: Optional[str] = None,
    **spawn_kw,
):
    """Spawn a check over ``builder`` and serve the Explorer UI
    (reference ``checker.rs:108-114``).  ``strategy="gpu"`` serves a GPU
    wavefront run instead of host BFS; with it, extra keyword arguments pass
    through to ``spawn_gpu`` (e.g. ``batch=...``, ``device="cpu"``).  ``runs_dir`` (or
    ``STATERIGHT_TPU_RUN_DIR`` / a builder ``.runs(DIR)``) arms the
    multi-run dashboard: ``/.runs`` endpoints + run list / two-run diff /
    trend panels over the persistent run registry."""
    server = ExplorerServer(
        builder, addr, strategy=strategy, runs_dir=runs_dir,
        progress_root=progress_root, **spawn_kw,
    )
    if block:
        server.serve_forever()
        return server
    return server.start_background()
