/* State Space Explorer front-end.
 *
 * Talks to the two JSON endpoints served by explorer.py:
 *   GET /.status            -> header + property summaries
 *   GET /.states/<fp>/<fp>  -> steps available from the state at that path
 *
 * The current position is the URL hash: #/steps/<fp>/<fp>/... so paths are
 * shareable and survive reloads (same contract as the reference UI's
 * hash-routing, but this implementation is our own).
 */
"use strict";

const $ = (id) => document.getElementById(id);
let currentPath = [];      // fingerprints (strings)
let currentViews = [];     // step views at the current path
let stateOfPath = null;    // pretty state text of the current position
let selected = -1;

// ---------------------------------------------------------------- status --
async function pollStatus() {
  try {
    const r = await fetch("/.status");
    const s = await r.json();
    $("model-name").textContent = "— " + s.model;
    $("progress").textContent =
      (s.done ? "done" : "checking…") +
      "  states=" + s.state_count.toLocaleString() +
      "  unique=" + s.unique_state_count.toLocaleString();
    $("recent-path").textContent = s.recent_path || "—";
    renderProperties(s.properties, s.done);
  } catch (e) {
    $("progress").textContent = "server unreachable";
  }
}

function renderProperties(props, done) {
  const ul = $("properties");
  ul.innerHTML = "";
  for (const [kind, name, discovery] of props) {
    const li = document.createElement("li");
    const k = document.createElement("span");
    k.className = "prop-kind";
    k.textContent = kind;
    const n = document.createElement("span");
    n.textContent = name;
    const flag = document.createElement("span");
    flag.className = "prop-flag";
    if (discovery) {
      const a = document.createElement("a");
      a.href = "#/steps/" + discovery;
      // a discovery is good news for `sometimes`, bad otherwise
      const good = kind === "sometimes";
      flag.classList.add(good ? "flag-ok" : "flag-bad");
      a.textContent = good ? "example ↗" : "counterexample ↗";
      flag.appendChild(a);
    } else if (done) {
      const good = kind !== "sometimes";
      flag.classList.add(good ? "flag-ok" : "flag-bad");
      flag.textContent = good ? "holds ✓" : "unsatisfied ✗";
    } else {
      flag.classList.add("flag-pending");
      flag.textContent = "…";
    }
    li.append(k, n, flag);
    ul.appendChild(li);
  }
}

// ------------------------------------------------------------- telemetry --
// Runs spawned with .telemetry() serve /.metrics; otherwise it 404s once
// and the panel stays hidden (no re-polling a run that can't have it).
let metricsAvailable = null; // null = unknown, probe on first poll

function sparkline(svg, values, fmt) {
  svg.innerHTML = "";
  const pts = values
    .map((v, i) => [i, v])
    .filter(([, v]) => v !== null && v !== undefined && isFinite(v));
  if (pts.length < 2) return null;
  const xs = pts.map(([i]) => i), ys = pts.map(([, v]) => v);
  const x0 = Math.min(...xs), x1 = Math.max(...xs);
  const hi = Math.max(...ys), lo = Math.min(...ys);
  const W = 300, H = 40, PAD = 3;
  const sx = (i) => ((i - x0) / Math.max(x1 - x0, 1)) * (W - 2 * PAD) + PAD;
  const sy = (v) =>
    H - PAD - ((v - lo) / Math.max(hi - lo, 1e-12)) * (H - 2 * PAD);
  const line = document.createElementNS("http://www.w3.org/2000/svg", "polyline");
  line.setAttribute("points", pts.map(([i, v]) => sx(i) + "," + sy(v)).join(" "));
  line.setAttribute("class", "spark-line");
  svg.appendChild(line);
  const dot = document.createElementNS("http://www.w3.org/2000/svg", "circle");
  const [li, lv] = pts[pts.length - 1];
  dot.setAttribute("cx", sx(li));
  dot.setAttribute("cy", sy(lv));
  dot.setAttribute("r", 2.2);
  dot.setAttribute("class", "spark-dot");
  svg.appendChild(dot);
  return fmt ? fmt(lv) : lv;
}

const fmtRate = (v) =>
  v >= 1e6 ? (v / 1e6).toFixed(1) + "M/s"
  : v >= 1e3 ? (v / 1e3).toFixed(1) + "k/s"
  : v.toFixed(0) + "/s";

// Bar chart for the cartography histograms (depth / action counts): same
// 300x40 frame as the sparklines, one rect per bin.
function barchart(svg, values) {
  svg.innerHTML = "";
  if (!values || !values.length) return 0;
  const W = 300, H = 40, PAD = 2;
  const peak = Math.max(...values, 1);
  const bw = (W - 2 * PAD) / values.length;
  values.forEach((v, i) => {
    const h = (v / peak) * (H - 2 * PAD);
    const r = document.createElementNS("http://www.w3.org/2000/svg", "rect");
    r.setAttribute("x", PAD + i * bw + 0.5);
    r.setAttribute("y", H - PAD - h);
    r.setAttribute("width", Math.max(bw - 1, 1));
    r.setAttribute("height", Math.max(h, v > 0 ? 1 : 0));
    r.setAttribute("class", "hist-bar");
    const title = document.createElementNS("http://www.w3.org/2000/svg", "title");
    title.textContent = "#" + i + ": " + v.toLocaleString();
    r.appendChild(title);
    svg.appendChild(r);
  });
  return values.reduce((a, b) => a + b, 0);
}

function renderCartography(cart) {
  if (!cart) {
    $("cartography").hidden = true;
    return;
  }
  $("cartography").hidden = false;
  const dn = barchart($("hist-depth"), cart.depth_hist);
  $("cart-depth-n").textContent = "· " + dn.toLocaleString() + " fresh";
  const an = barchart($("hist-action"), cart.action_hist);
  $("cart-action-n").textContent = "· " + an.toLocaleString() + " generated";
  const ul = $("cart-props");
  ul.innerHTML = "";
  for (const p of cart.props || []) {
    const li = document.createElement("li");
    li.textContent =
      p.name + ": " + p.evaluated.toLocaleString() + " evaluated, " +
      p.condition_hits.toLocaleString() + " hits";
    ul.appendChild(li);
  }
  const bits = [
    "fresh=" + cart.fresh_inserts.toLocaleString(),
    "dup=" + cart.duplicate_hits.toLocaleString(),
  ];
  if (cart.shard_imbalance)
    bits.push(
      "shards max/mean=" + cart.shard_imbalance.ratio +
      " (max=" + cart.shard_imbalance.max + ")"
    );
  if (cart.routed_candidates !== undefined)
    bits.push("routed=" + cart.routed_candidates.toLocaleString());
  $("cart-summary").textContent = bits.join("  ");
}

// ------------------------------------------------------------ memory --
// Headroom panel over the /.metrics memory block (the HBM ledger,
// telemetry/memory.py): analytic carry bytes vs the device budget, the
// next growth rung's migration transient, and the live device readings
// where the backend has them (absent on CPU — the panel then shows the
// analytic numbers alone).
const fmtBytes = (n) => {
  if (n === null || n === undefined) return "-";
  const units = ["B", "KB", "MB", "GB", "TB"];
  let i = 0;
  while (Math.abs(n) >= 1024 && i < units.length - 1) { n /= 1024; i++; }
  return (i ? n.toFixed(1) : n.toFixed(0)) + units[i];
};

function renderMemory(mem, health) {
  const panel = $("memory");
  if (!mem) {
    panel.hidden = true;
    return;
  }
  panel.hidden = false;
  const budget = mem.budget_bytes || null;
  const live = mem.device || {};
  const used = live.bytes_in_use !== undefined
    ? live.bytes_in_use : mem.total_bytes;
  const fill = $("mem-meter-fill");
  if (budget) {
    const frac = Math.min(used / budget, 1);
    fill.style.width = (frac * 100).toFixed(1) + "%";
    fill.className = "meter-fill" + (frac > 0.8 ? " meter-hot" : "");
    $("mem-headroom").textContent =
      "· " + fmtBytes(used) + " / " + fmtBytes(budget) +
      " (" + (frac * 100).toFixed(1) + "%)";
  } else {
    fill.style.width = "0%";
    $("mem-headroom").textContent =
      "· " + fmtBytes(used) + " (no device limit known)";
  }
  const bits = ["carry=" + fmtBytes(mem.total_bytes)];
  if (mem.per_device_bytes !== undefined)
    bits.push("per-chip=" + fmtBytes(mem.per_device_bytes));
  if (mem.next_rung)
    bits.push(
      "next rung transient=" + fmtBytes(mem.next_rung.transient_bytes)
    );
  if (live.peak_bytes_in_use !== undefined)
    bits.push("peak=" + fmtBytes(live.peak_bytes_in_use));
  $("mem-summary").textContent = bits.join("  ");
  const risk = $("mem-risk");
  if (health && health.oom_risk) {
    risk.hidden = false;
    risk.textContent =
      "GROWTH OOM RISK: the next growth rung's transient does not fit " +
      "this device — checkpoint or re-plan capacity";
  } else {
    risk.hidden = true;
  }
}

// ------------------------------------------------------------ roofline --
// Stage-roofline panel over the /.metrics roofline block
// (telemetry/roofline.py): per-stage bytes/step bars, intensity +
// memory/compute-bound verdicts where a device spec is known, the
// XLA-reconciliation verdict, and the top MXU candidate (JX4xx).
function renderRoofline(roof) {
  const panel = $("roofline");
  if (!roof) {
    panel.hidden = true;
    return;
  }
  panel.hidden = false;
  const names = Object.keys(roof.stages || {});
  const bytes = names.map(
    (n) => roof.stages[n].bytes_read + roof.stages[n].bytes_written
  );
  barchart($("hist-roof"), bytes);
  $("roof-bytes-n").textContent =
    "· " + fmtBytes(bytes.reduce((a, b) => a + b, 0)) + "/step";
  const ul = $("roof-stages");
  ul.innerHTML = "";
  names.forEach((n) => {
    const s = roof.stages[n];
    const v = (roof.verdicts || {})[n] || {};
    const li = document.createElement("li");
    li.textContent =
      n + ": " + fmtBytes(s.bytes_read + s.bytes_written) +
      ", " + s.flops.toLocaleString() + " FLOPs" +
      (s.intensity !== undefined ? ", AI=" + s.intensity.toFixed(3) : "") +
      (v.verdict && v.verdict !== "unknown" ? " — " + v.verdict : "");
    ul.appendChild(li);
  });
  const bits = [];
  if (roof.reconciliation)
    bits.push("XLA-reconciled=" + (roof.reconciliation.ok ? "ok" : "FAIL"));
  if (roof.device_spec)
    bits.push("spec=" + roof.device_spec.name);
  const top = (roof.mxu_candidates || [])[0];
  if (top)
    bits.push(
      "top MXU candidate: " + top.op + " in " + top.stage +
      " (" + fmtBytes(top.bytes) + "/step)"
    );
  $("roof-summary").textContent = bits.join("  ") || "—";
}

function renderHealth(h) {
  const el = $("health-line");
  if (!h) {
    el.hidden = true;
    return;
  }
  el.hidden = false;
  const bits = ["phase=" + h.phase];
  if (h.stalled) bits.push("STALLED (" + (h.stall_reason || "?") + ")");
  if (h.novelty !== null && h.novelty !== undefined)
    bits.push("novelty=" + h.novelty);
  if (h.eta_secs !== null && h.eta_secs !== undefined)
    bits.push("eta=" + h.eta_secs + "s");
  el.textContent = bits.join("  ");
  el.className = h.stalled ? "health stalled" : "health";
}

// Pool/queue panel over the /.metrics fleet block (fleet/scheduler.py
// publishes a pool snapshot into the recorder; null outside fleet runs).
// The block is a point-in-time snapshot, so the pool sparklines accumulate
// one sample per poll client-side (bounded window).
const FLEET_WIN = 150;
const fleetHist = { rate: [], depth: [] };

function renderFleet(f, rate) {
  const sec = $("fleet");
  if (!f) {
    sec.hidden = true;
    return;
  }
  sec.hidden = false;
  fleetHist.depth.push((f.queued || []).length);
  fleetHist.rate.push(rate === undefined ? null : rate);
  for (const k of ["rate", "depth"])
    if (fleetHist[k].length > FLEET_WIN) fleetHist[k].shift();
  const r = sparkline($("spark-fleet-rate"), fleetHist.rate, fmtRate);
  $("fleet-rate").textContent = r === null ? "" : "· " + r;
  const d = sparkline($("spark-fleet-queue"), fleetHist.depth, (v) => v.toFixed(0));
  $("fleet-depth").textContent = d === null ? "" : "· " + d;
  $("fleet-summary").textContent =
    "slots=" + f.slots + "  jobs=" + f.jobs +
    "  completed=" + f.completed +
    (f.preemptions ? "  preemptions=" + f.preemptions : "");
  const ul = $("fleet-slots");
  ul.innerHTML = "";
  for (const label of f.running || []) {
    const li = document.createElement("li");
    li.className = "fleet-slot";
    li.textContent = "▶ " + label;
    ul.appendChild(li);
  }
  $("fleet-queue").textContent = (f.queued || []).length
    ? "queued: " + f.queued.join("  ")
    : "queue empty";
}

async function pollMetrics() {
  if (metricsAvailable === false) return;
  try {
    const r = await fetch("/.metrics");
    if (!r.ok) {
      metricsAvailable = false;
      return;
    }
    const m = await r.json();
    metricsAvailable = true;
    $("telemetry").hidden = false;
    const last = sparkline($("spark-rate"), m.series.states_per_sec, fmtRate);
    $("tele-rate").textContent = last === null ? "" : "· " + last;
    const load = sparkline(
      $("spark-load"), m.series.load_factor,
      (v) => (v * 100).toFixed(1) + "%"
    );
    $("tele-load").textContent = load === null ? "" : "· " + load;
    const s = m.summary;
    const bits = [];
    if (s.steps !== undefined) bits.push("steps=" + s.steps);
    if (s.dedup_ratio !== undefined) bits.push("dedup=" + s.dedup_ratio);
    if (s.growth_events) bits.push("growth=" + s.growth_events);
    if (m.occupancy)
      bits.push(
        "buckets max=" + m.occupancy.max_bucket +
        " full=" + m.occupancy.full_buckets
      );
    $("tele-summary").textContent = bits.join("  ") || "—";
    renderHealth(m.health);
    renderCartography(m.cartography);
    renderMemory(m.memory, m.health);
    renderRoofline(m.roofline);
    const rawRates = (m.series.states_per_sec || []).filter(
      (v) => v !== null && v !== undefined && isFinite(v)
    );
    renderFleet(m.fleet, rawRates.length ? rawRates[rawRates.length - 1] : null);
  } catch (e) {
    /* transient; retry next poll */
  }
}

// ----------------------------------------------------------------- runs --
// Multi-run dashboard over the /.runs endpoints (telemetry/registry.py +
// telemetry/diff.py): the registry's run list, per-config_key trend
// sparklines, and a two-run contract-aware diff panel.  A server without
// a registry answers 404 {"error": "registry_disabled", ...} once and
// the panel stays hidden (the /.metrics probe discipline).
let runsAvailable = null;
let diffSelection = []; // up to two selected run_ids
let expandedSweeps = new Set(); // sweep/campaign ids whose members unfold

function makeRunRow(r, indent) {
  const li = document.createElement("li");
  li.className = "run-row";
  if (indent) li.style.paddingLeft = "1.2em";
  if (diffSelection.includes(r.run_id)) li.classList.add("selected");
  const h = r.headline || {};
  const id = document.createElement("span");
  id.className = "run-id";
  id.textContent = r.run_id.slice(0, 8);
  id.title = r.run_id + "  config " + (r.config_key || "-");
  const desc = document.createElement("span");
  desc.textContent =
    " " + (r.instance_key ? r.instance_key + " " :
           r.job_key ? r.job_key + " " : "") +
    r.model + "/" + r.engine +
    (r.leg ? " [" + r.leg + "]" : "") +
    "  unique=" + (h.unique === undefined ? "-" : h.unique) +
    (h.states_per_sec ? "  " + fmtRate(h.states_per_sec) : "") +
    (r.parent_run_id ? "  ⤴" + r.parent_run_id.slice(0, 6) : "");
  li.append(id, desc);
  li.addEventListener("click", () => selectRunForDiff(r.run_id));
  return li;
}

function renderRunsList(runs) {
  const ul = $("runs-list");
  ul.innerHTML = "";
  // sweep members fold under one expandable header row with a
  // per-instance verdict strip (telemetry/registry.py sweep_id tags;
  // docs/sweep.md); campaign jobs fold the same way and win when a
  // record carries both tags (a packed cohort member is a sweep
  // instance owned by a campaign — docs/fleet.md)
  const items = [];
  const byGroup = new Map();
  for (const r of runs.slice(-90)) {
    const kind = r.campaign_id ? "campaign" : r.sweep_id ? "sweep" : null;
    if (kind) {
      const gid = kind + ":" + (r.campaign_id || r.sweep_id);
      let g = byGroup.get(gid);
      if (!g) {
        g = { gid, kind, raw: r.campaign_id || r.sweep_id, members: [] };
        byGroup.set(gid, g);
        items.push(g);
      }
      g.members.push(r);
    } else items.push(r);
  }
  for (const it of items.reverse().slice(0, 30)) {
    if (!it.members) {
      ul.appendChild(makeRunRow(it, false));
      continue;
    }
    const li = document.createElement("li");
    li.className = "run-row sweep-row";
    const open = expandedSweeps.has(it.gid);
    const id = document.createElement("span");
    id.className = "run-id";
    id.textContent = (open ? "▾ " : "▸ ") + it.raw.slice(0, 8);
    id.title = it.kind + " " + it.raw;
    const strip = it.members
      .map((m) =>
        ((m.headline || {}).discoveries || []).length ? "●" : "○")
      .join("");
    const desc = document.createElement("span");
    desc.textContent =
      " " + it.kind + " · " + it.members.length +
      (it.kind === "campaign" ? " jobs  " : " instances  ") + strip;
    li.append(id, desc);
    li.addEventListener("click", () => {
      if (open) expandedSweeps.delete(it.gid);
      else expandedSweeps.add(it.gid);
      pollRuns();
    });
    ul.appendChild(li);
    if (open)
      for (const m of it.members) ul.appendChild(makeRunRow(m, true));
  }
}

function renderRunTrends(trends) {
  const div = $("runs-trends");
  div.innerHTML = "";
  for (const [key, series] of Object.entries(trends || {})) {
    if (series.length < 2) continue;
    const row = document.createElement("div");
    row.className = "spark-row";
    const label = document.createElement("div");
    label.className = "spark-label";
    const metric = series.some((s) => s.states_per_sec)
      ? "states_per_sec" : "unique";
    label.textContent =
      "config " + key.slice(0, 8) + " · " + metric +
      " over " + series.length + " runs";
    const svg = document.createElementNS(
      "http://www.w3.org/2000/svg", "svg"
    );
    svg.setAttribute("viewBox", "0 0 300 40");
    svg.setAttribute("preserveAspectRatio", "none");
    const last = sparkline(svg, series.map((s) => s[metric]),
      metric === "states_per_sec" ? fmtRate : null);
    if (last !== null && last !== undefined)
      label.textContent += " · " + last;
    row.append(label, svg);
    div.appendChild(row);
  }
}

async function selectRunForDiff(runId) {
  if (diffSelection.includes(runId)) {
    diffSelection = diffSelection.filter((r) => r !== runId);
  } else {
    diffSelection = diffSelection.concat([runId]).slice(-2);
  }
  await pollRuns();
  if (diffSelection.length !== 2) {
    $("runs-verdict").hidden = true;
    $("runs-diff").textContent = "select two runs to diff";
    return;
  }
  const [a, b] = diffSelection;
  const r = await fetch("/.runs/diff/" + a + "/" + b);
  const d = await r.json();
  const v = $("runs-verdict");
  if (!r.ok || d.error) {
    // the server's stable error body ({error, hint}): surface the hint
    // instead of rendering an undefined verdict
    v.hidden = false;
    v.textContent = d.error || "diff failed";
    v.className = "diff-verdict flag-bad";
    $("runs-diff").textContent = d.hint || "";
    return;
  }
  v.hidden = false;
  v.textContent = d.verdict + " (contract: " + d.contract + ")";
  v.className = "diff-verdict " +
    (d.verdict === "DIVERGENT" ? "flag-bad" : "flag-ok");
  const lines = [];
  const t = (d.blocks || {}).totals || {};
  for (const k of ["states", "unique", "max_depth"]) {
    const p = t[k] || {};
    lines.push(
      k + ": " + p.a + (p.match ? "" : " -> " + p.b +
      (p.delta !== undefined ? " (" + (p.delta > 0 ? "+" : "") + p.delta + ")" : ""))
    );
  }
  for (const p of (d.blocks || {}).properties || []) {
    lines.push(
      "property " + p.name + ": a=" + p.a + " b=" + p.b +
      (p.match ? "" : "  MISMATCH")
    );
  }
  const perf = (d.blocks || {}).perf;
  if (perf && perf.states_per_sec)
    lines.push(
      "throughput: " + perf.states_per_sec.a + " -> " +
      perf.states_per_sec.b + " states/s"
    );
  for (const viol of d.violations || []) {
    lines.push("[" + viol.rule + "] " + viol.field + ": " + viol.detail);
  }
  $("runs-diff").textContent = lines.join("\n");
}

async function pollRuns() {
  if (runsAvailable === false) return;
  try {
    const r = await fetch("/.runs");
    if (!r.ok) {
      runsAvailable = false;
      return;
    }
    const view = await r.json();
    runsAvailable = true;
    $("runs").hidden = false;
    renderRunsList(view.runs || []);
    renderRunTrends(view.trends || {});
  } catch (e) {
    /* transient; retry next poll */
  }
}

// ----------------------------------------------------------------- steps --
let loadSeq = 0; // drop out-of-order responses so fast navigation stays sane

async function loadPath(path) {
  const seq = ++loadSeq;
  const url = "/.states/" + path.join("/");
  const r = await fetch(url);
  if (seq !== loadSeq) return; // a newer navigation superseded this one
  if (!r.ok) {
    $("steps-title").textContent = "error";
    $("steps").innerHTML = "<li class='ignored'>path not found</li>";
    return;
  }
  currentPath = path;
  currentViews = await r.json();
  if (seq !== loadSeq) return;
  selected = currentViews.length ? 0 : -1;
  // resolve the pretty text of the state we are AT (deep links included):
  // it is the view with our last fingerprint in the parent path's step list
  if (path.length) {
    const pr = await fetch("/.states/" + path.slice(0, -1).join("/"));
    if (seq !== loadSeq) return;
    if (pr.ok) {
      const parentViews = await pr.json();
      if (seq !== loadSeq) return;
      const me = parentViews.find((v) => v.fingerprint === path[path.length - 1]);
      stateOfPath = me ? me.state : null;
      $("svg-panel").innerHTML = me && me.svg ? me.svg : "";
    }
  } else {
    stateOfPath = null;
    $("svg-panel").innerHTML = "";
  }
  renderBreadcrumb();
  renderSteps();
}

function renderBreadcrumb() {
  const nav = $("breadcrumb");
  nav.innerHTML = "";
  const root = document.createElement("a");
  root.href = "#/steps";
  root.textContent = "⌂ init";
  nav.appendChild(root);
  currentPath.forEach((fp, i) => {
    const sep = document.createElement("span");
    sep.className = "crumb-sep";
    sep.textContent = "→";
    nav.appendChild(sep);
    const a = document.createElement("a");
    a.href = "#/steps/" + currentPath.slice(0, i + 1).join("/");
    a.textContent = "…" + fp.slice(-6);
    a.title = fp;
    nav.appendChild(a);
  });
}

function renderSteps() {
  $("steps-title").textContent = currentPath.length
    ? "Next steps (" + currentViews.length + ")"
    : "Init states (" + currentViews.length + ")";
  const ol = $("steps");
  ol.innerHTML = "";
  currentViews.forEach((v, i) => {
    const li = document.createElement("li");
    if (v.fingerprint === undefined) li.classList.add("ignored");
    if (i === selected) li.classList.add("selected");
    const action = document.createElement("div");
    action.className = "step-action";
    action.textContent = v.action !== undefined ? v.action : "(init)";
    li.appendChild(action);
    if (v.outcome !== undefined) {
      const o = document.createElement("div");
      o.className = "step-outcome";
      o.textContent = v.outcome;
      li.appendChild(o);
    }
    if (v.state !== undefined) {
      const st = document.createElement("div");
      st.className = "step-state";
      st.textContent = v.state;
      li.appendChild(st);
      li.addEventListener("click", () => descend(i));
    } else {
      const st = document.createElement("div");
      st.className = "step-outcome";
      st.textContent = "action ignored (no-op)";
      li.appendChild(st);
    }
    ol.appendChild(li);
  });
  $("current-state").textContent =
    stateOfPath || "(pick an init state below)";
}

function descend(i) {
  const v = currentViews[i];
  if (!v || v.fingerprint === undefined) return;
  location.hash = "#/steps/" + currentPath.concat([v.fingerprint]).join("/");
}

// ---------------------------------------------------------------- routing --
function route() {
  const h = location.hash;
  const m = h.match(/^#\/steps\/?(.*)$/);
  const parts = m && m[1] ? m[1].split("/").filter(Boolean) : [];
  loadPath(parts);
}

// --------------------------------------------------------------- keyboard --
document.addEventListener("keydown", (e) => {
  if (e.key === "j" || e.key === "ArrowDown") {
    selected = Math.min(selected + 1, currentViews.length - 1);
    renderSteps();
    e.preventDefault();
  } else if (e.key === "k" || e.key === "ArrowUp") {
    selected = Math.max(selected - 1, 0);
    renderSteps();
    e.preventDefault();
  } else if (e.key === "Enter" && selected >= 0) {
    descend(selected);
  } else if (e.key === "Backspace") {
    if (currentPath.length) {
      location.hash = "#/steps/" + currentPath.slice(0, -1).join("/");
    }
    e.preventDefault();
  }
});

window.addEventListener("hashchange", route);
pollStatus();
pollMetrics();
pollRuns();
setInterval(pollStatus, 2000);
setInterval(pollMetrics, 2000);
setInterval(pollRuns, 10000); // the registry is append-only; poll gently
route();
