"""The ``check`` verbs of the example models.

The port's counterpart of the ``check``, ``check-tpu`` and ``check-auto``
verbs of ``stateright_tpu/models/_cli.py``'s users: the same positional
arguments, the ``--per-channel`` flag (``pop_perf``/``apply_encoding``
there) and, on the GPU verbs, ``--prededup``, ``--por``, ``--mxu``,
``--spill``, ``--mesh`` (the mesh engine, ``parallel/mesh.py``),
``--prewarm`` and ``--compile-cache=DIR`` (``parallel/prewarm.py``;
``pop_perf``/``apply_perf`` there) and ``--checked``
(``pop_checked`` there; :func:`pop_step_flags`, :func:`with_step_flags`;
``--mxu`` has no effect in the port).
:func:`check_main` is the one dispatcher: each model gives it a table
from the verbs it offers to their banners and to one of the spawns here:
:func:`host_bfs` and :func:`host_dfs` (on ``default_threads()``
threads), :func:`host_sym_dfs` (the host DFS with symmetry),
:func:`auto` (``spawn_auto()``: a bounded host probe, then the GPU
engine), :func:`gpu` (``spawn_gpu()``) and :func:`sym_gpu`
(``.symmetry().spawn_gpu()``).  A model with no tensor form leaves the GPU
verbs out.

Beside a model's own verbs, every model with a GPU verb takes the
telemetry verbs (JAX ``_cli.py:71-85``): ``profile`` (a telemetry run,
written as flight-recorder JSONL, ``--out=F``, and optionally a Chrome
trace, ``--chrome=F``), ``report`` (the post-run report, JSON and
markdown, ``--out=F``), ``capacity`` (the memory ledger's capacity
plan) and ``compare A B`` (the contract-aware diff of two reports or
registry run ids, ``--registry=DIR``, ``--expect=VERDICT``).  The GPU
verbs take ``--watch`` (a live status line, JAX ``_cli.py:230-370``).
``--device=cpu`` runs the GPU verbs and the telemetry verbs on the plain
PyTorch path instead of the CUDA device, and ``--batch=N`` sets their
rows per device step.  The models JAX gives an ``explore`` verb take it
here too: ``explore [N] [ADDRESS]`` serves the Explorer over a host BFS of
the model (:func:`explore`; JAX e.g. ``two_phase_commit.py:499-503``).
The models JAX gives a ``spawn`` verb (single-copy register,
linearizable register, paxos, raft, write-once register) take it here
too: it deploys the model's server actors on localhost UDP sockets
(``actor/spawn.py``; :func:`udp_spawn`, JAX ``_cli.py:67``) and blocks.
``capacity --spill`` plans with the spill tier armed.

Every model takes ``audit`` (the static audit of its ``_audit_models``
configurations, deep tier, exit 1 on an error finding; JAX
``make_audit_cmd``), ``sanitize`` (their static sanitizer, exit 1 on a
JX2xx error; JAX ``make_sanitize_cmd``) and ``costmodel`` (their roofline
cost ledger at batch 2,048, ``--out=F`` for the JSON blocks; JAX
``make_costmodel_cmd``), and 2pc and paxos take ``supervise`` (a supervised
GPU run: autosave, retry with backoff, resume; ``supervisor.py``, JAX
``_cli.py:1494-1584``; :func:`pop_supervise_opts` lists its flags).
2pc and paxos take ``sweep [N]`` (their default family, ``sweep_family(N)``,
in one GPU run: one line per instance and the summary line; JAX
``make_sweep_cmd``, :func:`pop_sweep_opts` lists its flags, and
``--device=cpu`` runs it on the plain path).
The models JAX gives an ``independence`` verb take it here too (the
static independence analysis of their ``_audit_models`` configurations:
the conflict matrix's summary and the JX3xx findings; JAX
``_cli.py:511-600``, :func:`make_independence_cmd`).
``python -m stateright_tpu_torch.models._cli`` is the fleet entry:
``status RUN_DIR`` (the progress heartbeat of a headless run, JAX
``_cli.py:1810-1870``), ``runs [DIR]`` (the run registry, campaign jobs
and sweep members grouped; JAX ``fleet_runs`` :1117), ``fleet`` (the
canned six-tenant fleet with one injected preemption and the lineage
audit; JAX ``fleet_schedule`` :1347), ``campaign [2pc|paxos]`` (a
parameter grid as a fleet campaign with its ledger; JAX
``fleet_campaign`` :1425), ``audit [MODULE...]`` (every model's audit),
``independence [MODULE...]`` (every model's independence analysis),
``sanitize [MODULE...]`` and ``costmodel [MODULE...]``.  ``fleet`` and
``campaign`` take :func:`_pop_fleet_opts`' flags, ``--device=cpu``
among them.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Callable, Iterable, Optional

PER_CHANNEL_FLAG = "--per-channel"
WATCH_FLAG = "--watch"
# ``--name=value`` options: the device, and the telemetry verbs' own
VALUE_OPTS = ("device", "batch", "out", "chrome", "registry", "expect")
TELEMETRY_VERBS = ("profile", "report", "capacity", "compare")
# the GPU engine's step flags: builder method per flag (``mxu`` is
# accepted for parity with the JAX CLI and has no effect in the port;
# ``prewarm`` builds growth rungs ahead and leaves the step as it is)
STEP_FLAGS = {"--prededup": "prededup", "--por": "por", "--mxu": "mxu",
              "--checked": "checked", "--spill": "spill", "--mesh": "mesh",
              "--prewarm": "prewarm"}
# ``--compile-cache=DIR``: the builder's ``compile_cache(DIR)``, which
# travels with the step flags
COMPILE_CACHE_FLAG = "--compile-cache="


def pop_per_channel(args: list) -> tuple:
    """``(per_channel, args without the flag)``: the flag may stand
    anywhere after the verb."""
    kept = [a for a in args if a != PER_CHANNEL_FLAG]
    return len(kept) != len(args), kept


def _is_step_flag(a: str) -> bool:
    return a in STEP_FLAGS or a.startswith(COMPILE_CACHE_FLAG)


def pop_step_flags(args: list) -> tuple:
    """``(flags, args without them)``: the :data:`STEP_FLAGS` and
    ``--compile-cache=DIR`` given, which may stand anywhere after the
    verb."""
    flags = [a for a in args if _is_step_flag(a)]
    return flags, [a for a in args if not _is_step_flag(a)]


def apply_encoding(model, per_channel: bool):
    """Apply ``--per-channel`` to the model (``ActorModel.per_channel_()``)
    before its twin resolves: the encoding is the fingerprint scheme.  A
    model without the builder method (2pc's hand-written twin) gets a loud
    one-line notice instead of a silent no-op, so an ignored flag never
    passes for "per-channel buys nothing"."""
    if per_channel:
        if hasattr(model, "per_channel_"):
            model.per_channel_()
        else:
            print(
                "stateright-tpu-torch: --per-channel ignored: "
                f"{type(model).__name__} is not an actor model (the "
                "encoding applies to compiled actor twins)",
                file=sys.stderr,
            )
    return model


def default_threads() -> int:
    return os.cpu_count() or 1


def host_bfs(model):
    return model.checker().threads(default_threads()).spawn_bfs()


def host_dfs(model):
    return model.checker().threads(default_threads()).spawn_dfs()


def host_sym_dfs(model):
    return model.checker().threads(default_threads()).symmetry().spawn_dfs()


def auto(model):
    return model.checker().threads(default_threads()).spawn_auto()


def explore_addr(rest: list) -> str:
    """The ``explore`` verb's address: its second positional argument."""
    return rest[1] if len(rest) > 1 else "localhost:3000"


def explore(model, addr: str = "localhost:3000"):
    """The ``explore`` verb: serve the Explorer over a host BFS of
    ``model`` on ``addr`` (blocks; JAX ``CheckerBuilder.serve``)."""
    return model.checker().serve(addr)


def gpu(model, flags=(), opts=None, watch=False):
    """``spawn_gpu()`` with the step ``flags`` (:data:`STEP_FLAGS`) on, on
    the ``--device``/``--batch`` of ``opts`` (default ``cuda``, 2,048
    rows), with the live status line under ``watch``; None when the model
    has no device twin."""
    if model._tensor_cached() is None:
        return None
    b = apply_watch(with_step_flags(model.checker(), flags), watch)
    return spawn_watched(b.spawn_gpu(**gpu_kw(opts)), watch)


def sym_gpu(model, flags=(), opts=None, watch=False):
    if model._tensor_cached() is None:
        return None
    b = apply_watch(with_step_flags(model.checker().symmetry(), flags), watch)
    return spawn_watched(b.spawn_gpu(**gpu_kw(opts)), watch)


def gpu_kw(opts) -> dict:
    """``spawn_gpu`` keywords from the ``--device=``/``--batch=`` options."""
    opts = opts or {}
    kw = {"device": opts.get("device")}
    if opts.get("batch"):
        kw["batch"] = int(opts["batch"])
    return kw


def with_step_flags(builder, flags):
    """``builder`` with each of the :data:`STEP_FLAGS` in ``flags`` on, and
    its compile cache at a ``--compile-cache=DIR``'s directory."""
    for f in flags:
        if f.startswith(COMPILE_CACHE_FLAG):
            builder = builder.compile_cache(f[len(COMPILE_CACHE_FLAG):])
        else:
            builder = getattr(builder, STEP_FLAGS[f])()
    return builder


def pop_values(args: list) -> tuple:
    """``(opts, args without them)``: the :data:`VALUE_OPTS` given as
    ``--name=value``, which may stand anywhere after the verb."""
    opts, kept = {}, []
    for a in args:
        name = a[2:].split("=", 1)[0] if a.startswith("--") else None
        if name in VALUE_OPTS and "=" in a:
            opts[name] = a.split("=", 1)[1]
        else:
            kept.append(a)
    return opts, kept


# -- the live watch view (--watch on the GPU verbs) ---------------------------


def pop_watch(args: list) -> tuple:
    """``(watch, args without --watch)``."""
    kept = [a for a in args if a != WATCH_FLAG]
    return len(kept) != len(args), kept


def apply_watch(builder, watch: bool):
    """Arm a builder for the live watch view: the line reads the health
    model, the cartography block and the memory ledger, so ``--watch``
    implies ``.cartography().memory_ledger()``."""
    return builder.cartography().memory_ledger() if watch else builder


def watch_line(checker) -> str:
    """One live status line: depth, cumulative counters, smoothed
    throughput, table load, device bytes (against the device's memory
    when it is known), the health phase (with stall and OOM-risk flags),
    the checkpoint age and the drain ETA."""
    rec = checker.flight_recorder
    h = rec.health() if rec is not None else {}
    last = (rec.last_step() if rec is not None else None) or {}
    sps = h.get("ewma_states_per_sec")
    load = last.get("load_factor")
    parts = [
        f"depth={last.get('depth', checker.max_depth())}",
        f"states={checker.state_count()}",
        f"unique={checker.unique_state_count()}",
        f"states/s={sps if sps is not None else '-'}",
        f"load={load if load is not None else '-'}",
        f"mem={_watch_mem(rec)}",
        f"phase={h.get('phase', '-')}",
    ]
    dur_fn = getattr(checker, "durability_status", None)
    dur = dur_fn() if callable(dur_fn) else None
    auto = (dur or {}).get("autosave")
    if auto:
        age = auto.get("last_checkpoint_age_secs")
        parts.append("ckpt=" + ("-" if age is None else f"{age:.0f}s"))
    if h.get("stalled"):
        parts.append(f"STALLED({h.get('stall_reason') or '?'})")
    if h.get("oom_risk"):
        parts.append("OOM-RISK(next growth rung does not fit)")
    if h.get("eta_secs") is not None:
        parts.append(f"eta={h['eta_secs']}s")
    return " ".join(parts)


def _watch_mem(rec) -> str:
    """The ``mem=`` column: the device's allocated bytes when it reports
    them, else the ledger's analytic bytes; ``/limit (x%)`` when the
    device's memory is known; '-' without a memory ledger."""
    mem = rec.memory() if rec is not None else None
    if not mem:
        return "-"
    from ..telemetry.memory import fmt_bytes

    used = (mem.get("device") or {}).get("bytes_in_use", mem.get("total_bytes"))
    budget = mem.get("budget_bytes")
    if budget:
        return (f"{fmt_bytes(used)}/{fmt_bytes(budget)}"
                f"({100.0 * used / budget:.1f}%)")
    return fmt_bytes(used)


def watch_checker(checker, stream=None, interval: float = 0.25,
                  plain_every: float = 2.0):
    """Render the live status until the run completes, then one final
    line.  On a TTY the line rewrites in place (``\r`` and padding, no
    ANSI sequences); on any other stream it is one plain line every
    ``plain_every`` seconds."""
    stream = stream or sys.stderr
    tty = bool(getattr(stream, "isatty", lambda: False)())
    last_plain = -plain_every  # the first line comes at once
    width = 0

    def put(txt: str, end: str = "") -> None:
        nonlocal width
        if tty:
            stream.write("\r" + txt + " " * max(width - len(txt), 0) + end)
            width = len(txt)
        else:
            stream.write(txt + "\n")
        stream.flush()

    t0 = time.monotonic()
    while not checker.is_done():
        now = time.monotonic() - t0
        if tty or now - last_plain >= plain_every:
            put(watch_line(checker))
            last_plain = now
        time.sleep(interval)
    put(watch_line(checker), end="\n")
    return checker


def spawn_watched(checker, watch: bool):
    """``checker`` after the live view rendered it to completion, under
    ``watch``; else as it is (the caller's ``report()`` joins it)."""
    return watch_checker(checker) if watch else checker


# -- the telemetry verbs ---------------------------------------------------------


def _spawn_telemetry_run(model, builder, opts):
    """The GPU engine on ``device`` where the model has a twin, else the
    host BFS (its report simply carries no cartography block)."""
    if model._tensor_cached() is None:
        return builder.spawn_bfs().join()
    return builder.spawn_gpu(**gpu_kw(opts)).join()


def profile_verb(model, opts: dict, flags=(), stream=None) -> dict:
    """``profile``: one run under ``.telemetry(cartography=True,
    memory=True)``, written as flight-recorder JSONL (``--out``, default
    ``telemetry.jsonl``) and, with ``--chrome=F``, a Chrome trace; prints
    and returns the recorder's summary."""
    import json

    stream = stream or sys.stdout
    out = opts.get("out") or "telemetry.jsonl"
    b = with_step_flags(model.checker(), flags).telemetry(
        cartography=True, memory=True)
    rec = _spawn_telemetry_run(model, b, opts).flight_recorder
    rec.to_jsonl(out)
    if opts.get("chrome"):
        rec.to_chrome_trace(opts["chrome"])
    summary = rec.summary()
    print(json.dumps(summary, default=str), file=stream)
    print(f"telemetry JSONL written to {out}"
          + (f", Chrome trace to {opts['chrome']}" if opts.get("chrome")
             else ""), file=stream)
    return summary


def report_verb(model, opts: dict, flags=(), stream=None) -> str:
    """``report``: one run with ``.report(PATH)`` (``--out``, default
    ``run-report.json``; the markdown lands beside it); returns the
    path."""
    stream = stream or sys.stdout
    out = opts.get("out") or "run-report.json"
    b = with_step_flags(model.checker(), flags).report(out)
    _spawn_telemetry_run(model, b, opts)
    print(f"report written to {out} (and {os.path.splitext(out)[0]}.md)",
          file=stream)
    return out


def capacity_verb(model, opts: dict, stream=None, sym: bool = False,
                  spill: bool = False) -> int:
    """``capacity``: the memory ledger's capacity plan for the model's GPU
    run at the capacities ``spawn_gpu`` starts from, on the ``--batch=``
    of ``opts`` (``parallel/wavefront.default_caps``,
    ``telemetry/memory.py``): per table rung the steady bytes, the growth
    transient, and whether it fits the device's memory
    (``STATERIGHT_TPU_DEVICE_BYTES`` overrides it; with neither, the
    analytic ladder alone).  ``sym`` plans the symmetric verb's buffers,
    the larger footprint, so the plan holds for every GPU verb of the
    model.  ``spill`` (``capacity --spill``) plans with the spill tier
    armed: its device buffers count, and past the largest affordable rung
    the host tier's reach extends the headline (JAX ``_cli.py:738-770``).
    Exit 1 without a twin."""
    from ..parallel.wavefront import default_caps, memory_spec_fn
    from ..telemetry.memory import capacity_plan, device_budget, fmt_bytes

    stream = stream or sys.stdout
    tensor = model._tensor_cached()
    if tensor is None:
        print("capacity: this configuration has no device twin in the port "
              "(the host checkers keep nothing on the device)", file=stream)
        return 1
    kw = gpu_kw(opts)
    device = kw.pop("device") or "cuda"
    cuda = device.startswith("cuda")
    caps = default_caps(**kw)
    sp = ((1 << 23, 4 * caps["batch"] * tensor.max_actions) if spill
          else None)
    spec_fn = memory_spec_fn(tensor, len(model.properties()), sym=sym,
                             cuda=cuda, spill=sp)
    budget, src = device_budget(device if cuda else "cpu")
    plan = capacity_plan(spec_fn, caps, budget=budget, spill=spill)
    where = (f"device memory {fmt_bytes(budget)}, {src}" if budget
             else "no device memory known: the analytic footprint alone")
    print(f"capacity plan ({where}):", file=stream)
    print(f"  {'capacity':>12}  {'buffers':>9}  {'transient':>9}  fits",
          file=stream)
    for r in plan["rungs"]:
        fits = r.get("fits")
        print(f"  {r['capacity']:>12}  {fmt_bytes(r['total_bytes']):>9}  "
              f"{fmt_bytes(r['transient_bytes']):>9}  "
              f"{'-' if fits is None else ('yes' if fits else 'NO')}",
              file=stream)
    block = plan.get("spill")
    if block is not None:
        print(f"with --spill the hot tier holds ~{block['hot_max_unique']:,} "
              f"unique states and the host tier "
              f"~{block.get('host_max_unique', 0):,} more "
              f"({fmt_bytes(block['host_budget_bytes'])} at "
              f"{block['bytes_per_spilled']} bytes a state), the disk tier "
              "unbounded behind it", file=stream)
    elif plan.get("max_unique") is not None:
        print(f"on this device the run reaches ~{plan['max_unique']:,} "
              "unique states (the largest rung whose growth transient "
              "fits)" + ("" if spill else "; extend past it with --spill"),
              file=stream)
    return 0


def _load_report_arg(arg: str, registry_dir):
    """``(document, headline)`` for a report path or a registry run id."""
    import json

    from ..telemetry.registry import RunRegistry, resolve_run_dir

    if os.path.isfile(arg):
        with open(arg) as f:
            return json.load(f), None
    root = resolve_run_dir(registry_dir)
    if root is None:
        raise SystemExit(
            f"compare: {arg!r} is neither a report file nor a resolvable "
            "run id (pass --registry=DIR or set STATERIGHT_TPU_RUN_DIR)")
    reg = RunRegistry(root)
    doc = reg.find(arg)
    if doc is None:
        raise SystemExit(f"compare: run {arg!r} not found in {root}")
    return doc, reg.headline(arg)


def compare_verb(args: list, opts: dict, stream=None) -> int:
    """``compare A B``: the contract-aware diff of two run reports (files
    or registry run ids; ``telemetry/diff.py``).  Prints the rendering and
    one JSON line; exit 0 unless the pair is DIVERGENT, or
    ``--expect=VERDICT`` names another verdict."""
    import json

    from ..telemetry.diff import DIVERGENT, diff_reports, render_diff

    stream = stream or sys.stdout
    if len(args) != 2:
        print("usage: compare A B [--registry=DIR] [--expect=IDENTICAL|"
              "ISOMORPHIC|PERF-ONLY|DIVERGENT]", file=stream)
        return 2
    a_doc, a_head = _load_report_arg(args[0], opts.get("registry"))
    b_doc, b_head = _load_report_arg(args[1], opts.get("registry"))
    d = diff_reports(a_doc, b_doc, a_headline=a_head, b_headline=b_head)
    print(render_diff(d, label_a=args[0], label_b=args[1]), file=stream)
    print(json.dumps(d), file=stream)
    expect = (opts.get("expect") or "").upper().replace("_", "-")
    if expect:
        if d["verdict"] != expect:
            print(f"compare: verdict {d['verdict']} != expected {expect}",
                  file=stream)
            return 1
        return 0
    return 1 if d["verdict"] == DIVERGENT else 0


def compare_reports_cmd(rest: list, stream=None) -> int:
    """``compare A B [--registry=DIR] [--expect=VERDICT]`` from one argument
    list (JAX ``compare_reports_cmd``): :func:`compare_verb`."""
    opts, args = pop_values(list(rest))
    return compare_verb(args, opts, stream)


def supervised(model, flags=(), opts=None, sopts=None):
    """The ``supervise`` verb's spawn: :func:`run_supervised` on the
    model's builder with the step ``flags``, on the ``--device``/
    ``--batch`` of ``opts``; returns the supervised run."""
    b = with_step_flags(model.checker(), flags)
    return run_supervised(b, sopts or {}, **gpu_kw(opts))


def udp_spawn(banner: list, actors: list, background: bool = False):
    """The ``spawn`` verb: print ``banner`` and one ``Server listening on``
    line per actor, then run the ``(Id, actor)`` pairs on their UDP
    sockets (``actor/spawn.py``), blocking until they exit unless
    ``background``.  Returns the handles."""
    from ..actor import spawn

    for line in banner:
        print(line)
    for id, _ in actors:
        print(f"  Server listening on {id.to_addr()}")
    return spawn(actors, background=background)


def check_main(prog: str, arg_usage: str, argv, build: Callable,
               verbs: dict[str, tuple[Callable, Callable]],
               max_args: int, audit: Callable,
               independence: Optional[Callable] = None,
               sweep: Optional[Callable] = None,
               udp: Optional[Callable] = None) -> int:
    """``python -m stateright_tpu_torch.models.<prog> VERB ARGS
    [--per-channel] [--prededup] [--por] [--mxu] [--checked] [--spill]
    [--mesh] [--prewarm] [--compile-cache=DIR] [--watch] [--device=cpu]``:
    build
    the model from the positional arguments, print the verb's banner and
    check it.  ``verbs`` maps each verb the model offers to ``(banner,
    spawn)``: ``banner(args)`` is the line printed first, ``spawn(model)``
    one of this module's spawns.  The step flags, ``--watch`` and
    ``--device``/``--batch`` are for the GPU verbs (:func:`gpu`,
    :func:`sym_gpu`, :func:`supervised`, which also takes
    :func:`pop_supervise_opts`' flags); a model with a GPU verb also takes
    :data:`TELEMETRY_VERBS`.  ``audit`` is the module's ``_audit_models``
    factory, the ``audit`` verb's configurations; ``independence``, the
    ``independence`` verb (:func:`make_independence_cmd`), and ``sweep``,
    the ``sweep`` verb (:func:`make_sweep_cmd`), where the model has them;
    ``udp``, the ``spawn`` verb: ``udp(args)`` is ``(banner lines, [(Id,
    actor)])``, which :func:`udp_spawn` deploys.
    A verb whose spawn is :func:`explore` takes ``[N] [ADDRESS]``: the
    model from its first positional argument, the address from the
    second.
    Exit 1 when a GPU verb finds no device twin, the audit an
    error or the independence verb a malformed matrix, 2 on a usage
    error."""
    has_gpu = any(sp in (gpu, sym_gpu) for _, sp in verbs.values())
    names = (list(verbs) + (list(TELEMETRY_VERBS) if has_gpu else [])
             + ["audit", "sanitize", "costmodel"]
             + (["independence"] if independence else [])
             + (["sweep"] if sweep else []) + (["spawn"] if udp else []))
    usage = (f"usage: python -m stateright_tpu_torch.models.{prog} "
             f"{'|'.join(names)} {arg_usage} [{PER_CHANNEL_FLAG}] "
             f"[{'] ['.join(STEP_FLAGS)}] [{COMPILE_CACHE_FLAG}DIR] "
             f"[{WATCH_FLAG}] [--device=cpu]"
             + ("  (compare A B [--registry=DIR] [--expect=VERDICT]; "
                "profile/report [--out=F] [--chrome=F])" if has_gpu else ""))
    per_channel, args = pop_per_channel(
        list(sys.argv[1:] if argv is None else argv))
    flags, args = pop_step_flags(args)
    watch, args = pop_watch(args)
    opts, args = pop_values(args)
    sopts = None
    if args and args[0] == "supervise" and "supervise" in verbs:
        sopts, args = pop_supervise_opts(args)
    if sweep is not None and args and args[0] == "sweep":
        swopts, rest = pop_sweep_opts(args[1:])
        if len(rest) > 1:
            print(usage, file=sys.stderr)
            return 2
        return sweep(rest, dict(opts, **swopts))
    if has_gpu and args and args[0] == "compare":
        return compare_verb(args[1:], opts)
    if args and args[0] in verbs and verbs[args[0]][1] is explore:
        max_args = max(max_args, 2)  # explore [N] [ADDRESS]
    if (not args or args[0] not in names or len(args) > 1 + max_args):
        print(usage, file=sys.stderr)
        return 2
    verb, rest = args[0], args[1:]
    if verb == "spawn":
        if flags or watch or opts:
            print(usage, file=sys.stderr)
            return 2
        udp_spawn(*udp(rest))
        return 0
    if verb == "audit":
        return 0 if audit_and_report(audit(rest)) else 1
    if verb == "sanitize":
        ok, rules = sanitize_and_report(audit(rest))
        if not ok:
            print(f"sanitize: FAILED ({', '.join(rules)})")
        return 0 if ok else 1
    if verb == "costmodel":
        out = opts.get("out")
        if not costmodel_and_report(audit(rest), out=out):
            print("costmodel: FAILED")
            return 1
        return 0
    if verb == "independence":
        return independence(rest, per_channel=per_channel)
    if verb in TELEMETRY_VERBS:
        model = apply_encoding(build(rest), per_channel)
        if verb == "capacity":
            return capacity_verb(model, opts, sym=any(
                sp is sym_gpu for _, sp in verbs.values()),
                spill="--spill" in flags)
        (profile_verb if verb == "profile" else report_verb)(
            model, opts, flags)
        return 0
    banner, spawn = verbs[verb]
    if spawn is explore:
        if flags or watch or opts or len(rest) > 2:
            print(usage, file=sys.stderr)
            return 2
        line = banner(rest)
        if line:
            print(line)
        model = apply_encoding(build(rest[:1]), per_channel)
        explore(model, explore_addr(rest))
        return 0
    if spawn is supervised:
        print(banner(rest))
        model = apply_encoding(build(rest), per_channel)
        supervised(model, flags, opts, sopts)
        return 0
    if (flags or watch or opts) and spawn not in (gpu, sym_gpu):
        print("the step flags, --watch, --device= and --batch= are for the "
              "GPU verbs",
              file=sys.stderr)
        return 2
    print(banner(rest))
    model = apply_encoding(build(rest), per_channel)
    if spawn in (gpu, sym_gpu):
        checker = spawn(model, flags, opts, watch=watch)
    else:
        checker = spawn(model)
    if checker is None:
        print("this configuration has no device twin in the port",
              file=sys.stderr)
        return 1
    checker.report()
    return 0


# -- the audit verbs (analysis/; JAX _cli.py:388-417, :1781-1807) ---------------


def audit_and_report(models, stream=None) -> bool:
    """Audit ``(label, model)`` pairs, deep tier, and print one report
    each; True iff no error-severity finding anywhere."""
    from ..analysis import audit_model

    stream = stream or sys.stdout
    ok = True
    for label, model in models:
        report = audit_model(model, deep=True)
        print(f"--- {label}", file=stream)
        print(report.format(), file=stream)
        ok = ok and report.ok
    return ok


def _fleet(names, stream, each) -> bool:
    """Run ``each(factory_models, stream) -> ok`` over every model module
    (or just ``names``) through its ``_audit_models`` hook; a module
    without the hook fails the gate."""
    import importlib

    from . import __all__ as all_names

    ok = True
    for name in names or list(all_names):
        mod = importlib.import_module(f"stateright_tpu_torch.models.{name}")
        factory = getattr(mod, "_audit_models", None)
        if factory is None:
            print(f"--- {name}: FAILED: no _audit_models hook (add one so "
                  "the fleet gate covers this model)", file=stream)
            ok = False
            continue
        ok = each(factory([]), stream) and ok
    return ok


def fleet_audit(names=None, stream=None) -> int:
    """``audit [MODULE...]``: audit every model module of the port (or
    just ``names``) through its ``_audit_models`` hook; 0 iff clean.  A
    module without the hook fails the gate, so a new model cannot
    silently shrink its coverage."""
    stream = stream or sys.stdout
    ok = _fleet(names, stream,
                lambda models, st: audit_and_report(models, stream=st))
    print("audit fleet: " + ("CLEAN" if ok else "FAILED"), file=stream)
    return 0 if ok else 1


# -- the sanitize verbs (analysis/sanitizer.py; JAX _cli.py:422-511) -----------


def sanitize_and_report(models: Iterable[tuple], stream=None,
                        deep: bool = False) -> tuple:
    """The static sanitizer's view over ``(label, model)`` pairs: one
    summary line and the JX2xx findings each.  Returns ``(ok, rule_ids)``:
    ``ok`` iff no error-severity JX2xx finding anywhere.  The light audit
    tier suffices: the sanitizer runs in it."""
    from ..analysis import Severity, audit_model

    stream = stream or sys.stdout
    ok, bad_rules = True, set()
    for label, model in models:
        report = audit_model(model, deep=deep)
        summary = (report.metrics or {}).get("sanitizer")
        findings = [f for f in report.findings if f.rule_id.startswith("JX2")]
        errors = [f for f in findings if f.severity == Severity.ERROR]
        print(f"--- {label}", file=stream)
        if summary is None:
            print("sanitize: no device twin for this configuration (host "
                  "checkers unaffected)", file=stream)
        else:
            rules = ", ".join(summary.get("rules") or []) or "none"
            print(f"sanitize: {summary['sites']} indexed site(s) -- "
                  f"{summary['proved']} proved in range, "
                  f"{summary['undecided']} undecided (checked-mode "
                  f"candidates); rules fired: {rules}", file=stream)
        for f in findings:
            print("  " + f.format(), file=stream)
        if errors:
            ok = False
            bad_rules.update(f.rule_id for f in errors)
    return ok, tuple(sorted(bad_rules))


def fleet_sanitize(names=None, stream=None) -> int:
    """``sanitize [MODULE...]``: the static sanitizer over every model
    module (JAX ``fleet_sanitize``); 0 iff no JX2xx error anywhere."""
    stream = stream or sys.stdout
    bad: set = set()

    def each(models, stream):
        ok, rules = sanitize_and_report(models, stream=stream)
        bad.update(rules)
        return ok

    ok = _fleet(names, stream, each)
    verdict = "CLEAN" if ok else f"FAILED ({', '.join(sorted(bad))})"
    print(f"sanitize fleet: {verdict}", file=stream)
    return 0 if ok else 1


# -- the costmodel verbs (analysis/costmodel.py; JAX _cli.py:797-953) ----------

# the capacities the verb prices a step at (JAX _COSTMODEL_CAP/_BATCH)
COSTMODEL_CAP = 1 << 16
COSTMODEL_BATCH = 2048


def costmodel_and_report(models: Iterable[tuple], stream=None,
                         out=None) -> bool:
    """The roofline cost ledger over ``(label, model)`` pairs: per-stage
    FLOPs/bytes with op classes and intensity, verdicts where the card
    has a spec, the kernels' counts beside their plain walks, and the
    JX4xx findings.  ``out`` collects the blocks into a JSON file.  True
    iff every twin-bearing configuration gave a well-formed ledger whose
    kernels reconcile (twin-less models are named and skipped)."""
    import json

    from ..analysis.costmodel import wavefront_costs
    from ..parallel.tensor_model import twin_or_none
    from ..telemetry.memory import fmt_bytes
    from ..telemetry.roofline import classify_stages, device_spec

    stream = stream or sys.stdout
    spec = device_spec()
    ok = True
    blocks = []
    for label, model in models:
        print(f"--- {label}", file=stream)
        twin = twin_or_none(model)
        if twin is None:
            print("costmodel: no device twin for this configuration (host "
                  "checkers have no device pipeline)", file=stream)
            continue
        try:
            rep = wavefront_costs(twin, COSTMODEL_CAP, COSTMODEL_CAP // 2,
                                  COSTMODEL_BATCH)
        except Exception as e:  # noqa: BLE001 - a verdict, not a crash
            ok = False
            print(f"costmodel: ledger failed: {type(e).__name__}: {e}",
                  file=stream)
            continue
        if rep is None:
            ok = False
            print("costmodel: twin kernels did not capture (see the kernel "
                  "audit)", file=stream)
            continue
        static, recon = rep.static_block(), rep.recon_block()
        verdicts = classify_stages(static, spec)
        print(f"costmodel: {len(static['stages'])} stage(s), "
              f"{static['totals']['flops']:,} FLOPs / "
              f"{fmt_bytes(static['totals']['bytes'])} per step (batch "
              f"{static['batch']}); kernel reconciliation: "
              + ("ok" if recon["ok"] else "FAILED"), file=stream)
        for name, st in static["stages"].items():
            v = verdicts.get(name, {})
            extra = (f" -- {v['verdict']}"
                     if v.get("verdict") not in (None, "unknown") else "")
            print(f"  {name:>13}: {st['flops']:>12,} FLOPs  "
                  f"{fmt_bytes(st['bytes_read'] + st['bytes_written']):>9}  "
                  f"AI={st.get('intensity', '-')}" + extra, file=stream)
        for f in rep.findings:
            print("  " + f.format(), file=stream)
        if not recon["ok"]:
            ok = False
            for stage, ks in recon["stages"].items():
                for k, v in ks.items():
                    if not v.get("ok"):
                        print(f"  RECONCILE {stage}/{k}: "
                              f"{v.get('bytes_ratio', v.get('problem'))}",
                              file=stream)
        blocks.append({"label": label, **static, "reconciliation": recon,
                       **({"device_spec": spec} if spec else {}),
                       "verdicts": verdicts})
    if out:
        with open(out, "w") as f:
            json.dump({"v": blocks[0]["v"] if blocks else 1,
                       "configs": blocks}, f, indent=1)
            f.write("\n")
    return ok


def fleet_costmodel(names=None, stream=None) -> int:
    """``costmodel [MODULE...]``: the cost ledger over every model module
    (JAX ``fleet_costmodel``); 0 iff every twin-bearing configuration
    gave a well-formed, reconciling ledger."""
    stream = stream or sys.stdout
    ok = _fleet(names, stream,
                lambda models, st: costmodel_and_report(models, stream=st))
    print("costmodel fleet: " + ("OK" if ok else "FAILED"), file=stream)
    return 0 if ok else 1


# -- the independence verb (analysis/independence.py; JAX _cli.py:511-600) -----


def independence_and_report(models: Iterable[tuple], stream=None) -> tuple:
    """The static independence analysis over ``(label, model)`` pairs: one
    summary line and the JX3xx findings each.  Returns ``(ok, rule_ids)``:
    ``ok`` iff every model with a twin gives a WELL-FORMED conflict matrix
    (square, symmetric, dependent diagonal) and no error-severity JX3xx
    finding fires (the fleet gate's contract)."""
    import numpy as np

    from ..analysis import Severity
    from ..analysis.independence import run_independence
    from ..parallel.tensor_model import twin_or_none

    stream = stream or sys.stdout
    ok, bad_rules = True, set()
    for label, model in models:
        twin = twin_or_none(model)
        print(f"--- {label}", file=stream)
        if twin is None:
            print("independence: no device twin for this configuration "
                  "(host checkers unaffected)", file=stream)
            continue
        rep = run_independence(twin, list(model.properties()))
        s = rep.summary()
        c = np.asarray(rep.conflict)
        well_formed = (
            c.ndim == 2 and c.shape == (rep.n_actions, rep.n_actions)
            and bool(np.array_equal(c, c.T)) and bool(c.diagonal().all())
        )
        print(
            f"independence: {s['actions']} action(s), "
            f"{s['independent_pairs']} independent pair(s), "
            f"{s['visible_actions']} visible, "
            f"{s['undecided_actions']} undecided; "
            f"decomposed={s['decomposed']}"
            + (f"; encoding={s['encoding']}" if s.get("encoding") else "")
            + f"; rules fired: {', '.join(s['rules']) or 'none'}",
            file=stream,
        )
        if not well_formed:
            ok = False
            print("  MALFORMED conflict matrix", file=stream)
        for f in rep.findings:
            print("  " + f.format(), file=stream)
            if f.severity == Severity.ERROR:
                ok = False
                bad_rules.add(f.rule_id)
    return ok, tuple(sorted(bad_rules))


def make_independence_cmd(factory: Callable) -> Callable:
    """A ``rest -> [(label, model), ...]`` factory (a module's
    ``_audit_models``) as the ``independence`` verb, ``--per-channel``
    applied to its models: exit 1 on an error finding or a malformed
    matrix."""

    def independence(rest: list, per_channel: bool = False,
                     stream=None) -> int:
        models = [(label, apply_encoding(m, per_channel))
                  for label, m in factory(rest)]
        ok, rules = independence_and_report(models, stream=stream)
        if not ok:
            print(f"independence: FAILED ({', '.join(rules) or 'matrix'})",
                  file=stream or sys.stdout)
            return 1
        return 0

    return independence


def pop_sweep_opts(rest: list) -> tuple:
    """The ``sweep`` verb's own flags (JAX ``_cli.py:1043``; ``--batch=``
    and ``--device=`` are :data:`VALUE_OPTS`): ``(opts, rest)`` with
    ``runs`` (the registry directory), ``steps`` and ``capacity``, only
    those given."""
    names = {"--runs=": ("runs", str), "--steps=": ("steps", int),
             "--capacity=": ("capacity", int)}
    opts = {}
    kept = []
    for a in rest:
        for pre, (name, conv) in names.items():
            if a.startswith(pre):
                opts[name] = conv(a[len(pre):])
                break
        else:
            kept.append(a)
    return opts, kept


def make_sweep_cmd(family: Callable, default_n: int = 8) -> Callable:
    """A model's ``sweep`` verb (JAX ``_cli.py:1062``): build its default
    family (``family(N)``, a ``SweepSpec``), run it as one GPU sweep with
    cartography, and print one line per instance and the cohort summary.
    ``--device=cpu`` runs it on the plain path."""

    def cmd(rest: list, opts: Optional[dict] = None) -> int:
        opts = opts or {}
        n = int(rest[0]) if rest else default_n
        spec = family(n)
        print(f"Sweeping {len(spec.instances)} instances in one GPU run.")
        b = (spec.instances[0].model.checker().telemetry(cartography=True)
             .sweep(spec))
        if opts.get("runs"):
            b = b.runs(opts["runs"])
        kw = {"device": opts.get("device")}
        for opt, arg in (("batch", "batch"), ("steps", "steps_per_call"),
                         ("capacity", "capacity")):
            if opts.get(opt):
                kw[arg] = int(opts[opt])
        c = b.spawn_gpu(**kw).join()
        for inst in spec.instances:
            r = c.results[inst.key]
            disc = ",".join(sorted(r.chains)) or "-"
            print(f"  {inst.key}: unique={r.unique} states={r.states} "
                  f"depth={r.max_depth} discoveries=[{disc}]")
        print(f"sweep: {len(spec.instances)} instances over "
              f"{len(c.cohorts)} cohort(s), {c.engine_compiles} engine "
              f"compile(s), total unique={c.unique_state_count()} "
              f"states={c.state_count()}")
        if opts.get("runs"):
            print(f"sweep: registered {len(spec.instances)} instance "
                  f"record(s) under sweep_id={c.run_id} in {opts['runs']}")
        return 0

    return cmd


def fleet_independence(names=None, stream=None) -> int:
    """``independence [MODULE...]``: the analysis over every model module
    of the port (or just ``names``) through its ``_audit_models`` hook; 0
    iff every model gives a well-formed matrix and no error finding.  A
    module without the hook fails the gate, as in :func:`fleet_audit`."""
    stream = stream or sys.stdout
    bad: set = set()

    def each(models, stream):
        ok, rules = independence_and_report(models, stream=stream)
        bad.update(rules)
        return ok

    ok = _fleet(names, stream, each)
    verdict = "CLEAN" if ok else (
        f"FAILED ({', '.join(sorted(bad)) or 'matrix'})")
    print(f"independence fleet: {verdict}", file=stream)
    return 0 if ok else 1


# -- the supervise verb (supervisor.py; JAX _cli.py:1491-1584) --------------------


def pop_supervise_opts(rest: list) -> tuple:
    """Strip the supervise verb's flags: ``(opts, rest)``.  ``opts``
    carries ``autosave`` (the dir; a temp dir when omitted, printed so the
    operator can resume), ``every``/``keep`` (the cadence),
    ``max_restarts``, ``runs`` (the registry dir), ``steps`` (steps per
    block) and ``fault_plan``/``fault_log`` (a JSON ``FaultPlan`` to
    install, and where to write its fired trail)."""
    opts = {
        "autosave": None, "every": 60.0, "keep": 3, "max_restarts": 5,
        "runs": None, "fault_plan": None, "fault_log": None, "steps": None,
    }
    casts = {"autosave": str, "every": float, "keep": int,
             "max-restarts": int, "runs": str, "fault-plan": str,
             "fault-log": str, "steps": int}
    kept = []
    for a in rest:
        name = a[2:].split("=", 1)[0] if a.startswith("--") else None
        if name in casts and "=" in a:
            opts[name.replace("-", "_")] = casts[name](a.split("=", 1)[1])
        else:
            kept.append(a)
    return opts, kept


def run_supervised(builder, opts: dict, stream=None, **spawn_kw):
    """Drive one supervised run (``supervisor.supervise``) from a
    :func:`pop_supervise_opts` config; prints the one-line summary
    (``supervised: done=... states=... unique=... restarts=...
    run_id=...``) and returns the ``SupervisedRun``."""
    from ..supervisor import supervise
    from ..testing.faults import FaultPlan

    stream = stream or sys.stdout
    if opts.get("autosave") is None:
        import tempfile

        opts = dict(opts)
        opts["autosave"] = tempfile.mkdtemp(
            prefix="stateright-tpu-torch-autosave-")
        print(f"supervise: no --autosave=DIR given; checkpointing into "
              f"{opts['autosave']} (pass the same dir to resume after a "
              "kill)", file=stream)
    if opts.get("runs"):
        builder = builder.runs(opts["runs"])
    # the checkpoint and restart ring records need a recorder
    if builder.telemetry_opts is None:
        builder = builder.telemetry()
    if opts.get("steps"):
        spawn_kw.setdefault("steps_per_call", int(opts["steps"]))
    # the plan is armed process-wide: it is installed last and uninstalled
    # whatever happens, so no later run in the process meets its faults
    plan = (FaultPlan.from_file(opts["fault_plan"]) if opts.get("fault_plan")
            else None)
    try:
        if plan is not None:
            plan.install()
        res = supervise(
            builder, autosave_dir=opts["autosave"],
            every_secs=float(opts.get("every", 60.0)),
            keep=int(opts.get("keep", 3)),
            max_restarts=int(opts.get("max_restarts", 5)), **spawn_kw)
    finally:
        if plan is not None:
            plan.uninstall()
            if opts.get("fault_log"):
                plan.to_jsonl(opts["fault_log"])
    c = res.checker
    parent = c.parent_run_id
    print(
        f"supervised: done={c.is_done()} states={c.state_count()} "
        f"unique={c.unique_state_count()} restarts={res.restarts} "
        f"run_id={c.run_id}"
        + (f" parent_run_id={parent}" if parent else "")
        + (f" degradations={','.join(res.degradations)}"
           if res.degradations else ""),
        file=stream,
    )
    return res


# -- the run registry verb (telemetry/registry.py) ---------------------------


def fleet_runs(args: Optional[list] = None, stream=None) -> int:
    """``runs [DIR]``: list the persistent run registry — one line per
    archived run (id, config_key, model/engine, headline) plus the
    per-config trend summary the Explorer's dashboard draws (JAX
    ``_cli.py:1117``)."""
    from ..telemetry.registry import RunRegistry, resolve_run_dir

    stream = stream or sys.stdout
    args = list(args or [])
    root = resolve_run_dir(args[0] if args else None)
    if root is None:
        print(
            "runs: no registry configured (pass DIR or set "
            "STATERIGHT_TPU_RUN_DIR)",
            file=stream,
        )
        return 2
    reg = RunRegistry(root)
    recs = reg.index()
    if not recs:
        print(f"runs: registry at {root} is empty", file=stream)
        return 0

    def line(r, indent: str = "") -> None:
        h = r.get("headline") or {}
        bits = [
            indent + str(r.get("run_id")),
            str(r.get("config_key") or "-"),
            f"{r.get('model')}/{r.get('engine')}",
            f"unique={h.get('unique')}",
            f"done={h.get('done')}",
        ]
        if r.get("instance_key"):
            bits.insert(1, f"[{r['instance_key']}]")
        elif r.get("job_key"):
            bits.insert(1, f"[{r['job_key']}]")
        if h.get("states_per_sec") is not None:
            bits.append(f"{h['states_per_sec']}/s")
        if r.get("leg"):
            bits.append(f"leg={r['leg']}")
        if r.get("parent_run_id"):
            bits.append(f"parent={r['parent_run_id']}")
        bits.append(str(r.get("generated_at") or ""))
        print("  ".join(bits), file=stream)

    # sweep members group under one header row with a per-instance
    # verdict strip ('*' = at least one discovery, '.' = none), in the
    # ledger's append order; campaign jobs group the same way and win
    # when a record carries both tags
    # (a packed cohort member is a sweep instance owned by a campaign)
    groups: list = []
    by_group: dict = {}
    for r in recs:
        if r.get("campaign_id"):
            gid = ("campaign", r["campaign_id"], "job")
        elif r.get("sweep_id"):
            gid = ("sweep", r["sweep_id"], "instance")
        else:
            groups.append(r)
            continue
        g = by_group.get(gid)
        if g is None:
            g = by_group[gid] = {
                "kind": gid[0], "id": gid[1], "noun": gid[2],
                "members": [],
            }
            groups.append(g)
        g["members"].append(r)
    for g in groups:
        if "members" not in g:
            line(g)
            continue
        strip = "".join(
            "*" if (m.get("headline") or {}).get("discoveries") else "."
            for m in g["members"]
        )
        print(
            f"{g['kind']} {g['id']}  {len(g['members'])} {g['noun']}(s)"
            f"  verdicts [{strip}]",
            file=stream,
        )
        for m in g["members"]:
            line(m, indent="  ")
    trends = reg.trends(recs)
    print(
        f"runs: {len(recs)} archived over {len(trends)} config(s) at "
        f"{root}",
        file=stream,
    )
    for key, series in sorted(trends.items()):
        if len(series) > 1:
            u = [s.get("unique") for s in series]
            print(
                f"  trend {key}: {len(series)} runs, unique "
                f"{u[0]} -> {u[-1]}",
                file=stream,
            )
    return 0


# -- fleet / campaign verbs (fleet/; JAX _cli.py:1218-1491) -------------------


def _pop_fleet_opts(rest: list, defaults: dict) -> tuple:
    """Strip the fleet/campaign verbs' shared flags: ``(opts, rest)``.
    ``--slots``/``--budget``/``--spill``/``--no-pack`` shape the pool,
    ``--root`` hosts autosaves + artifacts, ``--runs`` the registry,
    ``--every`` the autosave cadence, ``--stall=KEY@STEP`` the
    deterministic preemption injection (``--stall=none`` disables), and
    ``--device=cpu`` runs every job on the plain PyTorch path (the
    port's; default ``cuda``)."""
    opts = dict(defaults)
    kept = []
    for a in rest:
        if a.startswith("--slots="):
            opts["slots"] = int(a[len("--slots="):])
        elif a.startswith("--budget="):
            opts["budget"] = int(a[len("--budget="):])
        elif a == "--spill":
            opts["spill"] = True
        elif a == "--no-pack":
            opts["pack"] = False
        elif a.startswith("--root="):
            opts["root"] = a[len("--root="):]
        elif a.startswith("--runs="):
            opts["runs"] = a[len("--runs="):]
        elif a.startswith("--every="):
            opts["every"] = float(a[len("--every="):])
        elif a.startswith("--stall="):
            opts["stall"] = a[len("--stall="):]
        elif a.startswith("--max-restarts="):
            opts["max_restarts"] = int(a[len("--max-restarts="):])
        elif a.startswith("--id="):
            opts["id"] = a[len("--id="):]
        elif a.startswith("--grid="):
            opts["grid"] = a[len("--grid="):]
        elif a.startswith("--device="):
            opts["device"] = a[len("--device="):]
        else:
            kept.append(a)
    return opts, kept


def _canned_fleet_jobs(runs_dir: Optional[str]) -> list:
    """The ``fleet`` verb's six-tenant workload (JAX ``_cli.py:1254``):
    three packable TwoPhaseSys(3) jobs (one cohort, one engine build), a
    TwoPhaseSys(4) and a TwoPhaseSys(5) singleton, and a paxos
    single-client job: mixed shapes over one pool."""
    from ..checker.base import CheckerBuilder
    from ..fleet import Job
    from .paxos import paxos_model
    from .two_phase_commit import TwoPhaseSys

    def twopc(n):
        def build():
            b = CheckerBuilder(TwoPhaseSys(n))
            return b.runs(runs_dir) if runs_dir else b
        return build

    def paxos():
        def build():
            b = CheckerBuilder(paxos_model(1))
            return b.runs(runs_dir) if runs_dir else b
        return build

    return [
        Job(key="2pc-a", build=twopc(3), packable=True,
            capacity=1 << 12, batch=256, params={"rm": 3}),
        Job(key="2pc-b", build=twopc(3), packable=True,
            capacity=1 << 12, batch=256, params={"rm": 3}),
        Job(key="2pc-c", build=twopc(3), packable=True,
            capacity=1 << 12, batch=256, params={"rm": 3}),
        Job(key="2pc-4", build=twopc(4),
            capacity=1 << 13, batch=256, params={"rm": 4}),
        Job(key="2pc-5", build=twopc(5), priority=1,
            capacity=1 << 14, batch=512, params={"rm": 5}),
        Job(key="paxos-1", build=paxos(),
            capacity=1 << 12, batch=256, params={"clients": 1}),
    ]


def _print_job_results(res, stream) -> None:
    """One grep-able line per job result (the CI smoke's contract)."""
    from ..fleet import COMPLETED

    for r in res.results.values():
        bits = [f"fleet job {r.key}: status={r.status}",
                f"decision={r.decision}"]
        if r.status == COMPLETED:
            bits += [f"unique={r.unique}", f"states={r.states}",
                     f"depth={r.max_depth}"]
        if r.cohort:
            bits.append(f"cohort={r.cohort}")
        if r.preemptions:
            bits.append(f"preemptions={r.preemptions}")
        if r.run_id:
            bits.append(f"run_id={r.run_id}")
        if r.parent_run_id:
            bits.append(f"parent_run_id={r.parent_run_id}")
        if r.reason:
            bits.append(f"reason={r.reason}")
        print("  ".join(bits), file=stream)


def _audit_lineage(res, runs_dir: Optional[str], stream) -> int:
    """Exactly-once audit: every preempted-then-completed job must
    compare IDENTICAL against its yielded parent (``contract:
    lineage``); returns the worst compare exit code."""
    from ..fleet import COMPLETED

    rc = 0
    for r in res.results.values():
        if not (r.preemptions and r.status == COMPLETED):
            continue
        if not (runs_dir and r.run_id and r.parent_run_id):
            print(
                f"fleet lineage {r.key}: UNVERIFIABLE (no registry or "
                "run ids; pass --runs=DIR)",
                file=stream,
            )
            rc = rc or 1
            continue
        print(
            f"fleet lineage {r.key}: parent={r.parent_run_id} "
            f"child={r.run_id}",
            file=stream,
        )
        code = compare_reports_cmd(
            [r.parent_run_id, r.run_id, f"--registry={runs_dir}",
             "--expect=IDENTICAL"],
            stream=stream,
        )
        rc = rc or code
    return rc


def fleet_schedule(args: Optional[list] = None, stream=None) -> int:
    """The ``fleet`` verb: canned multi-tenant chaos smoke — six mixed
    2pc/paxos jobs over a simulated N-slot pool with one injected
    stall-preemption.  Every job must complete with its
    pinned counts and the preempted job's resume must compare IDENTICAL
    against its yielded parent (the line CI greps for ``contract:
    lineage``).  Exit 0 iff all jobs completed and lineage verified.
    JAX ``_cli.py:1347``; ``--device=cpu`` runs the jobs on the plain
    PyTorch path."""
    return canned_fleet(args, stream)[0]


def canned_fleet(args: Optional[list] = None, stream=None) -> tuple:
    """The ``fleet`` verb's body: ``(exit code, FleetResult)``, the
    result None when the arguments were refused."""
    import tempfile

    from ..fleet import FleetSpec, PreemptionPlan, run_fleet

    stream = stream or sys.stdout
    opts, rest = _pop_fleet_opts(list(args or []), {
        "slots": 2, "budget": None, "spill": False, "pack": True,
        "root": None, "runs": None, "every": 0.0, "stall": "2pc-5@5",
        "max_restarts": 2, "device": None,
    })
    if rest:
        print(f"fleet: unknown argument(s) {rest}", file=stream)
        return 2, None
    root = opts["root"] or tempfile.mkdtemp(
        prefix="stateright-tpu-torch-fleet-")
    runs_dir = opts["runs"] or os.path.join(root, "runs")
    jobs = _canned_fleet_jobs(runs_dir)
    spec = FleetSpec(
        jobs=jobs, slots=opts["slots"],
        slot_budget_bytes=opts["budget"], spill=opts["spill"],
        pack=opts["pack"], max_restarts=opts["max_restarts"],
    )
    plan = None
    if opts["stall"] and opts["stall"] != "none":
        key, _, step = opts["stall"].partition("@")
        plan = PreemptionPlan({key: int(step or 3)})
        print(
            f"fleet: injecting a stall-preemption into {key} at step "
            f"{int(step or 3)}",
            file=stream,
        )
    print(
        f"fleet: {len(jobs)} job(s) over {spec.slots} slot(s) "
        f"(pack={spec.pack}, spill={spec.spill}, root={root})",
        file=stream,
    )
    res = run_fleet(
        spec, root=root, preemption=plan, every_secs=opts["every"],
        stream=stream, device=opts["device"],
    )
    _print_job_results(res, stream)
    print(
        f"fleet: completed={res.completed} failed={res.failed} "
        f"refused={res.refused} preemptions={res.preemptions} "
        f"engine_compiles={res.engine_compiles} "
        f"packed={sum(len(p['jobs']) for p in res.packed)} "
        f"secs={res.secs:.1f}",
        file=stream,
    )
    rc = 0 if (res.failed == 0 and res.refused == 0) else 1
    return rc or _audit_lineage(res, runs_dir, stream), res


#: the campaign verb's named model factories: name -> (factory, default
#: grid).  Factories take grid-point params as keyword arguments.
_CAMPAIGN_FACTORIES = {
    "2pc": (
        lambda rm=3: __import__(
            "stateright_tpu_torch.models.two_phase_commit",
            fromlist=["TwoPhaseSys"],
        ).TwoPhaseSys(rm),
        {"rm": [3, 4]},
    ),
    "paxos": (
        lambda clients=1: __import__(
            "stateright_tpu_torch.models.paxos", fromlist=["paxos_model"],
        ).paxos_model(clients),
        {"clients": [1]},
    ),
}


def fleet_campaign(args: Optional[list] = None, stream=None) -> int:
    """The ``campaign`` verb: expand a parameter grid into fleet jobs,
    schedule them over the pool, and write the campaign ledger (JAX
    ``_cli.py:1425``).  ``campaign 2pc --grid='{"rm":[3,4]}'``
    checks TwoPhaseSys at both sizes under one campaign id; the ledger
    (per-job wall-clock, compile accounting, aggregate states/s) lands
    at ``ROOT/campaign.json``.  Exit 0 iff no job failed."""
    import json
    import tempfile

    from ..fleet import LEDGER_NAME, campaign_spec, run_campaign

    stream = stream or sys.stdout
    opts, rest = _pop_fleet_opts(list(args or []), {
        "slots": 2, "budget": None, "spill": False, "pack": True,
        "root": None, "runs": None, "every": 0.0, "stall": None,
        "max_restarts": 2, "id": None, "grid": None, "device": None,
    })
    name = rest[0] if rest else "2pc"
    if name not in _CAMPAIGN_FACTORIES or len(rest) > 1:
        print(
            "usage: campaign [2pc|paxos] [--grid=JSON] [--root=DIR] "
            "[--runs=DIR] [--slots=N] [--budget=BYTES] [--spill] "
            "[--no-pack] [--id=CID] [--device=cpu]",
            file=stream,
        )
        return 2
    factory, grid = _CAMPAIGN_FACTORIES[name]
    if opts["grid"]:
        grid = json.loads(opts["grid"])
    root = opts["root"] or tempfile.mkdtemp(
        prefix="stateright-tpu-torch-campaign-"
    )
    spec = campaign_spec(
        factory, grid, campaign_id=opts["id"],
        slots=opts["slots"], slot_budget_bytes=opts["budget"],
        spill=opts["spill"], pack=opts["pack"],
        max_restarts=opts["max_restarts"],
        run_dir=opts["runs"] or os.path.join(root, "runs"),
    )
    print(
        f"campaign {spec.campaign_id}: {len(spec.jobs)} job(s) from "
        f"grid {json.dumps(grid, sort_keys=True)} over {spec.slots} "
        f"slot(s) (root={root})",
        file=stream,
    )
    res, ledger = run_campaign(
        spec, root=root, every_secs=opts["every"], stream=stream,
        device=opts["device"],
    )
    _print_job_results(res, stream)
    print(
        f"campaign {spec.campaign_id}: completed={ledger['completed']} "
        f"failed={ledger['failed']} refused={ledger['refused']} "
        f"preemptions={ledger['preemptions']} "
        f"engine_compiles={ledger['engine_compiles']} "
        f"secs={ledger['secs']} total_states={ledger['total_states']} "
        f"states_per_sec={ledger['states_per_sec']}",
        file=stream,
    )
    print(
        f"campaign: ledger written to {os.path.join(root, LEDGER_NAME)}",
        file=stream,
    )
    return 0 if ledger["failed"] == 0 else 1


# -- the status verb (checkpoint.read_progress; JAX _cli.py:1810-1870) ----------


def fleet_status(argv=None, stream=None) -> int:
    """``status RUN_DIR``: the progress heartbeat of a headless run (the
    atomic ``progress.json`` beside its autosave generations), and any
    per-job heartbeat under ``RUN_DIR/jobs/*/``.  It works post-mortem: a
    SIGKILLed run leaves its last heartbeat, and a stale ``running``
    status prints as ``DEAD``.  Exit 0 iff a heartbeat was found."""
    from ..checkpoint import read_progress

    stream = stream or sys.stdout
    argv = argv or []
    if not argv:
        print("usage: status RUN_DIR", file=stream)
        return 1
    root = argv[0]

    def render(tag: str, doc: dict) -> None:
        bits = [f"--- {tag}: {doc.get('verdict', '?').upper()}"]
        if doc.get("age_secs") is not None:
            bits.append(f"age={doc['age_secs']:.1f}s")
        for k in ("states", "unique", "steps", "frontier", "queue",
                  "depth", "phase", "ewma_states_per_sec", "eta_secs",
                  "jobs", "running", "queued", "completed", "preemptions"):
            v = doc.get(k)
            if v is None:
                continue
            bits.append(f"{k}={len(v) if isinstance(v, list) else v}")
        if doc.get("stalled"):
            bits.append(f"STALLED({doc.get('stall_reason') or '?'})")
        print("  ".join(bits), file=stream)

    found = 0
    top = read_progress(root)
    if top is not None:
        render(root, top)
        found += 1
    jobs_dir = os.path.join(root, "jobs")
    if os.path.isdir(jobs_dir):
        for name in sorted(os.listdir(jobs_dir)):
            doc = read_progress(os.path.join(jobs_dir, name))
            if doc is not None:
                render(f"jobs/{name}", doc)
                found += 1
    if not found:
        print(f"status: no progress.json under {root} (a run without "
              "autosave, or not started yet)", file=stream)
        return 1
    return 0


def main(argv=None) -> int:
    """``python -m stateright_tpu_torch.models._cli status RUN_DIR |
    runs [DIR] | fleet [FLAGS] | campaign [2pc|paxos] [FLAGS] |
    audit [MODULE...] | independence [MODULE...] | sanitize [MODULE...] |
    costmodel [MODULE...]``."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "status":
        return fleet_status(argv[1:])
    if argv and argv[0] == "runs":
        return fleet_runs(argv[1:])
    if argv and argv[0] == "fleet":
        return fleet_schedule(argv[1:])
    if argv and argv[0] == "campaign":
        return fleet_campaign(argv[1:])
    if argv and argv[0] == "audit":
        return fleet_audit(argv[1:])
    if argv and argv[0] == "independence":
        return fleet_independence(argv[1:])
    if argv and argv[0] == "sanitize":
        return fleet_sanitize(argv[1:])
    if argv and argv[0] == "costmodel":
        return fleet_costmodel(argv[1:])
    print("usage: python -m stateright_tpu_torch.models._cli\n"
          "  status RUN_DIR     the progress heartbeat of a headless run "
          "(DEAD when a running one went stale)\n"
          "  runs [DIR]         the run registry (campaign jobs and sweep "
          "members grouped)\n"
          "  fleet [--slots=N] [--root=DIR] [--runs=DIR] [--stall=KEY@STEP] "
          "[--device=cpu]  the canned six-tenant fleet\n"
          "  campaign [2pc|paxos] [--grid=JSON] [--device=cpu]  a parameter "
          "grid as a fleet campaign, with its ledger\n"
          "  audit [MODULE...]  the static audit of every model (exit 1 "
          "on an error finding)\n"
          "  independence [MODULE...]  the independence analysis of every "
          "model (exit 1 on a malformed matrix or an error finding)\n"
          "  sanitize [MODULE...]  the static sanitizer over every model "
          "(exit 1 on a JX2xx error)\n"
          "  costmodel [MODULE...]  the roofline cost ledger of every model "
          "(exit 1 on a malformed or non-reconciling ledger)",
          file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
