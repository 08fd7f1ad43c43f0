"""Audit driver: resolve a model's device twin, run every pass, cache.

The port's own copy of ``stateright_tpu/analysis/audit.py``.
``audit_model(model)`` is the one entry point behind
``CheckerBuilder.audit()``, the ``spawn_gpu`` preflight and the ``audit``
and ``sanitize`` CLI verbs.  Passes:

 - the actor-handler lint (``handler_lint``) when the model is an actor
   system;
 - the kernel audit (``kernel_audit.py``: ``JX000``-``JX107``) and the
   sanitizer's static interval pass (``sanitizer.py``: ``JX200``-
   ``JX205``) over the twin's kernels, in both tiers as JAX runs them
   (JAX :331-336): ``JX201``/``JX202`` are exactly what the preflight
   must abort on, since an out-of-range index ends the CUDA context;
 - the config-lifecycle checks (``CF*``, below).

The kernel passes walk the twin's kernels captured with ``make_fx``
(``analysis/graph.py``, cached on the twin), the capture the footprint
pass, the independence analysis (``JX300``-``JX305``, run by ``.por()``
and the ``independence`` verbs, not by the audit) and the cost model
(``JX400``-``JX402``, the ``costmodel`` verb and
``.telemetry(roofline=True)``) share.

``deep=True`` adds the expensive passes (the bounded closure-domain probe
and the fresh-twin drift re-resolve); the ``spawn_gpu`` preflight runs the
light tier, so a spawn pays little for it, while ``.audit()`` and the CLI
default to deep.

Config rules:

 - ``CF301`` error -- the model's configuration changed after its tensor
   twin was resolved (the cached twin no longer matches a fresh resolve,
   or the builder signature drifted).  ``TensorBackedModel`` raises on
   builder mutations only *after the first fingerprint*; this check makes
   the silent window before that (direct attribute writes, bypassed
   builder methods) a preflight failure instead of a mid-run mix of
   fingerprint schemes.
 - ``CF302`` info -- the model declares ``tensor_model()`` but no twin
   resolves (the GPU engine is unavailable; host checkers unaffected).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .handler_lint import run_handler_lint
from .kernel_audit import run_kernel_audit
from .report import AuditReport, Severity
from .sanitizer import run_sanitizer

_SIMPLE = (int, float, str, bool, bytes, tuple, frozenset, type(None))


def _value_repr(v) -> str:
    """Address-free repr of a config value.  Containers sign by CONTENT
    (via the repo's structural ``stable_hash``) — a length tag would let
    two same-sized-but-different configs share one cached report, and
    would blind CF301 to length-preserving mutations."""
    if isinstance(v, _SIMPLE):
        return repr(v)
    if isinstance(v, (list, set, dict, tuple, frozenset)):
        from ..fingerprint import stable_hash

        try:
            return f"<{type(v).__name__} h={stable_hash(v):x}>"
        except Exception:  # noqa: BLE001 - unhashable exotic content
            return f"<{type(v).__name__} len={len(v)}>"
    return f"<{type(v).__name__}>"


def _code_tag(cls, method_names) -> str:
    """Per-process fingerprint of the methods the audit actually inspects.
    Keys the report cache to the CODE, not just the class name: a
    redefined same-named class (notebook iteration, reload) must not be
    served the old class's findings — the reproduced failure mode was a
    fixed handler still refusing to spawn on a stale AH201 report."""
    h = 0
    for name in method_names:
        code = getattr(getattr(cls, name, None), "__code__", None)
        if code is not None:
            try:
                h = (h * 1000003 + hash((code.co_code, code.co_consts))) & (
                    (1 << 32) - 1
                )
            except TypeError:
                h = (h * 1000003 + hash(code.co_code)) & ((1 << 32) - 1)
    return format(h, "x")


_AUDITED_MODEL_METHODS = (
    "tensor_model", "init_states", "actions", "next_state", "properties",
)
_AUDITED_ACTOR_METHODS = ("on_start", "on_msg", "on_timeout")


def _obj_sig(obj, audited_methods=_AUDITED_MODEL_METHODS) -> str:
    """Value-based signature of a config-carrying object (a model or an
    actor): qualified class name + code tag + dataclass fields or shallow
    simple attributes.  Never the default ``repr`` — that embeds a memory
    address, which (a) misses every attribute mutation and (b) can
    collide after GC reuse."""
    cls = type(obj)
    # module + qualname + __name__ (dynamically generated classes rename
    # themselves via __name__) + a code tag over the audited methods
    parts = [
        f"{cls.__module__}.{cls.__qualname__}/{cls.__name__}"
        f"#{_code_tag(cls, audited_methods)}"
    ]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            try:
                parts.append(f"{f.name}={_value_repr(getattr(obj, f.name))}")
            except Exception:  # noqa: BLE001 - best-effort signature
                pass
    else:
        for k in sorted(getattr(obj, "__dict__", {})):
            if k.startswith("_"):
                continue
            parts.append(f"{k}={_value_repr(obj.__dict__[k])}")
    return ",".join(parts)


def config_signature(model) -> str:
    """Cheap, process-stable fingerprint of a model's *configuration*
    surface: dataclass fields / simple attributes plus the ActorModel
    builder state (each actor signed by value, not by object identity).
    Recorded when the tensor twin resolves; a later mismatch means the
    config mutated underneath a cached twin (rule ``CF301``)."""
    parts = [_obj_sig(model)]
    actors = getattr(model, "actors", None)
    if isinstance(actors, list):
        parts.append(
            "actors="
            + ";".join(_obj_sig(a, _AUDITED_ACTOR_METHODS) for a in actors)
        )
        parts.append(f"lossy={getattr(model, 'lossy', None)!r}")
        parts.append(f"network={type(getattr(model, 'init_network', None)).__name__}")
        try:
            parts.append("props=" + ",".join(p.name for p in model.properties()))
        except Exception:  # noqa: BLE001
            pass
    return "|".join(parts)


def _resolve_twin(model, report: AuditReport, sig=None):
    """Resolve the device twin WITHOUT freezing the fingerprint scheme
    (unlike ``TensorBackedModel._tensor_cached``, which marks the config
    frozen): auditing a model must stay a read-only operation.  The twin
    is still cached on the model the same way, so an audit-then-spawn
    never compiles twice.  Returns ``(twin, fresh)``: a freshly resolved
    twin cannot have drifted yet, so the deep CF301 re-resolve (a second
    full tabulation for compiled models) is skipped for it."""
    if hasattr(model, "_tensor_model_cache"):
        tm = getattr(model, "_tensor_model_cache")
        if tm is None:
            # keep the twin-less explanation on EVERY report, not just the
            # one built when the None twin was first cached
            report.add(
                "CF302",
                Severity.INFO,
                "tensor_model",
                "no device twin for this configuration; spawn_gpu is "
                "unavailable, host checkers unaffected",
            )
        return tm, False
    fn = getattr(model, "tensor_model", None)
    if fn is None:
        return None, False
    try:
        tm = fn()
    except Exception as e:  # noqa: BLE001 - CompileError etc: host fallback
        report.add(
            "CF302",
            Severity.INFO,
            "tensor_model",
            f"no device twin ({type(e).__name__}: {e}); spawn_gpu is "
            "unavailable for this configuration, host checkers unaffected",
        )
        return None, True
    try:
        object.__setattr__(model, "_tensor_model_cache", tm)
        object.__setattr__(
            model,
            "_tensor_config_sig",
            sig if sig is not None else config_signature(model),
        )
    except Exception:  # noqa: BLE001 - __slots__ models: skip caching
        pass
    if tm is None:
        report.add(
            "CF302",
            Severity.INFO,
            "tensor_model",
            "no device twin for this configuration (tensor_model() returned "
            "None); spawn_gpu is unavailable, host checkers unaffected",
        )
    return tm, True


def _check_config_drift(
    model, twin, report: AuditReport, deep: bool, sig=None
) -> None:
    """CF301: a cached twin must still match the live configuration."""
    if twin is None or not hasattr(model, "_tensor_model_cache"):
        return
    recorded = getattr(model, "_tensor_config_sig", None)
    if sig is None:
        sig = config_signature(model)
    if recorded is not None and recorded != sig:
        report.add(
            "CF301",
            Severity.ERROR,
            "builder",
            "configuration mutated after the tensor twin was resolved "
            "(builder signature drifted); the cached twin would fingerprint "
            "with the OLD configuration, silently mixing fingerprint "
            "schemes — re-create the model or configure it fully before "
            "resolving/checking",
        )
        return
    if not deep:
        return
    fn = getattr(model, "tensor_model", None)
    if fn is None:
        return
    try:
        fresh = fn()
    except Exception as e:  # noqa: BLE001 - surfaced as drift
        report.add(
            "CF301",
            Severity.ERROR,
            "builder",
            f"tensor_model() no longer resolves ({type(e).__name__}: {e}) "
            "but a twin is cached: configuration mutated after resolution",
        )
        return
    if fresh is None:
        report.add(
            "CF301",
            Severity.ERROR,
            "builder",
            "tensor_model() now returns None but a twin is cached: "
            "configuration mutated after resolution",
        )
        return
    drift = (
        getattr(fresh, "width", None) != getattr(twin, "width", None)
        or getattr(fresh, "max_actions", None) != getattr(twin, "max_actions", None)
    )
    if not drift:
        try:
            a = np.asarray(twin.init_rows())
            b = np.asarray(fresh.init_rows())
            drift = a.shape != b.shape or not np.array_equal(a, b)
        except Exception:  # noqa: BLE001 - can't compare: leave undecided
            return
    if drift:
        report.add(
            "CF301",
            Severity.ERROR,
            "builder",
            "configuration mutated after the tensor twin was resolved: a "
            "fresh tensor_model() disagrees with the cached twin "
            f"(width {getattr(twin, 'width', '?')} -> "
            f"{getattr(fresh, 'width', '?')}, max_actions "
            f"{getattr(twin, 'max_actions', '?')} -> "
            f"{getattr(fresh, 'max_actions', '?')}); the run would silently "
            "mix fingerprint schemes",
        )


# Process-wide report cache keyed by configuration signature: test suites
# and bench sweeps re-create identical configs by the dozen, and the audit
# of a (class, config) pair is deterministic.  Never consulted for a model
# whose live config drifted from its twin-resolution snapshot (CF301 must
# fire per instance).
_SHARED_REPORTS: dict = {}
_SHARED_REPORTS_MAX = 512


def audit_model(model, *, deep: bool = False, tensor=None,
                share: bool = True) -> AuditReport:
    """Run every static-analysis pass over ``model`` and return the
    :class:`AuditReport` (JAX :274).  Reports are cached on the model and
    in a process-wide config-keyed cache (invalidated by configuration
    changes via :func:`config_signature`), so the spawn-path preflight is
    free on respawns and on same-config re-creations.  A deep report
    serves a light request too.  ``tensor`` overrides twin resolution (a
    one-off probe of a bare twin, never cached); ``share=False`` keeps
    the report out of the process-wide cache.  The report is also
    ``model._audit_report``, which the run report's ``audit`` and
    ``sanitizer`` blocks read."""
    sig = config_signature(model)
    drifted = (
        hasattr(model, "_tensor_model_cache")
        and getattr(model, "_tensor_config_sig", sig) != sig
    )
    cached = getattr(model, "_audit_report_cache", None)
    if (cached is not None and cached[0] == sig and (cached[1] or not deep)
            and tensor is None and not drifted):
        return cached[2]
    if share and tensor is None and not drifted:
        hit = _SHARED_REPORTS.get(sig)
        if hit is not None and (hit[0] or not deep):
            report = hit[1].copy()  # the cached one stays pristine
            try:
                object.__setattr__(model, "_audit_report_cache",
                                   (sig, hit[0], report))
                object.__setattr__(model, "_audit_report", report)
            except Exception:  # noqa: BLE001 - __slots__ models
                pass
            return report

    report = AuditReport(model=type(model).__name__)
    if tensor is not None:
        twin, fresh_twin = tensor, True
    else:
        twin, fresh_twin = _resolve_twin(model, report, sig=sig)

    # actor systems: handler lint (AH*); the AH205 severity depends on
    # whether the compiled twin already declares a state_bound
    if getattr(model, "actors", None):
        run_handler_lint(
            model,
            report,
            deep=deep,
            bounded_twin=bool(getattr(twin, "_has_state_bound", False)),
        )

    if twin is not None:
        run_kernel_audit(twin, report, model=model, deep=deep)
        # the value-level pass runs in the light tier too: JX201/JX202 are
        # the class the spawn preflight exists to abort on
        run_sanitizer(twin, report, model=model)
        _check_config_drift(
            model, twin, report, deep and not fresh_twin, sig=sig
        )

    if tensor is not None:
        # an override twin's findings must never be served for the
        # model's real twin (the spawn preflight included)
        return report
    try:
        object.__setattr__(model, "_audit_report_cache", (sig, deep, report))
        object.__setattr__(model, "_audit_report", report)
    except Exception:  # noqa: BLE001 - __slots__ models: skip caching
        pass
    if share and not drifted:
        if len(_SHARED_REPORTS) >= _SHARED_REPORTS_MAX:
            _SHARED_REPORTS.clear()
        _SHARED_REPORTS[sig] = (deep, report.copy())
    return report
