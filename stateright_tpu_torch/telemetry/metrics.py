"""Typed metrics bus: counters / gauges / histograms with labeled
families, rendered in Prometheus text exposition for ``GET /metrics``.

The port's own copy of ``stateright_tpu/telemetry/metrics.py``, with the
engine families, the fleet's pool families (:func:`fleet_families`, JAX
:364) and the roofline block (:func:`roofline_families`: each stage's
static FLOPs, bytes and intensity, published off the roofline ledger's
``roofline`` record, which the JAX package does not publish).

The bus is the LIVE aggregation layer over telemetry the engines already
collect at host syncs: :meth:`FlightRecorder.step` publishes the engine
families (states/s, frontier size, table load, dedup rate), the
occupancy hook publishes its gauge, and the fleet scheduler publishes
pool families (queue depth, slot utilization, preemptions, admission
outcomes).  Samples are taken ONLY at host syncs that already
happen — zero extra device round-trips, and with the bus detached
(the default) the recorder adds nothing (parity pinned by test).

Design rules:

 - **Families are typed and registered once.**  ``counter()`` /
   ``gauge()`` / ``histogram()`` return the existing family on
   re-registration with the same type and raise on a type conflict —
   a family cannot silently change meaning mid-run.
 - **Counters are monotone.**  ``inc()`` rejects negative deltas;
   sources with cumulative totals publish their per-step deltas.
 - **Label cardinality is bounded.**  Each family caps its distinct
   label-sets (``max_series``, default 64); crossing the cap raises —
   an unbounded label (a raw run id, a state fingerprint) is a bug in
   the publisher, not a bigger dashboard.
 - **Thread-safe.**  Engines publish from run threads while the HTTP
   handler scrapes; every mutation and render takes the bus lock.

``default_bus()`` is the process-wide registry the Explorer's
``GET /metrics`` serves (``explorer.py``); ``STATERIGHT_TPU_METRICS=1`` (or
``.telemetry(metrics=True)``) attaches it to a run's recorder.
"""

from __future__ import annotations

import math
import threading
from typing import Optional

METRICS_V = 1

# default per-family distinct label-set cap (the cardinality guard)
MAX_SERIES = 64

# default histogram buckets: seconds-shaped (host-sync blocks run
# milliseconds to minutes)
DEFAULT_BUCKETS = (
    0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 60.0,
)

_NAME_OK = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_:"
)


def _check_name(name: str) -> str:
    if not name or name[0].isdigit() or not set(name) <= _NAME_OK:
        raise ValueError(f"invalid metric name {name!r}")
    return name


def _fmt(v: float) -> str:
    """Prometheus number formatting: integers bare, floats as-is."""
    if v == math.inf:
        return "+Inf"
    f = float(v)
    if f.is_integer():
        return str(int(f))
    return repr(f)


def _label_str(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_escape(str(v))}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


class _Family:
    """One named family; per-label-set series live under it."""

    kind = "untyped"

    def __init__(self, bus: "MetricsBus", name: str, help: str,
                 labelnames: tuple):
        self.bus = bus
        self.name = _check_name(name)
        self.help = str(help)
        self.labelnames = tuple(labelnames)
        self._series: dict = {}

    def labels(self, **kv):
        """The series for one label-set (created on first use; the
        cardinality guard trips when a family crosses the bus's
        ``max_series`` distinct label-sets)."""
        if set(kv) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: labels {sorted(kv)} != declared "
                f"{sorted(self.labelnames)}"
            )
        key = tuple(str(kv[k]) for k in self.labelnames)
        with self.bus._lock:
            s = self._series.get(key)
            if s is None:
                if len(self._series) >= self.bus.max_series:
                    raise ValueError(
                        f"metric family {self.name!r} crossed the "
                        f"label-cardinality cap ({self.bus.max_series} "
                        "series): an unbounded label value is a "
                        "publisher bug, not a bigger dashboard"
                    )
                s = self._make_series()
                self._series[key] = s
            return s

    def _make_series(self):
        raise NotImplementedError

    def _render(self, lines: list) -> None:
        lines.append(f"# HELP {self.name} {self.help}")
        lines.append(f"# TYPE {self.name} {self.kind}")
        for key, s in sorted(self._series.items()):
            labels = dict(zip(self.labelnames, key))
            s._render(self.name, labels, lines)


class _CounterSeries:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1) -> None:
        if n < 0:
            raise ValueError(f"counter decrement ({n}): counters are "
                             "monotone; publish a gauge instead")
        self.value += n

    def _render(self, name, labels, lines) -> None:
        lines.append(f"{name}{_label_str(labels)} {_fmt(self.value)}")


class Counter(_Family):
    kind = "counter"

    def _make_series(self):
        return _CounterSeries()

    def inc(self, n: float = 1, **labels) -> None:
        self.labels(**labels).inc(n)


class _GaugeSeries:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def _render(self, name, labels, lines) -> None:
        lines.append(f"{name}{_label_str(labels)} {_fmt(self.value)}")


class Gauge(_Family):
    kind = "gauge"

    def _make_series(self):
        return _GaugeSeries()

    def set(self, v: float, **labels) -> None:
        self.labels(**labels).set(v)


class _HistogramSeries:
    __slots__ = ("buckets", "counts", "sum", "count")

    def __init__(self, buckets):
        self.buckets = buckets
        self.counts = [0] * len(buckets)
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        self.sum += v
        self.count += 1
        for i, le in enumerate(self.buckets):
            if v <= le:
                self.counts[i] += 1

    def _render(self, name, labels, lines) -> None:
        cum = 0
        for le, c in zip(self.buckets, self.counts):
            cum += c  # counts are per-bucket internally; exposition is
            # cumulative, as the format requires
            lines.append(
                f"{name}_bucket{_label_str({**labels, 'le': _fmt(le)})} "
                f"{cum}"
            )
        lines.append(
            f"{name}_bucket{_label_str({**labels, 'le': '+Inf'})} "
            f"{self.count}"
        )
        lines.append(f"{name}_sum{_label_str(labels)} {_fmt(self.sum)}")
        lines.append(f"{name}_count{_label_str(labels)} {self.count}")


class Histogram(_Family):
    kind = "histogram"

    def __init__(self, bus, name, help, labelnames,
                 buckets=DEFAULT_BUCKETS):
        super().__init__(bus, name, help, labelnames)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket")

    def _make_series(self):
        return _HistogramSeries(self.buckets)

    def observe(self, v: float, **labels) -> None:
        self.labels(**labels).observe(v)


class MetricsBus:
    """The typed family registry + Prometheus renderer."""

    def __init__(self, max_series: int = MAX_SERIES):
        self.max_series = int(max_series)
        self._lock = threading.RLock()
        self._families: dict = {}

    def _register(self, cls, name, help, labelnames, **kw):
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if type(fam) is not cls:
                    raise ValueError(
                        f"metric family {name!r} already registered as "
                        f"{fam.kind}, not {cls.kind}"
                    )
                return fam
            fam = cls(self, name, help, tuple(labelnames), **kw)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "", labelnames=()) -> Counter:
        return self._register(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "", labelnames=()) -> Gauge:
        return self._register(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "", labelnames=(),
                  buckets=DEFAULT_BUCKETS) -> Histogram:
        return self._register(
            Histogram, name, help, labelnames, buckets=buckets
        )

    def families(self) -> list:
        with self._lock:
            return sorted(self._families)

    def expose(self) -> str:
        """The whole bus in Prometheus text exposition format (the body
        of ``GET /metrics``)."""
        lines: list = []
        with self._lock:
            for name in sorted(self._families):
                self._families[name]._render(lines)
        return "\n".join(lines) + ("\n" if lines else "")


# -- the process-wide bus (what GET /metrics scrapes) ------------------------

_DEFAULT: Optional[MetricsBus] = None
_DEFAULT_LOCK = threading.Lock()


def default_bus() -> MetricsBus:
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = MetricsBus()
        return _DEFAULT


def reset_default_bus() -> None:
    """Testing hook: drop the process bus so family values start clean."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        _DEFAULT = None


# -- the standard family catalogue (docs/observability.md) -------------------
# Publishers resolve families through these helpers so every engine and
# the fleet agree on names/labels; the catalogue is pinned by tests and
# the CI /metrics smoke.

ENGINE_LABELS = ("engine", "model")


def engine_families(bus: MetricsBus) -> dict:
    return {
        "states": bus.counter(
            "stateright_states_total",
            "cumulative states generated (per-step deltas)",
            ENGINE_LABELS,
        ),
        "unique": bus.counter(
            "stateright_unique_states_total",
            "cumulative unique states inserted",
            ENGINE_LABELS,
        ),
        "sps": bus.gauge(
            "stateright_states_per_sec",
            "per-sync-step throughput",
            ENGINE_LABELS,
        ),
        "frontier": bus.gauge(
            "stateright_frontier_size",
            "queue/frontier depth at the last host sync",
            ENGINE_LABELS,
        ),
        "load": bus.gauge(
            "stateright_table_load",
            "visited-table load factor",
            ENGINE_LABELS,
        ),
        "dedup": bus.gauge(
            "stateright_dedup_ratio",
            "fraction of generated states already visited",
            ENGINE_LABELS,
        ),
        "step": bus.histogram(
            "stateright_step_seconds",
            "host-sync step-block wall time",
            ENGINE_LABELS,
        ),
        "occupancy": bus.gauge(
            "stateright_table_occupancy",
            "bucket-table occupancy (occupancy_stats load factor)",
            ENGINE_LABELS,
        ),
        "spilled": bus.gauge(
            "stateright_spilled_fps",
            "fingerprints resident in the spill tier",
            ENGINE_LABELS,
        ),
        "imbalance": bus.gauge(
            "stateright_shard_imbalance",
            "mesh per-shard load imbalance (max/mean)",
            ENGINE_LABELS,
        ),
    }


def fleet_families(bus: MetricsBus) -> dict:
    """The fleet scheduler's pool families (JAX ``telemetry/metrics.py:
    364``), published from :meth:`FlightRecorder.set_fleet` snapshots and
    the scheduler's admission ticks."""
    return {
        "queue": bus.gauge(
            "stateright_fleet_queue_depth", "jobs waiting for a slot"
        ),
        "slots": bus.gauge(
            "stateright_fleet_slots", "configured pool slots"
        ),
        "busy": bus.gauge(
            "stateright_fleet_slots_busy", "slots running a job now"
        ),
        "completed": bus.counter(
            "stateright_fleet_jobs_completed_total", "jobs completed"
        ),
        "preemptions": bus.counter(
            "stateright_fleet_preemptions_total", "cooperative preemptions"
        ),
        "admissions": bus.counter(
            "stateright_fleet_admissions_total",
            "admission outcomes by decision",
            ("decision",),
        ),
    }


ROOFLINE_LABELS = ENGINE_LABELS + ("stage",)


def roofline_families(bus: MetricsBus) -> dict:
    """The roofline block: the cost model's per-stage static counts for
    one step (``telemetry/roofline.py``), published once at spawn off
    the ``roofline`` record."""
    return {
        "flops": bus.gauge(
            "stateright_roofline_stage_flops",
            "static FLOPs per step of one pipeline stage",
            ROOFLINE_LABELS,
        ),
        "bytes": bus.gauge(
            "stateright_roofline_stage_bytes",
            "static bytes moved per step by one pipeline stage",
            ROOFLINE_LABELS,
        ),
        "intensity": bus.gauge(
            "stateright_roofline_stage_intensity",
            "static arithmetic intensity (FLOPs per byte) of one stage",
            ROOFLINE_LABELS,
        ),
    }
