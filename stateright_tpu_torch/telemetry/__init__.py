"""Flight recorder: streaming run telemetry for every checker strategy.

The port's counterpart of ``stateright_tpu/telemetry/``: its own copy of
every host-only module (the port imports nothing of the JAX package), and
the two device-facing ones rebuilt on PyTorch: the memory ledger
(``memory.py``: the GPU engine's carry AND its kernels' resident scratch,
``torch.cuda.memory_stats``), the scoped profiler (``profile.py``:
``torch.profiler``) and the roofline view (``roofline.py``: the cost
model's stages against the card's spec, matched on its name).  Left for
later items: the fleet's and the Explorer's metric consumers, and the
sharded engine's extras.

Pieces:

 - :class:`FlightRecorder` (``recorder.py``) — a bounded ring buffer of
   structured records plus monotone aggregate counters.  Engines append one
   ``step`` record per host sync (the GPU engine: one per
   ``steps_per_call`` block; host engines: one per job block / mp round),
   plus ``growth`` / ``occupancy`` / ``memory`` / ``cartography`` /
   ``checkpoint`` / ``profile`` / ``span`` events.
 - JSONL + Chrome-trace export (``export.py``) — ``to_jsonl`` /
   ``from_jsonl`` round-trip (a file written by either package's recorder
   reads in the other's), and ``to_chrome_trace`` for chrome://tracing /
   Perfetto.
 - :class:`ScopedProfiler` (``profile.py``) — a scoped ``torch.profiler``
   trace of the first N blocks of a GPU run, written as a Chrome trace.
 - :class:`RunRegistry` (``registry.py``) — the persistent append-only
   run ledger (``CheckerBuilder.runs(DIR)`` / ``STATERIGHT_TPU_RUN_DIR``).
 - ``diff.py`` — the contract-aware cross-run diff
   (IDENTICAL / ISOMORPHIC / PERF-ONLY / DIVERGENT) behind the
   ``compare`` CLI verb.
 - ``spans.py`` — span-structured tracing (engine run → host seams);
   span records ride the ring and export as nested Chrome events.
 - :class:`MetricsBus` (``metrics.py``) — the typed-metrics bus
   (counters/gauges/histograms with labeled families and Prometheus text
   rendering); a recorder publishes to it when built with
   ``FlightRecorder(metrics=bus)``, ``.telemetry(metrics=True)`` or
   ``STATERIGHT_TPU_METRICS=1`` (the process default bus, which the
   Explorer's ``GET /metrics`` serves).

Enabled per run via ``model.checker().telemetry()``; the recorder then
hangs off the checker as ``checker.flight_recorder``.  **Overhead
contract**: telemetry reads only host values the engine already reads
(the packed stats tensor), so with it off the step dispatches exactly the
operations it did without it, and a block still makes one host read.
Cartography is the one option that adds device work (a few reductions a
step, and the depth histogram once a block, all inside the same stats
read).
"""

from .recorder import FlightRecorder, STATUS_NAMES
from .profile import ScopedProfiler
from .health import HealthTracker
from .registry import RunRegistry
from .spans import SpanContext, SpanHandle, span, start_span
from .metrics import MetricsBus, default_bus, reset_default_bus

__all__ = [
    "FlightRecorder",
    "HealthTracker",
    "MetricsBus",
    "RunRegistry",
    "ScopedProfiler",
    "SpanContext",
    "SpanHandle",
    "STATUS_NAMES",
    "default_bus",
    "reset_default_bus",
    "span",
    "start_span",
]
