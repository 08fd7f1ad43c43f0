"""Span-structured tracing: the live half of the telemetry stack.

The port's own copy of ``stateright_tpu/telemetry/spans.py``.  In the
port the engine opens the ``engine_run`` span and its host seams
(``growth``, ``autosave``) under the supervisor's ``attempt`` span
(``supervisor.py``); the fleet level comes with its item.

Dapper-style hierarchical spans over the work that hops scheduler →
supervisor → engine: a **trace** is one fleet run (or one standalone
check), and each unit of work inside it is a **span** with a fresh
``span_id`` and its parent's ``span_id`` as ``parent_id``:

    fleet ──┬── job (one scheduling episode on a slot)
            │     └── attempt (one supervised spawn+join)
            │           └── engine_run (one engine's whole run)
            │                 ├── step blocks (the existing ``step``
            │                 │   records — the engine binds its run
            │                 │   span to the recorder, so every step
            │                 │   carries ``span=<engine span id>``)
            │                 └── host seams: ``autosave``,
            │                     ``spill_drain``, ``resharding``
            └── job ...

Span ids are minted where the work is minted — the fleet scheduler
roots the trace, ``supervise()`` opens one span per attempt, the
engines one per run — and the context propagates DOWN via the builder
(``builder._span_ctx``), never through globals.  A span closes by
recording one ``span`` record into the flight recorder's ring
(``kind="span"``: name, trace/span/parent ids, ``dur``; the record's
``t`` is the close time, so ``t - dur`` is the start).  The Chrome-trace
exporter (:func:`telemetry.export.to_chrome_trace`) turns the records
into nested duration events — one Perfetto load shows the whole fleet
timeline.

Overhead contract (the telemetry discipline): spans are host-side
bookkeeping at seams that already exist — one ``uuid`` and two
``time.monotonic()`` calls per span, one dict per close.  No recorder →
nothing is recorded; the step program is untouched either way.
"""

from __future__ import annotations

import time
import uuid
from typing import Optional

# span record schema version (tests/test_telemetry_schema.py pins it)
SPAN_V = 1


def new_id() -> str:
    """A fresh 64-bit id (hex) for traces and spans alike."""
    return uuid.uuid4().hex[:16]


class SpanContext:
    """The (trace_id, span_id) pair a child span parents under.  Flows
    down the spawn path as ``builder._span_ctx``; immutable in use."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: Optional[str] = None,
                 span_id: Optional[str] = None):
        self.trace_id = trace_id or new_id()
        self.span_id = span_id or new_id()

    def __repr__(self) -> str:  # debugging/log lines only
        return f"SpanContext(trace={self.trace_id}, span={self.span_id})"


class SpanHandle:
    """An open span: created by :func:`start_span`, closed by
    :meth:`end` (which records the ``span`` record).  ``.ctx`` is what
    children parent under.  ``end`` is idempotent — a double close
    records nothing twice."""

    __slots__ = ("name", "ctx", "parent_id", "_t0", "_closed")

    def __init__(self, name: str, parent: Optional[SpanContext] = None):
        self.name = str(name)
        self.ctx = SpanContext(
            trace_id=parent.trace_id if parent is not None else None
        )
        self.parent_id = parent.span_id if parent is not None else None
        self._t0 = time.monotonic()
        self._closed = False

    def end(self, recorder, **attrs) -> Optional[dict]:
        """Close the span and record it into ``recorder`` (None → the
        span is dropped, by the no-recorder-no-telemetry rule).  Extra
        ``attrs`` ride the record (they must stay within the golden
        schema's optional set).  Returns the stored record (or None)."""
        if self._closed:
            return None
        self._closed = True
        dur = round(time.monotonic() - self._t0, 6)
        if recorder is None:
            return None
        fields = {
            "v": SPAN_V,
            "name": self.name,
            "trace_id": self.ctx.trace_id,
            "span_id": self.ctx.span_id,
            "dur": dur,
        }
        if self.parent_id is not None:
            fields["parent_id"] = self.parent_id
        fields.update({k: v for k, v in attrs.items() if v is not None})
        return recorder.record("span", **fields)


def start_span(name: str, parent: Optional[SpanContext] = None) -> SpanHandle:
    """Open a span (child of ``parent``; a fresh trace root without
    one).  Close it with :meth:`SpanHandle.end`."""
    return SpanHandle(name, parent)


class span:
    """Context-manager form for block-shaped seams::

        with span("autosave", rec, parent=self._span_ctx, gen=3):
            ...write the generation...

    The record lands on exit — exception or not (the seam's duration is
    real either way); the original exception always propagates."""

    def __init__(self, name: str, recorder, *,
                 parent: Optional[SpanContext] = None, **attrs):
        self._handle = SpanHandle(name, parent)
        self._recorder = recorder
        self._attrs = attrs

    @property
    def ctx(self) -> SpanContext:
        return self._handle.ctx

    def __enter__(self) -> "span":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        attrs = dict(self._attrs)
        if exc_type is not None:
            attrs.setdefault("error", exc_type.__name__)
        self._handle.end(self._recorder, **attrs)
        return False  # never swallow the block's exception
