"""Structured runtime telemetry: nested spans, instants, and counters.

One :class:`Tracer` instance observes one run.  Instrumented code records
three kinds of facts into a bounded in-memory buffer:

* **spans** — ``with tracer.span("opt_alpha.solve", cat="solve", n_active=8)``
  wraps a stretch of host work.  A span records its name, category,
  ``time.perf_counter_ns`` start/end, the recording thread id, its nesting
  depth on that thread, an optional logical *track*, and arbitrary
  key=value attrs.  Categories are the attribution axis (the summary CLI
  groups by them); the conventional set is
  ``solve`` / ``stage`` / ``h2d`` / ``dispatch`` / ``device``
  (blocked-on-device).  Tracks are the *timeline* axis: by default a span
  lands on its recording thread's track, but a logical override (e.g.
  ``track="prefetcher"`` for staging work, ``track="device"`` for fence
  spans) groups related spans onto one named Perfetto row regardless of
  which thread ran them.
* **instants** — ``tracer.instant("segment", cat="schedule", epoch=3)``
  marks a point in time (rendered as a thin arrow in Perfetto); the channel
  schedule uses these for epoch boundaries.
* **counters** — ``tracer.count("opt_alpha.cache_hits")`` accumulates
  monotonic totals (ints or floats).  Counters are aggregates, not events:
  they cost a dict update, never buffer space.

Everything is thread-safe (spans record on exit under one lock; nesting
depth is tracked per-thread), and the buffer is bounded: past
``max_events`` new events are counted in ``dropped`` instead of appended,
so a runaway instrumentation site cannot eat the host's memory.

:class:`NullTracer` is the disabled path.  Its ``enabled`` attribute is
``False`` and every method is a constant-returning no-op, so instrumented
hot loops guard extra work (attribute computation, device fences) behind a
single ``if tracer.enabled:`` check and disabled runs stay bit- and
perf-identical to uninstrumented code.  The module-level :data:`NULL_TRACER`
singleton is the default everywhere a ``tracer`` parameter is accepted.

This module is stdlib-only (no torch, no numpy): importing telemetry can
never drag in an accelerator runtime.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable

__all__ = [
    "CounterDict",
    "InstantEvent",
    "NULL_TRACER",
    "NullTracer",
    "SpanEvent",
    "Tracer",
]

CounterDict = dict  # name -> accumulated int | float


@dataclasses.dataclass(frozen=True)
class SpanEvent:
    """One completed span (recorded at ``__exit__``)."""

    name: str
    cat: str
    t0_ns: int
    t1_ns: int
    tid: int  # recording thread id (threading.get_ident)
    depth: int  # nesting depth on the recording thread (0 = top level)
    track: str | None  # logical track override (None ⇒ the thread's track)
    attrs: dict

    @property
    def dur_ns(self) -> int:
        return self.t1_ns - self.t0_ns


@dataclasses.dataclass(frozen=True)
class InstantEvent:
    """A point-in-time marker."""

    name: str
    cat: str
    t_ns: int
    tid: int
    track: str | None
    attrs: dict


class _NullSpan:
    """The shared no-op context manager ``NullTracer.span`` returns."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """The disabled tracer: every call is a no-op, ``enabled`` is False.

    Instrumentation sites hold a tracer unconditionally and branch on
    ``tracer.enabled`` only where tracing would add work that changes
    behavior or cost (device fences, attr computation); plain
    ``with tracer.span(...)`` on a NullTracer is itself only three cheap
    calls on shared constants.
    """

    __slots__ = ()
    enabled = False

    def span(self, name, *, cat="default", track=None, **attrs):
        return _NULL_SPAN

    def instant(self, name, *, cat="default", track=None, **attrs):
        return None

    def count(self, name, value=1):
        return None


NULL_TRACER = NullTracer()


class _Span:
    """Live span handle: measures on ``__enter__``/``__exit__``, records the
    completed :class:`SpanEvent` on exit (so buffer order is end-time order
    and a crashed span never leaves a half-open event behind)."""

    __slots__ = ("_tracer", "_name", "_cat", "_track", "_attrs", "_t0", "_depth")

    def __init__(self, tracer, name, cat, track, attrs):
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._track = track
        self._attrs = attrs

    def __enter__(self):
        local = self._tracer._local
        self._depth = getattr(local, "depth", 0)
        local.depth = self._depth + 1
        self._t0 = self._tracer._clock()
        return self

    def __exit__(self, *exc):
        t1 = self._tracer._clock()
        self._tracer._local.depth = self._depth
        self._tracer._record(
            SpanEvent(
                name=self._name,
                cat=self._cat,
                t0_ns=self._t0,
                t1_ns=t1,
                tid=threading.get_ident(),
                depth=self._depth,
                track=self._track,
                attrs=self._attrs,
            )
        )
        return False


class Tracer:
    """Collects spans, instants and counters for one run.

    ``clock`` defaults to ``time.perf_counter_ns`` (monotonic, ns); tests
    inject a deterministic counter for golden-value assertions.  ``events``
    is the bounded buffer (read it directly or through the exporters in
    :mod:`repro_torch.obs.export`); ``counters`` the accumulated totals;
    ``dropped`` how many events the bound rejected.
    """

    enabled = True

    def __init__(
        self,
        *,
        max_events: int = 1_000_000,
        clock: Callable[[], int] = time.perf_counter_ns,
    ):
        if max_events < 1:
            raise ValueError("max_events must be >= 1")
        self.max_events = int(max_events)
        self._clock = clock
        self._lock = threading.Lock()
        self._local = threading.local()
        self.events: list[SpanEvent | InstantEvent] = []
        self.counters: CounterDict[str, Any] = {}
        self.dropped = 0
        self.thread_names: dict[int, str] = {}
        self.t_start_ns = clock()

    # ------------------------------------------------------------- recording
    def span(self, name: str, *, cat: str = "default", track: str | None = None, **attrs):
        """A context manager timing one stretch of work.  ``cat`` is the
        attribution phase, ``track`` an optional logical timeline, ``attrs``
        free-form span metadata (must be JSON-serializable for export)."""
        return _Span(self, name, cat, track, attrs)

    def instant(self, name: str, *, cat: str = "default", track: str | None = None, **attrs):
        """Mark a point in time (e.g. a segment boundary)."""
        self._record(
            InstantEvent(
                name=name,
                cat=cat,
                t_ns=self._clock(),
                tid=threading.get_ident(),
                track=track,
                attrs=attrs,
            )
        )

    def count(self, name: str, value=1):
        """Accumulate a monotonic counter (int or float)."""
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + value

    def _record(self, event) -> None:
        tid = event.tid
        with self._lock:
            if tid not in self.thread_names:
                # the recorder is always the current thread (spans record on
                # exit from the thread that entered them)
                self.thread_names[tid] = threading.current_thread().name
            if len(self.events) >= self.max_events:
                self.dropped += 1
                return
            self.events.append(event)

    # ------------------------------------------------------------- inspection
    @property
    def spans(self) -> list[SpanEvent]:
        return [e for e in self.events if isinstance(e, SpanEvent)]

    @property
    def instants(self) -> list[InstantEvent]:
        return [e for e in self.events if isinstance(e, InstantEvent)]

    def wall_seconds(self) -> float:
        """Span of the recorded timeline: last event end minus first event
        start, in seconds (0.0 for an empty buffer)."""
        t0 = t1 = None
        for e in self.events:
            a = e.t0_ns if isinstance(e, SpanEvent) else e.t_ns
            b = e.t1_ns if isinstance(e, SpanEvent) else e.t_ns
            t0 = a if t0 is None else min(t0, a)
            t1 = b if t1 is None else max(t1, b)
        if t0 is None:
            return 0.0
        return (t1 - t0) / 1e9
