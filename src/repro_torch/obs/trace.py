"""Structured runtime telemetry: nested spans, instants, and counters.

One :class:`Tracer` instance observes one run.  Instrumented code records
three kinds of facts into a bounded in-memory buffer:

* **spans** — ``with tracer.span("opt_alpha.solve", cat="solve", n_active=8)``
  wraps a stretch of host work.  A span records its name, category,
  ``time.perf_counter_ns`` start/end, the recording thread id, its nesting
  depth on that thread, an optional logical *track*, and arbitrary
  key=value attrs.  Categories are the attribution axis (the summary CLI
  groups by them); the conventional set is
  ``solve`` / ``stage`` / ``h2d`` / ``dispatch`` / ``wait`` (host blocked)
  / ``device`` (the device's own execution).  Tracks are the *timeline*
  axis: by default a span lands on its recording thread's track, but a
  logical override (e.g. ``track="prefetcher"`` for staging work,
  ``track="device"`` for device spans) groups related spans onto one named
  Perfetto row regardless of which thread ran them.
  A *device span*, ``tracer.device_span(name, start, end)``, is a span
  whose two ends are device events (objects with ``query``,
  ``synchronize`` and ``elapsed_time``, as ``torch.cuda.Event`` has) rather
  than host clock readings.  It is placed on the tracer's clock through an
  *anchor* (:meth:`Tracer.anchor`): an event recorded while its stream was
  idle, pinned at the midpoint of the clock read just before its record
  and just after it completed.  The span stays pending until both of its
  events have completed and becomes an ordinary :class:`SpanEvent`
  (``clock="device"``) whenever ``events`` or ``spans`` is read, or on
  :meth:`Tracer.flush`.  ``repro_torch.obs.device`` makes the events.
* **instants** — ``tracer.instant("segment", cat="schedule", epoch=3)``
  marks a point in time (rendered as a thin arrow in Perfetto); the channel
  schedule uses these for epoch boundaries.
* **counters** — ``tracer.count("opt_alpha.cache_hits")`` accumulates
  monotonic totals (ints or floats).  Counters are aggregates, not events:
  they cost a dict update, never buffer space.  A count the device computes
  (``Tracer.device_count``) is held, like a device span, until the event
  behind its copy to the host has completed, and added on the next read.

Everything is thread-safe (spans record on exit under one lock; nesting
depth is tracked per-thread), and the buffer is bounded: past
``max_events`` new events are counted in ``dropped`` instead of appended,
so a runaway instrumentation site cannot eat the host's memory.

:class:`NullTracer` is the disabled path.  Its ``enabled`` attribute is
``False`` and every method is a constant-returning no-op, so instrumented
hot loops guard extra work (attribute computation, device events) behind a
single ``if tracer.enabled:`` check and disabled runs stay bit- and
perf-identical to uninstrumented code.  The module-level :data:`NULL_TRACER`
singleton is the default everywhere a ``tracer`` parameter is accepted.

This module is stdlib-only (no torch, no numpy): importing telemetry can
never drag in an accelerator runtime.  It calls nothing on a device event
but ``query``, ``synchronize`` and ``elapsed_time``.
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
    # "host": the tracer's clock read on the host; "device": both ends are
    # device events placed on the tracer's clock through an anchor
    clock: str = "host"

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

    def discard(self):
        return None


_NULL_SPAN = _NullSpan()


class NullTracer:
    """The disabled tracer: every call is a no-op, ``enabled`` is False.

    Instrumentation sites hold a tracer unconditionally and branch on
    ``tracer.enabled`` only where tracing would add work that changes
    behavior or cost (device events, attr computation); plain
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

    __slots__ = ("_tracer", "_name", "_cat", "_track", "_attrs", "_t0", "_depth", "_keep")

    def __init__(self, tracer, name, cat, track, attrs):
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._track = track
        self._attrs = attrs
        self._keep = True

    def discard(self):
        """Leave this span out of the buffer: the work it wrapped turned
        out not to be what it names (e.g. staging that hid behind the
        device is no wait).  Its nesting depth unwinds as usual."""
        self._keep = False

    def __enter__(self):
        local = self._tracer._local
        self._depth = getattr(local, "depth", 0)
        local.depth = self._depth + 1
        self._t0 = self._tracer._clock()
        return self

    def __exit__(self, *exc):
        t1 = self._tracer._clock()
        self._tracer._local.depth = self._depth
        if not self._keep:
            return False
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


@dataclasses.dataclass(frozen=True)
class _PendingSpan:
    """A device span whose events may not have completed yet."""

    name: str
    cat: str
    track: str | None
    attrs: dict
    tid: int
    start: Any
    end: Any
    anchor: tuple  # (event, its time on the tracer's clock, ns)


class Tracer:
    """Collects spans, instants and counters for one run.

    ``clock`` defaults to ``time.perf_counter_ns`` (monotonic, ns); tests
    inject a deterministic counter for golden-value assertions.  ``events``
    is the bounded buffer (read it directly or through the exporters in
    :mod:`repro_torch.obs.export`; reading it turns the device spans whose
    events have completed into events); ``counters`` the accumulated totals
    (reading it adds the device counts whose event has completed);
    ``dropped`` how many events the bound rejected (a pending device span
    holds its place in the bound).  One tracer times one device: device
    spans are placed through its latest anchor.
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
        self._events: list[SpanEvent | InstantEvent] = []
        self._pending: list[_PendingSpan] = []
        self._pending_counts: list[tuple] = []  # (event, {name: host value})
        self._anchor: tuple | None = None
        self._counters: CounterDict[str, Any] = {}
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
            self._add(name, value)

    def _add(self, name: str, value) -> None:
        self._counters[name] = self._counters.get(name, 0) + value

    def device_count(self, values: dict, event) -> None:
        """Accumulate counters whose values the device computed: ``values``
        maps a name to a host tensor (or number) that a copy enqueued before
        ``event`` fills.  They are added, as integers, once ``event`` has
        completed (:meth:`flush`); at once where ``event`` is None (the
        CPU, where the copy has finished).  Nothing here waits on the
        device."""
        with self._lock:
            if event is None:
                for name, v in values.items():
                    self._add(name, int(v))
            else:
                self._pending_counts.append((event, values))

    @property
    def counters(self) -> CounterDict[str, Any]:
        self.flush()
        return self._counters

    def _full(self, tid: int) -> bool:
        """Under the lock: name the recording thread (always the current
        one: spans record on exit from the thread that entered them, device
        spans when their second event is recorded) and count a drop if the
        buffer, pending device spans included, is full."""
        if tid not in self.thread_names:
            self.thread_names[tid] = threading.current_thread().name
        if len(self._events) + len(self._pending) >= self.max_events:
            self.dropped += 1
            return True
        return False

    def _record(self, event) -> None:
        with self._lock:
            if not self._full(event.tid):
                self._events.append(event)

    # --------------------------------------------------------- device spans
    def now(self) -> int:
        """The tracer's clock, ns."""
        return self._clock()

    @property
    def has_anchor(self) -> bool:
        return self._anchor is not None

    def anchor(self, event, t_before_ns: int) -> None:
        """Pin device time to the tracer's clock.  ``event`` was recorded
        on an idle stream just after the clock read ``t_before_ns``; this
        waits for it (microseconds on an idle stream) and places it at the
        midpoint of that reading and the clock's reading once it completed.
        Device spans recorded from now on are placed relative to it."""
        event.synchronize()
        t_after = self._clock()
        with self._lock:
            self._anchor = (event, (t_before_ns + t_after) // 2)

    def device_span(self, name: str, start, end, *, cat: str = "device",
                    track: str | None = "device", **attrs) -> None:
        """Record a span from ``start`` to ``end``, two device events
        recorded around enqueued work, so the device's own execution of it.
        It stays pending until both events have completed (see
        :meth:`flush`).  Needs an anchor (:meth:`anchor`)."""
        if self._anchor is None:
            raise RuntimeError("a device span needs an anchor first (Tracer.anchor)")
        tid = threading.get_ident()
        with self._lock:
            if not self._full(tid):
                self._pending.append(_PendingSpan(name, cat, track, attrs, tid, start,
                                                  end, self._anchor))

    def flush(self) -> None:
        """Turn every pending device span whose two events have completed
        into a :class:`SpanEvent` (``clock="device"``, depth 0), and add every
        pending device count whose event has completed."""
        with self._lock:
            keep = []
            for event, values in self._pending_counts:
                if not event.query():
                    keep.append((event, values))
                    continue
                for name, v in values.items():
                    self._add(name, int(v))
            self._pending_counts = keep
            keep = []
            for p in self._pending:
                if not (p.start.query() and p.end.query()):
                    keep.append(p)
                    continue
                event, t_ns = p.anchor
                t0 = t_ns + round(event.elapsed_time(p.start) * 1e6)  # ms → ns
                t1 = t0 + round(p.start.elapsed_time(p.end) * 1e6)
                # its place in the bound was taken when it was recorded
                self._events.append(SpanEvent(
                    name=p.name, cat=p.cat, t0_ns=t0, t1_ns=t1, tid=p.tid, depth=0,
                    track=p.track, attrs=p.attrs, clock="device"))
            self._pending = keep

    # ------------------------------------------------------------- inspection
    @property
    def events(self) -> list[SpanEvent | InstantEvent]:
        self.flush()
        return self._events

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
