"""The span window's device timeline, read from the port's spans.

The port's engines record device spans from CUDA events on the tracer's
clock (``SpanEvent.clock == "device"``, track ``device``): the device's own
execution of each chunk and each staged copy.  Their union is the time the
device was busy; the rest of the stretch from the window's first host span
to its last device span is the time it sat idle.  Host spans that overlap
the idle time say what held the device up: ``prefetch.wait`` (the engine
waiting on staging) or ``pipelined.chunk`` (the engine launching a chunk).

A program whose spans are all host-timed (the port before device spans, or
any run on the CPU) has no device timeline: :func:`timeline` returns None,
and so does every reader built on it.  Times are ns, as the spans keep
them.
"""
from __future__ import annotations

import dataclasses


def union(intervals) -> list[tuple[int, int]]:
    """The union of ``(lo, hi)`` intervals as sorted, disjoint intervals."""
    out: list[list[int]] = []
    for lo, hi in sorted(intervals):
        if hi <= lo:
            continue
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [(lo, hi) for lo, hi in out]


def intersect(a, b) -> list[tuple[int, int]]:
    """Intersection of two unions (sorted, disjoint)."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            out.append((lo, hi))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def subtract(a, b) -> list[tuple[int, int]]:
    """``a`` less ``b``, both unions (sorted, disjoint)."""
    out = []
    for lo, hi in a:
        for blo, bhi in b:
            if bhi <= lo or blo >= hi:
                continue
            if blo > lo:
                out.append((lo, blo))
            lo = max(lo, bhi)
            if lo >= hi:
                break
        if hi > lo:
            out.append((lo, hi))
    return out


def measure(intervals) -> int:
    return sum(hi - lo for lo, hi in intervals)


@dataclasses.dataclass
class Timeline:
    """The span window's device timeline: ``busy`` and ``idle`` partition
    ``[lo, hi]``, from the first host span's start to the last device
    span's end."""

    spans: list
    lo: int
    hi: int
    busy: list
    idle: list

    def named(self, name: str) -> list[tuple[int, int]]:
        """The union of the spans called ``name``."""
        return union((s.t0_ns, s.t1_ns) for s in self.spans if s.name == name)


def timeline(ctx) -> Timeline | None:
    """The device timeline of ``ctx``'s span window, or None without a card
    (``ctx.busy_s`` is None), without rounds, or without device-timed
    spans."""
    if ctx.busy_s is None or ctx.span_window.rounds == 0:
        return None
    device = [s for s in ctx.spans
              if getattr(s, "clock", "host") == "device" and s.track == "device"]
    host = [s for s in ctx.spans if getattr(s, "clock", "host") == "host"]
    if not device or not host:
        return None
    lo, hi = min(s.t0_ns for s in host), max(s.t1_ns for s in device)
    busy = intersect(union((s.t0_ns, s.t1_ns) for s in device), [(lo, hi)])
    return Timeline(spans=ctx.spans, lo=lo, hi=hi, busy=busy, idle=subtract([(lo, hi)], busy))


def ms_per_round(ctx, ns: int) -> float:
    return ns / 1e6 / ctx.span_window.rounds
