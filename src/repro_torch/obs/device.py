"""Device spans from CUDA events: the torch half of ``Tracer.device_span``.

:func:`device_span` brackets enqueued work in two timing events on a
stream, so the span the tracer records is the device's own execution of
that work, on the tracer's clock; :func:`take_anchor` gives the tracer the
anchor it places such spans by.  The engines and the prefetcher call both
only through a tracer, and with tracing off they create no event.

On the CPU every op has finished when it returns, so a device span there is
a host span over the same work (category ``device``, track ``device``) and
no anchor is taken.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["device_span", "host_copies", "take_anchor"]

_OFF = contextlib.nullcontext()


def take_anchor(tracer, device: torch.device) -> None:
    """Pin ``device``'s clock to ``tracer``'s at the start of an engine
    call: a new anchor when the device's current stream is idle (an event
    recorded and waited for, microseconds); else the tracer's last anchor,
    so clock drift is bounded by one call.  A tracer with no anchor yet on
    a busy stream first waits for the stream's queued work, once.  Nothing
    on the CPU or with tracing off."""
    if not tracer.enabled or device.type != "cuda":
        return
    stream = torch.cuda.current_stream(device)
    if not stream.query():
        if tracer.has_anchor:
            return
        stream.synchronize()
    event = torch.cuda.Event(enable_timing=True)
    t_before = tracer.now()
    event.record(stream)
    tracer.anchor(event, t_before)


class _EventSpan:
    """Records a timing event on ``stream`` on entry and another on a
    normal exit, and hands both to the tracer as one device span."""

    __slots__ = ("_tracer", "_name", "_stream", "_attrs", "_start")

    def __init__(self, tracer, name, stream, attrs):
        self._tracer = tracer
        self._name = name
        self._stream = stream
        self._attrs = attrs

    def __enter__(self):
        self._start = torch.cuda.Event(enable_timing=True)
        self._start.record(self._stream)
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(self._stream)
            self._tracer.device_span(self._name, self._start, end, **self._attrs)
        return False


def device_span(tracer, name: str, device: torch.device, *, stream=None, **attrs):
    """A context manager whose span, on ``tracer``'s ``device`` track, is the
    device's execution of the work enqueued on ``stream`` (the device's
    current stream by default) inside it: the time from the device reaching
    the first event to it reaching the second, so a span that starts behind
    queued work starts when that work is done.  Work another thread
    enqueues on the same stream meanwhile falls inside the span too.  On the
    CPU, the host's time over the block; with tracing off, nothing."""
    if not tracer.enabled:
        return _OFF
    if device.type != "cuda":
        return tracer.span(name, cat="device", track="device", **attrs)
    if stream is None:
        stream = torch.cuda.current_stream(device)
    return _EventSpan(tracer, name, stream, attrs)


def host_copies(values: dict, device: torch.device) -> dict:
    """``values`` (name → a 0-d device tensor) copied to pinned host
    tensors, the copies enqueued on the current stream without waiting: an
    event recorded after this call completes once they are filled (what
    ``Tracer.device_count`` waits for).  On the CPU, ``values`` as they
    are."""
    if device.type != "cuda":
        return values
    out = {}
    for name, v in values.items():
        host = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
        host.copy_(v, non_blocking=True)
        out[name] = host
    return out
