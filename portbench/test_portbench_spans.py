"""The readers of the port's device spans (``portbench/spans.py`` and the
four ``metrics/*_ms_per_round.py`` that read it), on hand-built span
windows."""
import dataclasses
import importlib

import pytest

from portbench import harness, spans
from repro_torch.obs.trace import SpanEvent

READERS = ["device_ms_per_round", "staging_stall_ms_per_round",
           "dispatch_stall_ms_per_round", "h2d_device_ms_per_round"]
MS = 1_000_000  # ns


def _span(name, t0_ms, t1_ms, *, cat, track=None, clock="host", **attrs):
    return SpanEvent(name=name, cat=cat, t0_ns=int(t0_ms * MS), t1_ns=int(t1_ms * MS), tid=1,
                     depth=0, track=track, attrs=attrs, clock=clock)


def _device(name, t0_ms, t1_ms, **attrs):
    return _span(name, t0_ms, t1_ms, cat="device", track="device", clock="device", **attrs)


def _two_chunks():
    """Two chunks of 4 rounds, 1,400 ms each on the device, 300 ms apart:
    the engine waits 280 ms on staging (the second chunk's 3 ms copy runs
    at its end) and takes 20 ms to launch the second chunk."""
    return [
        _span("pipelined.chunk", 0, 10, cat="dispatch", rounds=4),
        _device("pipelined.device", 0, 1400, rounds=4),
        _span("prefetch.stage", 1400, 1600, cat="stage", track="prefetcher"),
        _span("prefetch.h2d", 1600, 1676, cat="h2d", track="prefetcher"),
        _device("prefetch.copy", 1677, 1680, bytes=63 * MS),
        _span("prefetch.wait", 1400, 1680, cat="wait"),
        _span("pipelined.chunk", 1680, 1700, cat="dispatch", rounds=4),
        _device("pipelined.device", 1700, 3100, rounds=4),
    ]


def _ctx(span_list, *, rounds=8, busy_s=2.8):
    return harness.TraceContext(cfg={}, traffic={}, flops_per_round=0.0,
                                span_window=harness.Window(rounds=rounds), spans=span_list,
                                counters={}, busy_s=busy_s)


def _read(name, ctx):
    return importlib.import_module(f"portbench.metrics.{name}").read(ctx)


@pytest.mark.parametrize("name, want_ms", [
    ("device_ms_per_round", 2800 / 8),
    ("staging_stall_ms_per_round", 277 / 8),
    ("dispatch_stall_ms_per_round", 20 / 8),
    ("h2d_device_ms_per_round", 3 / 8),
])
def test_readers_on_two_chunks(name, want_ms):
    assert _read(name, _ctx(_two_chunks())) == pytest.approx(want_ms, abs=1e-12)


def test_the_stalls_partition_the_idle_time():
    ctx = _ctx(_two_chunks())
    t = spans.timeline(ctx)
    assert (t.lo, t.hi) == (0, 3100 * MS)
    assert t.idle == [(1400 * MS, 1677 * MS), (1680 * MS, 1700 * MS)]
    idle_ms = spans.measure(t.idle) / MS / 8
    stalls = sum(_read(n, ctx) for n in ("staging_stall_ms_per_round",
                                         "dispatch_stall_ms_per_round"))
    assert stalls == pytest.approx(idle_ms, abs=1e-12)


def test_a_copy_inside_a_chunks_span_is_no_rounds_time():
    # the staging thread enqueued the next chunk's copy between this chunk's
    # two events: the copy ran inside the chunk's span, the rounds did not
    span_list = _two_chunks() + [_device("prefetch.copy", 3000, 3005, bytes=63 * MS)]
    ctx = _ctx(span_list)
    assert _read("device_ms_per_round", ctx) == pytest.approx((2800 - 5) / 8)
    assert _read("h2d_device_ms_per_round", ctx) == pytest.approx(8 / 8)
    assert spans.timeline(ctx).idle == spans.timeline(_ctx(_two_chunks())).idle


def test_dispatch_under_a_wait_is_billed_to_staging():
    # a launch span that overlaps the wait: the idle time under both is staging's
    span_list = _two_chunks() + [_span("pipelined.chunk", 1500, 1510, cat="dispatch")]
    ctx = _ctx(span_list)
    assert _read("staging_stall_ms_per_round", ctx) == pytest.approx(277 / 8)
    assert _read("dispatch_stall_ms_per_round", ctx) == pytest.approx(20 / 8)


@pytest.mark.parametrize("name", READERS)
def test_nothing_is_read_without_a_card(name):
    assert _read(name, _ctx(_two_chunks(), busy_s=None)) is None


@pytest.mark.parametrize("name", READERS)
def test_nothing_is_read_from_host_timed_spans(name):
    # a program whose device spans are host fences (clock "host") has no
    # device timeline
    fenced = [dataclasses.replace(s, clock="host") for s in _two_chunks()]
    assert _read(name, _ctx(fenced)) is None
    assert _read(name, _ctx(_two_chunks(), rounds=0)) is None


@pytest.mark.parametrize("a, b, both, a_less_b", [
    ([(0, 10)], [(5, 15)], [(5, 10)], [(0, 5)]),
    ([(0, 10), (20, 30)], [(5, 25)], [(5, 10), (20, 25)], [(0, 5), (25, 30)]),
    ([(0, 30)], [(5, 10), (15, 20)], [(5, 10), (15, 20)], [(0, 5), (10, 15), (20, 30)]),
    ([(0, 10)], [(10, 20)], [], [(0, 10)]),
    ([(0, 10)], [], [], [(0, 10)]),
])
def test_interval_algebra(a, b, both, a_less_b):
    assert spans.intersect(a, b) == both
    assert spans.subtract(a, b) == a_less_b
    assert spans.union(a + b) == spans.union(both + a_less_b + spans.subtract(b, a))
    assert spans.union([(3, 5), (0, 4), (7, 7), (6, 8)]) == [(0, 5), (6, 8)]
