"""The port's telemetry (``repro_torch.obs``) against the JAX package's
``repro.obs``: the tracer's contracts (nesting, counters, the bounded
buffer, threads, the null path) as ``tests/test_obs.py`` states them, and
exports and phase attribution equal to the JAX package's for the same
recorded events (both tracers driven by the same fake clock)."""
import json
import threading

import pytest

from repro import obs as jax_obs
from repro.obs import summary as jax_summary
from repro_torch.obs import (
    NULL_TRACER,
    NullTracer,
    Tracer,
    chrome_trace,
    load_trace_file,
    phase_attribution,
    phase_attribution_loaded,
    write_chrome_trace,
    write_jsonl,
)
from repro_torch.obs.summary import format_summary
from repro_torch.obs.summary import main as summary_main


def _fake_clock(start=1_000, step=10):
    """Deterministic ns clock: start, start+step, start+2*step, ..."""
    state = {"t": start - step}

    def clock():
        state["t"] += step
        return state["t"]

    return clock


def test_span_nesting_depth_and_exit_order():
    tr = Tracer(clock=_fake_clock())
    with tr.span("outer", cat="dispatch"):
        with tr.span("inner", cat="solve"):
            pass
        with tr.span("inner2", cat="solve"):
            pass
    assert [s.name for s in tr.spans] == ["inner", "inner2", "outer"]
    assert [s.depth for s in tr.spans] == [1, 1, 0]
    outer = tr.spans[-1]
    for child in tr.spans[:-1]:
        assert outer.t0_ns <= child.t0_ns and child.t1_ns <= outer.t1_ns
    with tr.span("later"):
        pass
    assert tr.spans[-1].depth == 0


def test_span_attrs_and_fake_clock_durations():
    tr = Tracer(clock=_fake_clock(start=1000, step=10))
    with tr.span("s", cat="stage", epoch=3, rounds=8):
        pass
    (s,) = tr.spans
    assert (s.t0_ns, s.t1_ns, s.dur_ns) == (1010, 1020, 10)
    assert s.attrs == {"epoch": 3, "rounds": 8}
    tr.instant("mark", cat="schedule", epoch=4)
    (i,) = tr.instants
    assert i.t_ns == 1030 and i.attrs == {"epoch": 4}
    assert tr.wall_seconds() == pytest.approx(20e-9)


def test_counters_accumulate_ints_and_floats():
    tr = Tracer()
    for v in (1, 1, 3):
        tr.count("hits", v)
    tr.count("prep_s", 0.25)
    tr.count("prep_s", 0.5)
    assert tr.counters["hits"] == 5
    assert tr.counters["prep_s"] == pytest.approx(0.75)


def test_bounded_buffer_drops_and_counts():
    tr = Tracer(max_events=3, clock=_fake_clock())
    for k in range(5):
        with tr.span(f"s{k}"):
            pass
    assert len(tr.events) == 3 and tr.dropped == 2
    tr.count("still_counts")
    assert tr.counters["still_counts"] == 1
    with pytest.raises(ValueError):
        Tracer(max_events=0)


def test_exception_inside_span_still_records_and_unwinds_depth():
    tr = Tracer(clock=_fake_clock())
    with pytest.raises(RuntimeError):
        with tr.span("doomed"):
            raise RuntimeError("boom")
    with tr.span("after"):
        pass
    assert [(s.name, s.depth) for s in tr.spans] == [("doomed", 0), ("after", 0)]


def test_worker_thread_spans_are_thread_safe_and_tracked():
    tr = Tracer()
    barrier = threading.Barrier(3)
    n_each = 200

    def work(label):
        barrier.wait()
        for _ in range(n_each):
            with tr.span(label, cat="stage", track="prefetcher"):
                with tr.span(label + ".inner", cat="h2d", track="prefetcher"):
                    pass

    threads = [threading.Thread(target=work, args=(f"w{k}",), name=f"worker-{k}")
               for k in range(2)]
    for t in threads:
        t.start()
    barrier.wait()
    for _ in range(n_each):
        with tr.span("main", cat="dispatch"):
            pass
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert len(tr.events) == 5 * n_each
    assert all(s.depth == 0 for s in tr.spans if s.name == "main")
    assert all(s.depth == 1 for s in tr.spans if s.name.endswith(".inner"))
    tids = {s.tid for s in tr.spans}
    assert len(tids) == 3 and set(tr.thread_names) == tids


def test_null_tracer_is_inert():
    nt = NullTracer()
    assert nt.enabled is False and NULL_TRACER.enabled is False
    with nt.span("x", cat="solve", epoch=1) as s:
        assert s is not None
    assert nt.instant("x") is None and nt.count("x") is None
    assert nt.span("a") is nt.span("b") is NULL_TRACER.span("c")


# ------------------------------------------- the same events in each package


def _record(tracer_cls):
    """One fixed run of instrumentation on a fake clock: nested spans of the
    same and of different categories, two tracks, an instant, counters."""
    tr = tracer_cls(clock=_fake_clock(start=1_000, step=1_000))
    with tr.span("opt_alpha.solve", cat="solve", n_active=6):
        pass
    with tr.span("pipelined.chunk", cat="dispatch", epoch=0):
        with tr.span("nested.dispatch", cat="dispatch"):
            pass
        with tr.span("nested.stage", cat="stage"):
            pass
    with tr.span("prefetch.stage", cat="stage", track="prefetcher", epoch=1):
        with tr.span("prefetch.h2d", cat="h2d", track="prefetcher", epoch=1):
            pass
    with tr.span("pipelined.device", cat="device", track="device", epoch=0):
        pass
    tr.instant("segment", cat="schedule", epoch=1)
    tr.count("opt_alpha.solves", 1)
    tr.count("prefetch.prep_s", 0.5)
    return tr


def test_chrome_trace_equals_jax_package():
    got, want = chrome_trace(_record(Tracer)), jax_obs.chrome_trace(_record(jax_obs.Tracer))
    assert got == want
    names = [e["args"]["name"] for e in got["traceEvents"] if e["name"] == "thread_name"]
    assert names == ["main", "prefetcher", "device"]
    assert got["repro"]["n_tracks"] == 3


def test_phase_attribution_equals_jax_package():
    got = phase_attribution(_record(Tracer).events)
    want = jax_obs.phase_attribution(_record(jax_obs.Tracer).events)
    assert got == want
    # same-category nesting is billed once: the chunk holds the nested
    # dispatch, while the nested stage bills beside it
    assert got["dispatch"] == pytest.approx(5e-6)
    assert got["stage"] == pytest.approx(1e-6 + 3e-6)


@pytest.mark.parametrize("fmt", ["chrome", "jsonl"])
def test_exports_load_back_as_the_jax_package_loads_them(tmp_path, fmt):
    write = write_chrome_trace if fmt == "chrome" else write_jsonl
    jax_write = jax_obs.write_chrome_trace if fmt == "chrome" else jax_obs.write_jsonl
    path = write(_record(Tracer), tmp_path / f"torch.{fmt}")
    jax_path = jax_write(_record(jax_obs.Tracer), tmp_path / f"jax.{fmt}")
    assert path.read_text() == jax_path.read_text()
    loaded = load_trace_file(path)
    assert loaded == jax_obs.load_trace_file(jax_path)
    assert phase_attribution_loaded(loaded["spans"]) == pytest.approx(
        phase_attribution(_record(Tracer).events))
    ours = format_summary(str(path), loaded).splitlines()
    theirs = jax_summary.format_summary(str(path), loaded).splitlines()
    # the same lines, but that the port's ``device`` is the device's own
    # execution, beside the host: its row follows the host's total, which
    # leaves it out
    device = next(line for line in theirs if "blocked on device" in line)
    total = next(i for i, line in enumerate(ours) if "attributed total" in line)
    assert ours[:total] == [line for line in theirs[:total + 1] if line != device]
    assert ours[total + 2:] == theirs[total + 2:]
    assert ours[total + 1] == device.replace("blocked on device", "device execution ")
    host = sum(t for c, t in phase_attribution_loaded(loaded["spans"]).items() if c != "device")
    wall = jax_summary.wall_seconds_loaded(loaded)
    assert ours[total] == f"  {'attributed total':<20} {host:>9.4f} {host / wall:>6.1%}"
    assert summary_main([str(path)]) == 0


def test_loaded_attribution_prunes_same_category_nesting(tmp_path):
    tr = Tracer(clock=_fake_clock(step=100))
    with tr.span("outer", cat="dispatch"):
        with tr.span("inner", cat="dispatch"):
            pass
        with tr.span("other", cat="stage"):
            pass
    attr = phase_attribution(tr.events)
    outer = [s for s in tr.spans if s.name == "outer"][0]
    other = [s for s in tr.spans if s.name == "other"][0]
    assert attr["dispatch"] == pytest.approx(outer.dur_ns / 1e9)
    assert attr["stage"] == pytest.approx(other.dur_ns / 1e9)
    loaded = load_trace_file(write_chrome_trace(tr, tmp_path / "prune.json"))
    assert phase_attribution_loaded(loaded["spans"]) == pytest.approx(attr)


# ------------------------------------------------ device spans (port only)


class _FakeEvent:
    """A device event at device time ``t_ns`` (its own clock, not the
    tracer's), completed once ``done`` is set."""

    def __init__(self, t_ns, done=True):
        self.t_ns, self.done, self.waited = t_ns, done, False

    def query(self):
        return self.done

    def synchronize(self):
        self.waited = self.done = True

    def elapsed_time(self, end):
        assert self.done and end.done, "elapsed_time of an event not yet completed"
        return (end.t_ns - self.t_ns) / 1e6  # ms, as torch.cuda.Event gives it


def _anchored(clock_start=1_000, step=10, device_t=50_000, **kw):
    """A tracer on a fake clock (read once at construction) anchored at
    device time ``device_t``: at step 10 the clock reads 1,000 before the
    record and 1,010 once it completed, so the anchor sits at 1,005 on the
    tracer's clock."""
    tr = Tracer(clock=_fake_clock(start=clock_start - step, step=step), **kw)
    t_before = tr.now()
    anchor = _FakeEvent(device_t, done=False)
    tr.anchor(anchor, t_before)
    return tr, anchor


def test_anchor_sits_at_the_midpoint_of_record_and_completion():
    tr, anchor = _anchored()
    assert anchor.waited and tr.has_anchor
    start, end = _FakeEvent(50_000 + 2_000), _FakeEvent(50_000 + 7_500)
    tr.device_span("pipelined.device", start, end, epoch=0, rounds=4)
    (s,) = tr.spans
    assert (s.t0_ns, s.t1_ns) == (1_005 + 2_000, 1_005 + 7_500)
    assert (s.cat, s.track, s.clock, s.depth) == ("device", "device", "device", 0)
    assert s.attrs == {"epoch": 0, "rounds": 4}


def test_a_device_span_needs_an_anchor():
    with pytest.raises(RuntimeError, match="anchor"):
        Tracer().device_span("x", _FakeEvent(0), _FakeEvent(1))


def test_device_span_stays_pending_until_both_events_complete():
    tr, _ = _anchored()
    start, end = _FakeEvent(51_000, done=False), _FakeEvent(52_000, done=False)
    tr.device_span("pipelined.device", start, end)
    with tr.span("host", cat="dispatch"):
        pass
    assert [s.name for s in tr.spans] == ["host"]
    start.done = True
    assert [s.name for s in tr.spans] == ["host"]
    end.done = True
    assert [s.name for s in tr.spans] == ["host", "pipelined.device"]
    assert [s.name for s in tr.spans] == ["host", "pipelined.device"]  # converted once
    # a later anchor does not move a span recorded under an earlier one
    tr.device_span("later", _FakeEvent(60_100), _FakeEvent(60_200))
    tr.anchor(_FakeEvent(0, done=False), tr.now())
    tr.flush()
    assert tr.spans[-1].t0_ns == 1_005 + 10_100


def test_pending_device_spans_hold_their_place_in_the_bound():
    tr, _ = _anchored(max_events=3)
    pending = [(_FakeEvent(50_000 + k, done=False), _FakeEvent(50_100 + k, done=False))
               for k in range(2)]
    for start, end in pending:
        tr.device_span("d", start, end)
    with tr.span("a"):
        pass
    with tr.span("b"):
        pass
    tr.device_span("c", _FakeEvent(50_000), _FakeEvent(50_001))
    assert tr.dropped == 2
    for start, end in pending:
        start.done = end.done = True
    assert [s.name for s in tr.events] == ["a", "d", "d"] and len(tr.events) == 3


def _device_trace():
    """One traced chunk on a fake clock: staging on the prefetcher track
    inside an inline wait, the dispatch, the copy's and the chunk's device
    spans."""
    tr, _ = _anchored(step=1_000)
    with tr.span("prefetch.wait", cat="wait"):
        with tr.span("prefetch.stage", cat="stage", track="prefetcher", epoch=0):
            pass
        with tr.span("prefetch.h2d", cat="h2d", track="prefetcher", epoch=0):
            pass
    tr.device_span("prefetch.copy", _FakeEvent(50_000 + 6_000), _FakeEvent(50_000 + 6_500),
                   bytes=4096)
    with tr.span("pipelined.chunk", cat="dispatch", epoch=0, rounds=2):
        pass
    tr.device_span("pipelined.device", _FakeEvent(50_000 + 9_000),
                   _FakeEvent(50_000 + 30_000), epoch=0, rounds=2)
    tr.count("prefetch.bytes", 4096)
    return tr


def test_chrome_trace_of_device_spans_golden():
    got = chrome_trace(_device_trace())
    spans = [(e["name"], e["cat"], e["tid"], e["ts"], e["dur"], e["args"])
             for e in got["traceEvents"] if e["ph"] == "X"]
    tracks = [e["args"]["name"] for e in got["traceEvents"] if e["name"] == "thread_name"]
    # the clock read 0 at construction, 1,000 before the anchor's record and
    # 2,000 after it, so device time 50,000 sits at 1,500 ns (1.5 µs)
    assert tracks == ["prefetcher", "main", "device"]
    assert spans == [
        ("prefetch.stage", "stage", 0, 4.0, 1.0, {"epoch": 0}),
        ("prefetch.h2d", "h2d", 0, 6.0, 1.0, {"epoch": 0}),
        ("prefetch.wait", "wait", 1, 3.0, 5.0, {}),
        ("pipelined.chunk", "dispatch", 1, 9.0, 1.0, {"epoch": 0, "rounds": 2}),
        ("prefetch.copy", "device", 2, 7.5, 0.5, {"bytes": 4096}),
        ("pipelined.device", "device", 2, 10.5, 21.0, {"epoch": 0, "rounds": 2}),
    ]
    assert got["repro"] == {"counters": {"prefetch.bytes": 4096}, "dropped": 0, "n_tracks": 3}


def test_jsonl_of_device_spans_golden(tmp_path):
    lines = write_jsonl(_device_trace(), tmp_path / "t.jsonl").read_text().splitlines()
    got = [json.loads(line) for line in lines]
    assert got[-1] == {"kind": "counters", "counters": {"prefetch.bytes": 4096}, "dropped": 0}
    assert got[-2] == {"kind": "span", "name": "pipelined.device", "cat": "device",
                       "ts_us": 10.5, "dur_us": 21.0, "track": "device", "depth": 0,
                       "attrs": {"epoch": 0, "rounds": 2}}
    assert got[-3]["name"] == "prefetch.copy" and got[-3]["track"] == "device"
    loaded = load_trace_file(tmp_path / "t.jsonl")
    assert loaded["tracks"] == ["prefetcher", "main", "device"]


def test_attribution_bills_an_inline_wait_net_of_its_staging(tmp_path):
    tr = _device_trace()
    want = {"stage": 1e-6, "h2d": 1e-6, "wait": 5e-6 - 2e-6, "dispatch": 1e-6,
            "device": 0.5e-6 + 21e-6}
    assert phase_attribution(tr.events) == pytest.approx(want)
    loaded = load_trace_file(write_chrome_trace(tr, tmp_path / "t.json"))
    assert phase_attribution_loaded(loaded["spans"]) == pytest.approx(want)
    # the device runs beside the host: below the host's total, not in it
    table = format_summary("t.json", loaded).splitlines()
    total = next(i for i, line in enumerate(table) if "attributed total" in line)
    assert "device execution" in table[total + 1] and table[total + 2] == "  counters:"
    assert [line.split()[0] for line in table[2:total]] == ["host", "host→device", "dispatch",
                                                            "host"]


def test_a_threaded_wait_is_billed_net_of_the_workers_staging():
    tr = Tracer(clock=_fake_clock(step=100))
    release = threading.Event()

    def worker():
        with tr.span("prefetch.stage", cat="stage", track="prefetcher"):
            release.wait(timeout=30)

    with tr.span("prefetch.wait", cat="wait"):
        t = threading.Thread(target=worker)
        t.start()
        release.set()
        t.join(timeout=30)
    assert not t.is_alive()
    wait = next(s for s in tr.spans if s.name == "prefetch.wait")
    stage = next(s for s in tr.spans if s.name == "prefetch.stage")
    got = phase_attribution(tr.events)
    assert got["wait"] == pytest.approx((wait.dur_ns - stage.dur_ns) / 1e9)
    assert got["stage"] == pytest.approx(stage.dur_ns / 1e9)


def test_discarded_span_is_not_recorded_and_unwinds_depth():
    tr = Tracer(clock=_fake_clock())
    with tr.span("prefetch.wait", cat="wait") as wait:
        with tr.span("prefetch.stage", cat="stage"):
            pass
        wait.discard()
    with tr.span("after"):
        pass
    assert [(s.name, s.depth) for s in tr.spans] == [("prefetch.stage", 1), ("after", 0)]
    with NULL_TRACER.span("x") as s:
        s.discard()
