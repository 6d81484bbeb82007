"""The port's telemetry (``repro_torch.obs``) against the JAX package's
``repro.obs``: the tracer's contracts (nesting, counters, the bounded
buffer, threads, the null path) as ``tests/test_obs.py`` states them, and
exports and phase attribution equal to the JAX package's for the same
recorded events (both tracers driven by the same fake clock)."""
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
    assert format_summary(str(path), loaded) == jax_summary.format_summary(str(path), loaded)
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
