"""Trace exporters: Chrome trace-event JSON, JSONL stream, phase attribution.

Two on-disk formats, one in-memory aggregation:

* :func:`chrome_trace` / :func:`write_chrome_trace` — the Chrome
  trace-event format (object form), loadable in Perfetto
  (https://ui.perfetto.dev) or ``chrome://tracing``.  Every *track* — the
  recording thread by default, or a span's logical override such as
  ``"prefetcher"`` / ``"device"`` — becomes its own named timeline row via
  ``thread_name`` metadata events, so host/device overlap is visible as
  parallel rows, not just a fraction.  Timestamps are microseconds relative
  to the tracer's start.  Counter totals and the dropped-event count ride
  in a top-level ``"repro"`` key (ignored by trace viewers, read back by
  :mod:`repro_torch.obs.summary`).  The key and the process name are the
  JAX package's, so the two packages' trace files share one format.
* :func:`write_jsonl` — one JSON object per line (``kind``: ``span`` /
  ``instant`` / final ``counters``), the grep/pandas-friendly stream for
  ad-hoc analysis without a trace viewer.
* :func:`phase_attribution` — total seconds per span *category* (the
  solve / stage / h2d / dispatch / device axis).  Only top-level spans of
  each category count (a span nested under a same-category ancestor would
  double-bill its interval); instrumentation keeps categories disjoint, so
  in a serialized traced run the phase totals sum to ≈ wall time.
"""
from __future__ import annotations

import json
import pathlib

from repro_torch.obs.trace import SpanEvent, Tracer

__all__ = [
    "chrome_trace",
    "load_trace_file",
    "phase_attribution",
    "phase_attribution_loaded",
    "write_chrome_trace",
    "write_jsonl",
]

_PID = 1
# canonical track order: the main thread first, then logical tracks in
# first-seen order — keeps Perfetto rows stable across runs
_MAIN_TRACK = "main"


def _track_label(event, thread_names: dict[int, str]) -> str:
    if event.track is not None:
        return event.track
    name = thread_names.get(event.tid, f"thread-{event.tid}")
    return _MAIN_TRACK if name == "MainThread" else name


def chrome_trace(tracer: Tracer) -> dict:
    """The tracer's buffer as a Chrome trace-event dict (object form)."""
    tids: dict[str, int] = {}
    trace_events: list[dict] = []

    def tid_for(label: str) -> int:
        if label not in tids:
            tids[label] = len(tids)
            trace_events.append(
                {
                    "ph": "M",
                    "name": "thread_name",
                    "pid": _PID,
                    "tid": tids[label],
                    "args": {"name": label},
                }
            )
        return tids[label]

    trace_events.append(
        {
            "ph": "M",
            "name": "process_name",
            "pid": _PID,
            "tid": 0,
            "args": {"name": "repro"},
        }
    )
    t0 = tracer.t_start_ns
    for e in tracer.events:
        tid = tid_for(_track_label(e, tracer.thread_names))
        if isinstance(e, SpanEvent):
            trace_events.append(
                {
                    "ph": "X",
                    "name": e.name,
                    "cat": e.cat,
                    "pid": _PID,
                    "tid": tid,
                    "ts": (e.t0_ns - t0) / 1e3,
                    "dur": e.dur_ns / 1e3,
                    "args": dict(e.attrs),
                }
            )
        else:
            trace_events.append(
                {
                    "ph": "i",
                    "s": "t",  # thread-scoped instant marker
                    "name": e.name,
                    "cat": e.cat,
                    "pid": _PID,
                    "tid": tid,
                    "ts": (e.t_ns - t0) / 1e3,
                    "args": dict(e.attrs),
                }
            )
    return {
        "traceEvents": trace_events,
        "displayTimeUnit": "ms",
        # non-standard, viewer-ignored; summary + telemetry read it back
        "repro": {
            "counters": dict(tracer.counters),
            "dropped": tracer.dropped,
            "n_tracks": len(tids),
        },
    }


def write_chrome_trace(tracer: Tracer, path) -> pathlib.Path:
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(chrome_trace(tracer)) + "\n")
    return path


def write_jsonl(tracer: Tracer, path) -> pathlib.Path:
    """One event per line, counters as the final line."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    t0 = tracer.t_start_ns
    lines = []
    for e in tracer.events:
        track = _track_label(e, tracer.thread_names)
        if isinstance(e, SpanEvent):
            lines.append(
                {
                    "kind": "span",
                    "name": e.name,
                    "cat": e.cat,
                    "ts_us": (e.t0_ns - t0) / 1e3,
                    "dur_us": e.dur_ns / 1e3,
                    "track": track,
                    "depth": e.depth,
                    "attrs": dict(e.attrs),
                }
            )
        else:
            lines.append(
                {
                    "kind": "instant",
                    "name": e.name,
                    "cat": e.cat,
                    "ts_us": (e.t_ns - t0) / 1e3,
                    "track": track,
                    "attrs": dict(e.attrs),
                }
            )
    lines.append(
        {"kind": "counters", "counters": dict(tracer.counters), "dropped": tracer.dropped}
    )
    path.write_text("".join(json.dumps(line) + "\n" for line in lines))
    return path


def phase_attribution(events) -> dict[str, float]:
    """Total seconds per span category, from live :class:`SpanEvent`s.

    Nested spans of the *same* category are skipped (their time is already
    inside the ancestor's interval); cross-category nesting bills both — so
    instrumentation keeps the conventional categories disjoint and the
    totals stay a partition of busy time.
    """
    # spans record at exit, so an ancestor appears *after* its children in
    # the buffer; collect per-thread intervals first, then prune.
    per_cat: dict[str, float] = {}
    spans = [e for e in events if isinstance(e, SpanEvent)]
    by_thread: dict[int, list[SpanEvent]] = {}
    for s in spans:
        by_thread.setdefault(s.tid, []).append(s)
    for thread_spans in by_thread.values():
        # end-time order ⇒ a child precedes its ancestor; an ancestor of s
        # is any later span with smaller depth whose interval contains s
        for i, s in enumerate(thread_spans):
            nested_same_cat = any(
                o.depth < s.depth
                and o.cat == s.cat
                and o.t0_ns <= s.t0_ns
                and s.t1_ns <= o.t1_ns
                for o in thread_spans[i + 1 :]
            )
            if not nested_same_cat:
                per_cat[s.cat] = per_cat.get(s.cat, 0.0) + s.dur_ns / 1e9
    return per_cat


def phase_attribution_loaded(spans: list[dict]) -> dict[str, float]:
    """:func:`phase_attribution` over spans loaded back from a trace file
    (:func:`load_trace_file` records): same same-category pruning, with
    nesting inferred from strict interval containment on one track."""
    per_cat: dict[str, float] = {}
    by_track: dict[str, list[dict]] = {}
    for s in spans:
        by_track.setdefault(s["track"], []).append(s)
    for track_spans in by_track.values():
        for s in track_spans:
            end = s["ts_us"] + s["dur_us"]
            nested_same_cat = any(
                o is not s
                and o["cat"] == s["cat"]
                and o["dur_us"] > s["dur_us"]
                and o["ts_us"] <= s["ts_us"]
                and end <= o["ts_us"] + o["dur_us"]
                for o in track_spans
            )
            if not nested_same_cat:
                per_cat[s["cat"]] = per_cat.get(s["cat"], 0.0) + s["dur_us"] / 1e6
    return per_cat


def load_trace_file(path) -> dict:
    """Load either export format back into one normalized dict::

        {"spans": [{name, cat, ts_us, dur_us, track, attrs}, ...],
         "instants": [{name, cat, ts_us, track, attrs}, ...],
         "counters": {...}, "dropped": int, "tracks": [label, ...]}

    Chrome files are detected by their ``traceEvents`` key; anything else is
    parsed as JSONL.
    """
    text = pathlib.Path(path).read_text()
    try:
        doc = json.loads(text)
    except json.JSONDecodeError:
        doc = None
    spans, instants, tracks = [], [], []
    counters: dict = {}
    dropped = 0
    if isinstance(doc, dict) and "traceEvents" in doc:
        tid_names: dict[int, str] = {}
        for e in doc["traceEvents"]:
            if e.get("ph") == "M" and e.get("name") == "thread_name":
                tid_names[e["tid"]] = e["args"]["name"]
        for e in doc["traceEvents"]:
            track = tid_names.get(e.get("tid"), str(e.get("tid")))
            if e.get("ph") == "X":
                spans.append(
                    {
                        "name": e["name"],
                        "cat": e.get("cat", "default"),
                        "ts_us": e["ts"],
                        "dur_us": e["dur"],
                        "track": track,
                        "attrs": e.get("args", {}),
                    }
                )
            elif e.get("ph") == "i":
                instants.append(
                    {
                        "name": e["name"],
                        "cat": e.get("cat", "default"),
                        "ts_us": e["ts"],
                        "track": track,
                        "attrs": e.get("args", {}),
                    }
                )
        meta = doc.get("repro", {})
        counters = meta.get("counters", {})
        dropped = meta.get("dropped", 0)
        tracks = [tid_names[k] for k in sorted(tid_names)]
    else:
        for line in text.splitlines():
            if not line.strip():
                continue
            rec = json.loads(line)
            kind = rec.get("kind")
            if kind == "span":
                spans.append(rec)
            elif kind == "instant":
                instants.append(rec)
            elif kind == "counters":
                counters = rec.get("counters", {})
                dropped = rec.get("dropped", 0)
        seen: list[str] = []
        for rec in spans + instants:
            if rec["track"] not in seen:
                seen.append(rec["track"])
        tracks = seen
    return {
        "spans": spans,
        "instants": instants,
        "counters": counters,
        "dropped": dropped,
        "tracks": tracks,
    }
