"""Per-phase time attribution from a recorded trace file.

    PYTHONPATH=src python -m repro_torch.obs.summary TRACE_run.json

Reads either export format (Chrome trace-event JSON or the JSONL stream)
and prints (1) a per-phase attribution table — how the traced run's wall
time splits across ``solve`` (OPT-α re-solves), ``stage`` (batch draws +
host stacking), ``h2d`` (host→device transfer), ``dispatch`` (compiled-call
enqueue) and ``device`` (blocked-on-device fences) — and (2) the recorded
counter totals.  The attributed total is printed against the trace's wall
span: a large gap means untraced host work (Python glue, GC), not a broken
trace.  A trace file comes from :func:`repro_torch.obs.write_chrome_trace`
or :func:`repro_torch.obs.write_jsonl` on a :class:`repro_torch.obs.Tracer`
handed to an engine.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.obs.export import load_trace_file, phase_attribution_loaded

# canonical phase order for the table; unknown categories append after
PHASE_ORDER = ("solve", "stage", "h2d", "dispatch", "device")

PHASE_LABEL = {
    "solve": "OPT-α solve",
    "stage": "host staging",
    "h2d": "host→device",
    "dispatch": "dispatch",
    "device": "blocked on device",
}


def wall_seconds_loaded(loaded: dict) -> float:
    """Timeline span of a loaded trace (max span end − min event start)."""
    t0 = t1 = None
    for s in loaded["spans"]:
        a, b = s["ts_us"], s["ts_us"] + s["dur_us"]
        t0 = a if t0 is None else min(t0, a)
        t1 = b if t1 is None else max(t1, b)
    for i in loaded["instants"]:
        a = i["ts_us"]
        t0 = a if t0 is None else min(t0, a)
        t1 = a if t1 is None else max(t1, a)
    if t0 is None:
        return 0.0
    return (t1 - t0) / 1e6


def format_attribution(phases: dict[str, float], wall_s: float) -> str:
    """The attribution table as text."""
    order = [c for c in PHASE_ORDER if c in phases]
    order += sorted(c for c in phases if c not in PHASE_ORDER)
    lines = [f"  {'phase':<20} {'time_s':>9} {'share':>7}"]
    total = 0.0
    for cat in order:
        t = phases[cat]
        total += t
        share = t / wall_s if wall_s > 0 else 0.0
        lines.append(f"  {PHASE_LABEL.get(cat, cat):<20} {t:>9.4f} {share:>6.1%}")
    share = total / wall_s if wall_s > 0 else 0.0
    lines.append(f"  {'attributed total':<20} {total:>9.4f} {share:>6.1%}")
    return "\n".join(lines)


def format_summary(path: str, loaded: dict) -> str:
    phases = phase_attribution_loaded(loaded["spans"])
    wall = wall_seconds_loaded(loaded)
    tracks = loaded["tracks"]
    lines = [
        f"trace {path}: wall {wall:.4f}s, "
        f"{len(loaded['spans'])} spans + {len(loaded['instants'])} instants "
        f"on {len(tracks)} tracks ({', '.join(tracks)})"
    ]
    if loaded["dropped"]:
        lines.append(f"  WARNING: {loaded['dropped']} events dropped (buffer bound)")
    lines.append(format_attribution(phases, wall))
    if loaded["counters"]:
        lines.append("  counters:")
        for name in sorted(loaded["counters"]):
            value = loaded["counters"][name]
            shown = f"{value:.4f}" if isinstance(value, float) else str(value)
            lines.append(f"    {name:<28} {shown}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("trace", nargs="+", help="TRACE_*.json / *.jsonl files")
    args = ap.parse_args(argv)
    for path in args.trace:
        print(format_summary(path, load_trace_file(path)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
