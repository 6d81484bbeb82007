"""Per-phase time attribution from a recorded trace file.

    PYTHONPATH=src python -m repro_torch.obs.summary TRACE_run.json

Reads either export format (Chrome trace-event JSON or the JSONL stream)
and prints (1) a per-phase attribution table — how the traced run's wall
time splits across ``solve`` (OPT-α re-solves), ``stage`` (batch draws +
host stacking), ``h2d`` (pinning and enqueueing the host→device transfer),
``dispatch`` (compiled-call enqueue) and ``wait`` (the host blocked on the
staging queue or a sync, net of the staging it waited for), with
``device`` (the device's own execution, which runs beside the host) below
the total — and (2) the recorded counter totals.  The attributed total is
printed against the trace's wall span: a large gap means untraced host
work (Python glue, GC), not a broken trace.  A trace file comes from :func:`repro_torch.obs.write_chrome_trace`
or :func:`repro_torch.obs.write_jsonl` on a :class:`repro_torch.obs.Tracer`
handed to an engine.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.obs.export import load_trace_file, phase_attribution_loaded

# canonical phase order for the table; unknown categories append after
PHASE_ORDER = ("solve", "stage", "h2d", "dispatch", "wait", "device")
# phases beside the host's timeline, shown below its attributed total
BESIDE_HOST = ("device",)

PHASE_LABEL = {
    "solve": "OPT-α solve",
    "stage": "host staging",
    "h2d": "host→device",
    "dispatch": "dispatch",
    "wait": "host waiting",
    "device": "device execution",
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
    """The attribution table as text: the host's phases and their total,
    then the phases beside the host (``BESIDE_HOST``)."""
    order = [c for c in PHASE_ORDER if c in phases]
    order += sorted(c for c in phases if c not in PHASE_ORDER)

    def row(label, t):
        share = t / wall_s if wall_s > 0 else 0.0
        return f"  {label:<20} {t:>9.4f} {share:>6.1%}"

    host = [c for c in order if c not in BESIDE_HOST]
    lines = [f"  {'phase':<20} {'time_s':>9} {'share':>7}"]
    lines += [row(PHASE_LABEL.get(cat, cat), phases[cat]) for cat in host]
    lines.append(row("attributed total", sum(phases[cat] for cat in host)))
    lines += [row(PHASE_LABEL[cat], phases[cat]) for cat in BESIDE_HOST if cat in phases]
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
