"""Check a benchmark cell's span window against the card's own timeline.

    python3 tools/span_window_check.py --workload resnet20.fig3_static \
        --seed N --seconds 30 [--spans build/spans_N.jsonl] \
        [--prefetch inline] [--switch-interval S]

Runs the cell as ``portbench/run.py --trace 1`` does (set-up, then a third
of the seconds each under the port's tracer, untraced, and under
``torch.profiler``), with each engine call also wrapped in a host span
(``bench.call``), and prints one JSON line:

* ``metrics``: the cell's per-layer metrics, as the benchmark reads them;
* ``clock``: the most a device span started before the host span that
  enqueued its work (``pipelined.device`` against its ``pipelined.chunk``,
  ``prefetch.copy`` against its ``prefetch.h2d``), ms; causality makes it
  at most the anchor's error;
* ``idle``: the span window's device-idle ms a round, its parts (waiting on
  staging, launching, outside any engine call) and what is left, and the
  window's idle share beside the profiled window's ``device_idle_share``;
* ``rates``: rounds/s of the span window and of the untraced window, and
  what tracing costs (1 − span / untraced); the span window comes first
  after set-up, so it also bears the process's warm-up.  After the three
  windows, ``PAIRS`` pairs of one untraced and one traced block, in turns
  (untraced first in even pairs), give the cost free of that order
  (``paired``);
* ``replay_ms_per_round``: host ms a round inside ``CUDAGraph.replay`` in
  the span window, ``replay_cpu_ms_per_round`` the main thread's CPU time
  in it (a launch that waits for room on the card spins; a thread that
  waits to take the GIL back after the launch sleeps), and
  ``backpressure_ms_per_round``: in the engine's ``pipelined.wait`` spans,
  where a traced engine waits out a replay that would block.

``--prefetch inline`` stages on the main thread instead of the engine's
staging thread, and ``--switch-interval`` sets ``sys.setswitchinterval``
(how long a thread may keep the GIL while another waits for it): two ways
to see what the staging thread's Python work costs the dispatch spans.

``--spans`` writes the span window's spans, one JSON object a line.  Needs
an NVIDIA GPU; imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PAIRS = 3  # paired untraced/traced blocks after the three windows
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402


def _latest_before(devices, hosts) -> float:
    """The most any device span started before its host span, ms (pairs in
    order of start; negative: every device span started after its host's)."""
    pairs = zip(sorted(hosts, key=lambda s: s.t0_ns), sorted(devices, key=lambda s: s.t0_ns))
    return max((h.t0_ns - d.t0_ns) / 1e6 for h, d in pairs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="resnet20.fig3_static")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--spans", type=Path)
    ap.add_argument("--prefetch", choices=("thread", "inline"))
    ap.add_argument("--switch-interval", type=float)
    args = ap.parse_args(argv)

    from portbench import harness, spans

    if not torch.cuda.is_available():
        print("span_window_check: needs an NVIDIA GPU", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    bench, spec, cfg, traffic = harness.load_cell(ROOT, args.workload)
    harness.repeatable_f32()
    cell = harness.build(cfg, traffic, args.seed, device)
    harness.check_rounds(cell)

    run_schedule = cell.engine.run_schedule

    def traced_call(*a, **kw):
        with cell.engine.tracer.span("bench.call", cat="call"):
            return run_schedule(*a, **kw)

    cell.engine.run_schedule = traced_call
    if args.prefetch is not None:
        cell.engine.prefetch = args.prefetch
    if args.switch_interval is not None:
        sys.setswitchinterval(args.switch_interval)
    replay, in_replay, replay_cpu = torch.cuda.CUDAGraph.replay, [0], [0]

    def timed_replay(graph):
        t0, c0 = time.perf_counter_ns(), time.thread_time_ns()
        replay(graph)
        in_replay[0] += time.perf_counter_ns() - t0
        replay_cpu[0] += time.thread_time_ns() - c0

    third = args.seconds / 3
    torch.cuda.CUDAGraph.replay = timed_replay
    try:
        sw, span_list, counters = harness.span_window(cell, third)
    finally:
        torch.cuda.CUDAGraph.replay = replay
    uw = harness.window(cell, third)
    pw, busy_s, device_ops, _ = harness.profile_window(cell, third)
    ctx = harness.TraceContext(cfg=cfg, traffic=traffic,
                               flops_per_round=harness.flops_per_round(cfg), span_window=sw,
                               spans=span_list, counters=counters, untraced_window=uw,
                               profile_window=pw, busy_s=busy_s, device_ops=device_ops)
    metrics = harness.per_layer(bench, spec["name"], ctx)
    paired = {"untraced": [0, 0.0], "traced": [0, 0.0]}
    for k in range(2 * PAIRS):
        traced = (k % 2 == 1) == (k // 2 % 2 == 0)
        w = harness.span_window(cell, 0)[0] if traced else harness.window(cell, 0)
        paired["traced" if traced else "untraced"][0] += w.rounds
        paired["traced" if traced else "untraced"][1] += w.seconds
    t = spans.timeline(ctx)
    if t is None:
        print("span_window_check: no device-timed spans in the span window", file=sys.stderr)
        return 1
    per_round = 1e6 * sw.rounds

    def named(name):
        return [s for s in span_list if s.name == name]

    idle = spans.measure(t.idle) / per_round
    # the benchmark's own readers; one that finds no span of its kind reads 0
    staging = metrics.get("staging_stall_ms_per_round", {}).get("value", 0.0)
    dispatch = metrics.get("dispatch_stall_ms_per_round", {}).get("value", 0.0)
    outside = spans.measure(spans.subtract(t.idle, t.named("bench.call"))) / per_round
    span_rate, untraced_rate = sw.rounds / sw.seconds, uw.rounds / uw.seconds
    paired_rates = {k: r / sec for k, (r, sec) in paired.items()}
    out = {
        "seed": args.seed,
        "metrics": {k: v["value"] for k, v in metrics.items()},
        "clock": {
            "device_before_chunk_ms": _latest_before(named("pipelined.device"),
                                                     named("pipelined.chunk")),
            "copy_before_h2d_ms": _latest_before(named("prefetch.copy"), named("prefetch.h2d")),
            "device_spans": len(named("pipelined.device")),
            "copy_spans": len(named("prefetch.copy")),
        },
        "idle": {
            "idle_ms_per_round": idle,
            "staging_ms_per_round": staging,
            "dispatch_ms_per_round": dispatch,
            "outside_calls_ms_per_round": outside,
            "rest_ms_per_round": idle - staging - dispatch - outside,
            "span_window_idle_share": 100.0 * idle * per_round / (t.hi - t.lo),
            "device_idle_share": metrics.get("device_idle_share", {}).get("value"),
        },
        "rates": {"span_window": span_rate, "untraced": untraced_rate,
                  "tracing_cost": 1.0 - span_rate / untraced_rate,
                  "rounds": [sw.rounds, uw.rounds, pw.rounds],
                  "paired": paired_rates,
                  "paired_cost": 1.0 - paired_rates["traced"] / paired_rates["untraced"]},
        "replay_ms_per_round": in_replay[0] / per_round,
        "replay_cpu_ms_per_round": replay_cpu[0] / per_round,
        "prefetch": cell.engine.prefetch,
        "switch_interval_s": sys.getswitchinterval(),
        "backpressure_ms_per_round": sum(s.dur_ns for s in named("pipelined.wait")) / per_round,
        "bytes_per_round": counters.get("prefetch.bytes", 0) / sw.rounds,
        "device": torch.cuda.get_device_name(device),
    }
    if args.spans is not None:
        args.spans.parent.mkdir(parents=True, exist_ok=True)
        args.spans.write_text("".join(json.dumps(
            {"name": s.name, "cat": s.cat, "t0_ns": s.t0_ns, "t1_ns": s.t1_ns,
             "track": s.track, "tid": s.tid, "clock": s.clock, "attrs": s.attrs}) + "\n"
            for s in span_list))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
