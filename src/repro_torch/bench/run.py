"""Benchmark CLI: run a registered scenario, emit ``BENCH_<name>.json``,
optionally gate against a baseline report.

    PYTHONPATH=src python -m repro_torch.bench.run --list
    PYTHONPATH=src python -m repro_torch.bench.run --scenario bench_smoke
    PYTHONPATH=src python -m repro_torch.bench.run --scenario bench_smoke \\
        --device cpu --engines loop,scan

Runs on the GPU unless ``--device cpu`` is given.  Reports go to
``--out-dir`` (default ``build/bench_torch``, under the current directory;
the ``BENCH_*.json`` files at the repository root are the JAX package's
recorded CPU runs and are never overwritten).  On the GPU the CLI turns TF32
off (matmuls and cuDNN) and makes cuDNN deterministic: the kernel check
compares f32 results at 1e-5, and the bitwise gate needs the same
convolution algorithms in every engine.

``--trace`` adds a third, instrumented pass per engine and writes
``TRACE_<scenario>_<engine>.json`` (Perfetto-loadable) + ``.jsonl`` next to
the report; the report gains a ``telemetry`` block.

A shard scenario (``mesh8_smoke``, ``mesh8_ring_churn``, ``mesh2_dshard``)
runs over ``spec.devices`` ranks, which the CLI starts itself
(``launch.mesh.run_ranks``: spawned processes joined through a ``file://``
store in a temporary directory): gloo ranks on the CPU with ``--device
cpu``, else one NCCL rank a GPU.  Every rank runs the scenario; rank 0
writes the report (the other ranks' traces go to ``rank<k>/``).

Exit status is non-zero when the regression gate fails.
"""
from __future__ import annotations

import argparse
import os
import sys

import torch

from repro_torch.bench import harness, report as report_lib, scenarios
from repro_torch.launch.mesh import run_ranks
from repro_torch.obs.summary import format_attribution


def format_scenario_line(spec) -> str:
    """One ``--list`` row per scenario."""
    return (
        f"{spec.name:>12}  rounds={spec.rounds:<4} "
        f"n={spec.n_clients:<3} {spec.description}"
    )


def format_summary(rep: dict) -> str:
    dev = rep["device"]
    lines = [
        f"scenario {rep['scenario']}: {rep['description']}",
        f"  device {dev['name']} (power limit {dev['power_limit_w']} W), "
        f"torch {rep['torch_version']}",
    ]
    for name, run in sorted(rep["engines"].items()):
        line = (
            f"  {name:>9}: {run['rounds_per_sec']:>8.1f} rounds/s  "
            f"wall {run['wall_s']:.3f}s  compile {run['compile_s']:.3f}s  "
            f"dispatches {run['dispatches']}  launches {run['kernel_launches']}"
        )
        if run.get("overlap_fraction") is not None:
            line += (
                f"  overlap {run['overlap_fraction']:.0%} "
                f"(prep {run['host_prep_s']:.3f}s, "
                f"wait {run['host_wait_s']:.3f}s)"
            )
        lines.append(line)
    for name, tele in sorted((rep.get("telemetry") or {}).items()):
        lines.append(
            f"  {name} telemetry (traced pass, {tele['events']} events, "
            f"attributed {tele['attributed_fraction']:.0%} of "
            f"{tele['wall_s']:.3f}s):"
        )
        lines.append(format_attribution(tele["phases"], tele["wall_s"]))
    scheck = rep.get("shard_check")
    if scheck:
        lines.append(
            f"  shard check [{scheck['shard']}/{scheck['exchange']}, "
            f"{scheck['devices']} ranks]: allclose vs the one-rank loop "
            f"(max |Δ| {scheck['max_abs_diff']:.2e} ≤ atol {scheck['atol']:g}/"
            f"rtol {scheck['rtol']:g}), sharded engines bitwise equal to each other"
        )
    check = rep.get("kernel_check")
    if check:
        lines.append(
            f"  kernel check [{check['backend']}]: allclose vs "
            f"{check['reference_backend']} (max |Δ| {check['max_abs_diff']:.2e} "
            f"≤ atol {check['atol']:g}/rtol {check['rtol']:g}), "
            f"{check['rounds_per_sec']:.1f} rounds/s on the kernel backend"
        )
    acheck = rep.get("async_check")
    if acheck:
        lines.append(
            f"  async check: delay 0 bitwise equal to the {acheck['reference']} "
            f"(recorded delay {acheck['recorded_delay']}), "
            f"{acheck['rounds_per_sec']:.1f} rounds/s at delay 0"
        )
    ttac = rep.get("ttac")
    if ttac:
        lines.append(f"  time-to-accuracy (loss ≤ {ttac['target_loss']:g}):")
        for name, t in sorted(ttac["engines"].items()):
            if t["reached"]:
                lines.append(
                    f"    {name:>12}: round {t['rounds_to_target']} "
                    f"(~{t['seconds_to_target']:.3f}s)"
                )
            else:
                lines.append(f"    {name:>12}: target not reached")
    if rep.get("model_params"):
        lines.append(f"  model_params D = {rep['model_params']:,}")
    speedups = rep.get("speedups_vs_loop") or {}
    if speedups:
        pairs = "  ".join(
            f"{name}/loop {ratio:.2f}x" for name, ratio in sorted(speedups.items())
        )
        lines.append(f"  speedups: {pairs}  (bitwise_match={rep['bitwise_match']})")
    return "\n".join(lines)


def _deterministic() -> None:
    """TF32 off (matmuls and cuDNN) and deterministic cuDNN: the kernel
    check compares f32 results at 1e-5, and the bitwise gate needs the same
    convolution algorithms in every engine."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def _scenario_on_rank(rank: int, name: str, engines, device, out_dir: str, trace: bool):
    """One rank of a shard scenario: every rank runs it (the collectives
    need them all); rank 0 returns its report and where it wrote it."""
    _deterministic()
    spec = scenarios.get_scenario(name)
    trace_dir = None
    if trace:
        trace_dir = out_dir if rank == 0 else os.path.join(out_dir, f"rank{rank}")
    result = harness.run_scenario(spec, engines=engines, trace_dir=trace_dir, device=device)
    if rank != 0:
        return None
    rep = report_lib.make_report(spec, result)
    return rep, str(report_lib.write_report(rep, out_dir))


def _run_ranked(spec, engines, device, out_dir: str, trace: bool):
    """Start ``spec.devices`` ranks for a shard scenario and return rank 0's
    (report, path)."""
    cpu = device is not None and torch.device(device).type == "cpu"
    if not cpu and torch.cuda.device_count() < spec.devices:
        raise RuntimeError(
            f"{spec.name} needs {spec.devices} GPUs for its {spec.devices} NCCL "
            f"ranks, have {torch.cuda.device_count()}; run it on gloo CPU ranks "
            "with --device cpu"
        )
    threads = max(1, (os.cpu_count() or 1) // spec.devices) if cpu else None
    return run_ranks(_scenario_on_rank, spec.devices, backend="gloo" if cpu else "nccl",
                     args=(spec.name, engines, device, out_dir, trace),
                     num_threads=threads, timeout=3600.0)[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument(
        "--list",
        action="store_true",
        help="print the registered scenarios and exit",
    )
    ap.add_argument(
        "--scenario",
        action="append",
        default=[],
        help="scenario name (repeatable); default: bench_smoke",
    )
    ap.add_argument(
        "--engines",
        default="",
        help="comma-separated engines to run (loop, scan, pipelined, async); "
        "default: the scenario's own engine list",
    )
    ap.add_argument(
        "--device",
        default=None,
        help="torch device to run on (default: the GPU; 'cpu' for the CPU)",
    )
    ap.add_argument(
        "--out-dir",
        default="build/bench_torch",
        help="directory for BENCH_<scenario>.json reports "
        "(default: build/bench_torch)",
    )
    ap.add_argument(
        "--trace",
        action="store_true",
        help="record a traced pass per engine: TRACE_<scenario>_<engine>.json"
        " (+ .jsonl) in --out-dir and a telemetry block in the report",
    )
    ap.add_argument(
        "--baseline",
        default=None,
        help="baseline BENCH_*.json to gate against",
    )
    ap.add_argument(
        "--max-regression",
        type=float,
        default=2.0,
        help="fail when rounds/sec drops by more than this factor vs the "
        "baseline (default 2.0)",
    )
    args = ap.parse_args(argv)

    if args.list:
        for spec in scenarios.list_scenarios():
            print(format_scenario_line(spec))
        return 0

    _deterministic()
    names = args.scenario or ["bench_smoke"]
    engines = tuple(e.strip() for e in args.engines.split(",") if e.strip()) or None
    status = 0
    for name in names:
        spec = scenarios.get_scenario(name)
        if spec.step == "shard":
            rep, path = _run_ranked(spec, engines, args.device, args.out_dir, args.trace)
        else:
            result = harness.run_scenario(
                spec,
                engines=engines,
                trace_dir=args.out_dir if args.trace else None,
                device=args.device,
            )
            rep = report_lib.make_report(spec, result)
            path = report_lib.write_report(rep, args.out_dir)
        print(format_summary(rep))
        print(f"  wrote {path}")
        if args.baseline:
            baseline = report_lib.load_report(args.baseline)
            failures = report_lib.check_regression(
                rep, baseline, factor=args.max_regression
            )
            if failures:
                status = 1
                for f in failures:
                    print(f"  GATE FAIL: {f}", file=sys.stderr)
            else:
                print(
                    f"  gate: OK (within {args.max_regression:g}x of "
                    f"{args.baseline})"
                )
    return status


if __name__ == "__main__":
    sys.exit(main())
