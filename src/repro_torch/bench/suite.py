"""Benchmark orchestrator on the port: the paper's figures, the registered
bench scenarios, and the OPT-α, relay-kernel and roofline rows.  Prints
``name,us_per_call,derived`` CSV.

The counterpart of the JAX package's ``benchmarks/run.py``:

    PYTHONPATH=src python -m repro_torch.bench.suite [--full] [--engine scan] [--device cpu]
    PYTHONPATH=src python -m repro_torch.bench.suite --list
    PYTHONPATH=src python -m repro_torch.bench.suite --skip-figures --bench bench_smoke

In order: the six figures through ``bench/figures.py`` (25 rounds a run,
100 with ``--full``; ``--engine`` drives the channel figures), unless
``--skip-figures``; each ``--bench`` scenario through the harness, its
report written to ``build/bench_torch/`` (``--trace`` adds a traced pass
an engine); the OPT-α rows (``bench/opt_alpha_bench.py``); the relay-kernel
rows (``bench/kernel_bench.py``, bf16 Δ, 2²¹ added with ``--full``); the
roofline rows (``bench/roofline.py``) over ``build/dryrun_torch/`` (run
``python -m repro_torch.launch.dryrun`` first) and the relay-sweep
reports in ``build/bench_torch/``.

Runs on the GPU unless ``--device cpu`` is given, and raises without one.
"""
from __future__ import annotations

import argparse

from repro_torch.bench import figures, kernel_bench, opt_alpha_bench, roofline
from repro_torch.utils import resolve_device

FIGURES = {
    "fig2": "homogeneous p, fully-connected (paper Fig. 2)",
    "fig3": "ring + heterogeneous p (paper Fig. 3)",
    "fig4": "non-IID + server momentum (paper Fig. 4)",
    "fig5": "time-varying channel, adaptive vs stale OPT-α (beyond-paper)",
    "fig6": "client churn over a padded client dim (beyond-paper)",
    "fig_corr": "correlated shadowing + coupled uplink, ℓ sweep "
                "(beyond-paper)",
}


def run_bench_scenarios(names: list[str], *, device=None, out_dir: str | None = None,
                        trace: bool = False) -> None:
    """Run registered bench scenarios and print their CSV rows; the reports
    go to ``out_dir`` (default ``roofline.BENCH_DIR``, where the relay rows
    read).  ``trace`` adds a traced pass per engine (TRACE_*.json in
    ``out_dir``)."""
    from repro_torch.bench import harness, report as report_lib, run, scenarios

    out_dir = out_dir or roofline.BENCH_DIR
    run._deterministic()
    for name in names:
        spec = scenarios.get_scenario(name)
        if spec.step == "shard":
            rep, path = run._run_ranked(spec, None, device, out_dir, trace)
        else:
            result = harness.run_scenario(spec, trace_dir=out_dir if trace else None,
                                          device=device)
            rep = report_lib.make_report(spec, result)
            path = report_lib.write_report(rep, out_dir)
        for eng, eng_run in sorted(rep["engines"].items()):
            us = 1e6 * eng_run["wall_s"] / spec.rounds
            row = (f"bench/{name}/{eng},{us:.0f},"
                   f"rounds_per_sec={eng_run['rounds_per_sec']:.1f};"
                   f"trace_count={eng_run['trace_count']};"
                   f"dispatches={eng_run['dispatches']}")
            if eng_run.get("overlap_fraction") is not None:
                row += f";overlap_fraction={eng_run['overlap_fraction']:.2f}"
            print(row)
        speedups = ";".join(
            f"speedup_{eng}={ratio:.2f}x"
            for eng, ratio in sorted((rep.get("speedups_vs_loop") or {}).items()))
        print(f"bench/{name}/summary,0,{speedups};"
              f"bitwise_match={rep['bitwise_match']};"
              f"device={report_lib.device_label(rep['device'])};report={path}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true",
                    help="paper-scale rounds, and the relay kernels also at D = 2^21")
    ap.add_argument("--model", default="mlp", choices=["mlp", "resnet20"])
    ap.add_argument("--engine", default="loop", choices=list(figures.ENGINES),
                    help="round engine for figs 5/6/corr (scan = epoch-fused, "
                         "pipelined = τ-fused chunks + prefetched host work)")
    ap.add_argument("--skip-figures", action="store_true")
    ap.add_argument("--list", action="store_true",
                    help="list figure benchmarks and registered bench scenarios, then exit")
    ap.add_argument("--bench", action="append", default=[],
                    help="also run a registered bench scenario (repeatable); writes "
                         "build/bench_torch/BENCH_<name>.json")
    ap.add_argument("--trace", action="store_true",
                    help="with --bench: record traced passes (TRACE_<scenario>_<engine>.json)")
    ap.add_argument("--device", default=None, help="default: the GPU")
    args = ap.parse_args(argv)

    if args.list:
        from repro_torch.bench import scenarios
        from repro_torch.bench.run import format_scenario_line

        print("figure benchmarks:")
        for name, desc in FIGURES.items():
            print(f"  {name:>12}  {desc}")
        print("bench scenarios (--bench NAME / repro_torch.bench.run):")
        for spec in scenarios.list_scenarios():
            print(f"  {format_scenario_line(spec)}")
        return

    resolve_device(args.device)  # no GPU and no --device: raise before any row
    rounds = 100 if args.full else 25
    print("name,us_per_call,derived")
    if not args.skip_figures:
        figures.run_figures(figures.ALL_FIGURES, rounds=rounds, model=args.model,
                            engine=args.engine, device=args.device)
    if args.bench:
        run_bench_scenarios(args.bench, device=args.device, trace=args.trace)
    opt_alpha_bench.run()
    kernel_bench.run(full=args.full, device=args.device)
    roofline.run()


if __name__ == "__main__":
    main()
