"""Run one cell of ``BENCHMARK.json`` once and print its result's line.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout, on a machine with the cell's number of NVIDIA
GPUs: without one it exits with code 3 and prints no result.  ``--trace
0`` prints the cell's end-to-end metrics, ``--trace 1`` its per-layer ones
(a third of the seconds under the port's tracer, a third untraced, a third
under ``torch.profiler``).
Either way the last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, [``breakdown``] and,
last, ``check``: each number compared with its limit), and the last lines
of standard error repeat the numbers beside their limits.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache inside the checkout, at fixed paths
CACHE = ROOT / "build" / "portbench"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import check, harness

    bench, cell, cfg, traffic = harness.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA device(s), "
              f"found {found}", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.cuda.init()
    torch.cuda.reset_peak_memory_stats(device)
    limits = check.load_limits(ROOT, args.workload)
    out = harness.run_cell(cell, cfg, traffic, limits, seed=args.seed,
                           seconds=args.seconds, trace=bool(args.trace), device=device,
                           t_start=T_START, bench=bench)
    # after the window: what the port loaded in this process, whole top-level
    # names compared
    found = harness.blocked_modules(list(sys.modules))
    if found:
        print(f"portbench: loaded in the measured process: {', '.join(found)}",
              file=sys.stderr)
        return 4
    for name, c in out["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
