"""The readings the limits of ``checks/<workload>.json`` are set from.

    python3 portbench/calibrate.py --workload NAME --seeds 1,2,3 [--controls 3]

For each seed, in one process: the port's first K rounds through the
window's own entry (as a run's set-up drives them) against the plain
reference in f32 (the lower readings), and, on the first ``--controls``
seeds, three stand-ins put in the port's place against the same reference:
the reference computed with TF32 on (the control: the precision one step
below the configuration's) and the reference with half of every minibatch
left out and the mean taken over the rest, and the reference with the
relay left out (A = I: each relay forwards only its own update), the
planted faults.  A state left
unchanged reads 1 on ``change_gap`` by the measure itself and needs no run.
Prints one JSON line a seed and a summary line; the benchmark's own runs
never run this.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from portbench import check, harness  # noqa: E402


# what is put in the port's place: the control, and the planted faults
STAND_INS = {"control_tf32": {"mode": "tf32"}, "half_batch": {"fault": "half_batch"},
             "relay_left_out": {"fault": "relay_left_out"}}


def readings(workload: str, seed: int, device, *, controls: bool) -> dict:
    _, _, cfg, traffic = harness.load_cell(ROOT, workload)
    if device.type == "cuda":
        harness.repeatable_f32()
    cell = harness.build(cfg, traffic, seed, device)
    record = harness.check_rounds(cell)
    shared = (cell.seeds, cell.ds, cell.parts, cell.x0)
    del cell
    gc.collect()
    ref = harness.reference_rounds(cfg, traffic, *shared, device)
    out = {"seed": seed, "program": check.compare(
        record.losses, record.first, record.change, *ref)}
    if controls:
        for name, kw in STAND_INS.items():
            stand_in = harness.reference_rounds(cfg, traffic, *shared, device, **kw)
            out[name] = check.compare(*stand_in, *ref)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--controls", type=int, default=3,
                    help="how many of the seeds also read the control and the fault")
    args = ap.parse_args(argv)
    device = torch.device("cuda")
    rows = []
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        rows.append(readings(args.workload, seed, device, controls=i < args.controls))
        print(json.dumps(rows[-1]), flush=True)
    summary = {"workload": args.workload, "lower": {}, "upper": {}}
    for name in check.NUMBERS:
        summary["lower"][name] = max(r["program"][name] for r in rows)
        for kind in STAND_INS:
            vals = [r[kind][name] for r in rows if kind in r]
            if vals:
                summary["upper"].setdefault(kind, {})[name] = min(vals)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
