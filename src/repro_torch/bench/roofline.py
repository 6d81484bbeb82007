"""Roofline table from the dry-run records, and the measured relay sweep.

The counterpart of the JAX package's ``benchmarks/roofline.py``.
:func:`table` reads ``launch/dryrun.py``'s records
(``build/dryrun_torch/<mesh>/*.json``) and prints, per (arch × shape ×
mesh): the roofline terms in seconds, the bottleneck, MODEL_FLOPS over the
counted FLOPs, and the bytes a device against the device memory of the card
named in ``dryrun.DEVICE`` (80 GB).  The port's records differ from the
reference's in two places, and the rows say so:

* ``roofline_seconds.collective`` is ``None`` (the port runs the model zoo
  unsharded): printed ``collective=n/a``, and the step time is the largest
  term that is not ``None``, as ``dryrun.run_one`` picks the bottleneck;
* ``per_device`` has no ``peak_bytes`` (eager torch has no compiled buffer
  plan, so temporaries are unknown): the arguments' and outputs' bytes are
  printed as a lower bound, ``peak_gb>=``, and a device holds them
  (``args_out_fit``) or cannot (``OVER_HBM_x``).

A record in the reference's schema (``peak_bytes``, a numeric collective)
formats as the reference formats it, against 80 GB.

:func:`relay_table` is the measured companion: it reads the
``BENCH_relay_sweep_*.json`` reports (by default ``build/bench_torch/``,
where ``python -m repro_torch.bench.run`` and ``suite --bench`` write) and
prints, per model size D, the engines' rounds/s, the fused reduction's bytes
a round and arithmetic intensity, and whether the point is dispatch-bound
or traffic-bound.  A port report adds the device it ran on.

    PYTHONPATH=src python -m repro_torch.bench.roofline
"""
from __future__ import annotations

import glob
import json
import os

from repro_torch.bench.report import device_label
from repro_torch.launch import dryrun

REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..", ".."))
ARTIFACT_DIR = dryrun.ARTIFACT_DIR
BENCH_DIR = os.path.join(REPO_ROOT, "build", "bench_torch")
HBM_PER_CHIP = dryrun.HBM_BYTES
MESHES = ("pod16x16", "pod2x16x16")


def load(mesh: str) -> list[dict]:
    """The records of ``mesh`` in file order; none for a missing directory."""
    d = os.path.join(ARTIFACT_DIR, mesh)
    if not os.path.isdir(d):
        return []
    out = []
    for f in sorted(os.listdir(d)):
        if f.endswith(".json"):
            with open(os.path.join(d, f)) as fh:
                out.append(json.load(fh))
    return out


def device_bytes(rec: dict) -> tuple[float, bool]:
    """(bytes a device, exact): the compiled peak where the record has one,
    else the arguments' and outputs' bytes, a lower bound."""
    per = rec["per_device"]
    if per.get("peak_bytes") is not None:
        return per["peak_bytes"], True
    return per["argument_bytes"] + per["output_bytes"], False


def fits_label(nbytes: float, exact: bool) -> str:
    if nbytes > HBM_PER_CHIP:
        return f"OVER_HBM_x{nbytes / HBM_PER_CHIP:.1f}"
    return "fits" if exact else "args_out_fit"


def _sci(x) -> str:
    return "n/a" if x is None else f"{x:.3e}"


def table(mesh: str = "pod16x16", *, csv: bool = True) -> list[str]:
    lines = []
    for rec in load(mesh):
        name = f"roofline/{mesh}/{rec['arch']}/{rec['shape']}"
        if rec.get("relay_mode", "faithful") != "faithful":
            name += f"/{rec['relay_mode']}"
        if rec["status"] == "skipped":
            lines.append(f"{name},0,SKIP:{rec['skip_reason']}")
            continue
        if rec["status"] != "ok":
            lines.append(f"{name},0,ERROR:{rec['error'][:80]}")
            continue
        r = rec["roofline_seconds"]
        step_us = 1e6 * max(v for v in r.values() if v is not None)
        nbytes, exact = device_bytes(rec)
        ratio = rec.get("useful_flops_ratio")
        lines.append(
            f"{name},{step_us:.0f},"
            f"compute={r['compute']:.3e};memory={r['memory']:.3e};"
            f"collective={_sci(r['collective'])};bottleneck={rec['bottleneck']};"
            f"useful_ratio={ratio if ratio is None else round(ratio, 3)};"
            f"peak_gb{'=' if exact else '>='}{nbytes / 1e9:.2f};{fits_label(nbytes, exact)}"
        )
    if csv:
        for line in lines:
            print(line)
    return lines


def load_relay_reports(root: str | None = None) -> list[dict]:
    """The ``BENCH_relay_sweep_*.json`` reports in ``root`` (default
    :data:`BENCH_DIR`), by model size."""
    reports = []
    pattern = os.path.join(root or BENCH_DIR, "BENCH_relay_sweep_*.json")
    for path in sorted(glob.glob(pattern)):
        with open(path) as fh:
            reports.append(json.load(fh))
    return sorted(reports, key=lambda r: r.get("model_params") or 0)


def relay_table(root: str | None = None, *, csv: bool = True) -> list[str]:
    """Measured relay-sweep roofline: one row per recorded D point of the
    reports in ``root`` (default :data:`BENCH_DIR`).

    Per row: D, n, the engines' rounds/sec (the loop, the scan engine and
    the kernel check's pass), the fused reduction's device-memory traffic a
    round (read n·D·4 + write D·4 bytes; coefficients and A are noise at
    these shapes), its arithmetic intensity (2·n·D flops over those bytes:
    ≈ 0.5 flop a byte, memory-bound at every D), the rate the kernel pass
    implies, and the regime: rows whose round time stays within 3× the
    smallest D's are **dispatch-bound** (fixed overhead dominates), the
    rest **traffic-bound**.  A report that names its device (the port's)
    adds ``device=``.
    """
    reports = load_relay_reports(root)
    lines = []
    base_round_s = None
    for rep in reports:
        spec = rep.get("spec", {})
        n = spec.get("n_clients", 0)
        D = rep.get("model_params") or 0
        engines = rep.get("engines", {})
        check = rep.get("kernel_check") or {}
        kname = f"scan_{check['backend']}" if check else None
        krps = engines.get(kname, {}).get("rounds_per_sec") if kname else None
        scan_rps = engines.get("scan", {}).get("rounds_per_sec")
        loop_rps = engines.get("loop", {}).get("rounds_per_sec")
        rps = krps or scan_rps or loop_rps
        if not rps or not D or not n:
            continue
        round_s = 1.0 / rps
        if base_round_s is None:
            base_round_s = round_s
        bytes_round = 4.0 * (n * D + D)  # fused reduce: read Δ, write u
        flops_round = 2.0 * n * D
        intensity = flops_round / bytes_round
        gbs = bytes_round * rps / 1e9
        regime = (
            "dispatch-bound" if round_s < 3.0 * base_round_s else "traffic-bound"
        )
        line = (
            f"relay/{rep['scenario']},D={D},n={n},"
            f"loop_rps={0.0 if loop_rps is None else loop_rps:.1f},"
            f"scan_rps={0.0 if scan_rps is None else scan_rps:.1f},"
            f"kernel_rps={0.0 if krps is None else krps:.1f},"
            f"bytes_per_round={bytes_round:.3e},"
            f"intensity_flop_per_byte={intensity:.3f},"
            f"achieved_gbs={gbs:.2f},"
            f"max_abs_diff={check.get('max_abs_diff', 0.0):.2e},"
            f"{regime}"
        )
        if rep.get("device"):
            line += f",device={device_label(rep['device'])}"
        lines.append(line)
    if csv:
        for line in lines:
            print(line)
    return lines


def run() -> list[str]:
    out = []
    for mesh in MESHES:
        out += table(mesh)
    out += relay_table()
    return out


if __name__ == "__main__":
    run()
