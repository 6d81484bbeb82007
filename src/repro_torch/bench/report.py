"""Schema-versioned ``BENCH_<scenario>.json`` reports + the perf gate.

The PyTorch counterpart of the JAX package's ``bench/report.py``: the same
schema (``schema_version`` 1) and top-level keys, with three changes —
``torch_version`` in place of ``jax_version``, ``backend`` is ``"cuda"`` or
``"cpu"``, and a ``device`` block names the hardware every number in the
report was taken on::

    "device": {"name": "NVIDIA H100 80GB HBM3", "power_limit_w": 700.0,
               "cuda_version": "12.8"}

``power_limit_w`` is what ``nvidia-smi`` reports for the card (null on the
CPU or without ``nvidia-smi``).  Engine entries carry the port's
``trace_count`` (the engine's CUDA graph captures; null for the loop, the
async engine and the mesh steps) and ``kernel_launches``.

The gate (:func:`check_regression`) compares per-engine ``rounds_per_sec``
against a baseline report and fails when throughput regresses by more than
``factor``.  A baseline from another backend or another device (a JAX CPU
baseline against a card run, say) is a failure, never a silent comparison.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import subprocess
import time

import torch

from repro_torch.bench.harness import EngineRun
from repro_torch.bench.scenarios import ScenarioSpec

SCHEMA_VERSION = 1


def _power_limit_w(index: int) -> float | None:
    """The card's power limit in W, as ``nvidia-smi`` reports it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.split()
        return float(out[index])
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        return None


def device_info(device: torch.device) -> dict:
    """The ``device`` block: the hardware a report's numbers come from."""
    if device.type != "cuda":
        return {"name": "cpu", "power_limit_w": None, "cuda_version": torch.version.cuda}
    index = device.index if device.index is not None else torch.cuda.current_device()
    return {
        "name": torch.cuda.get_device_name(index),
        "power_limit_w": _power_limit_w(index),
        "cuda_version": torch.version.cuda,
    }


def device_label(info: dict) -> str:
    """A ``device`` block as one phrase with no comma: the name, and the
    power limit where it is known."""
    if info.get("power_limit_w") is None:
        return info["name"]
    return f"{info['name']} at {info['power_limit_w']} W"


def make_report(spec: ScenarioSpec, result: dict) -> dict:
    """Assemble the JSON payload from a :func:`run_scenario` result."""
    runs: dict[str, EngineRun] = result["runs"]
    device = torch.device(result["device"])
    telemetry = {
        name: run.telemetry for name, run in runs.items() if run.telemetry is not None
    }
    return {
        "schema_version": SCHEMA_VERSION,
        "scenario": spec.name,
        "description": spec.description,
        "created_unix": int(time.time()),
        "torch_version": torch.__version__,
        "backend": device.type,
        "device": device_info(device),
        # tuples (e.g. spec.engines) become lists so the payload is exactly
        # what a JSON round trip reads back
        "spec": {
            k: list(v) if isinstance(v, tuple) else v
            for k, v in dataclasses.asdict(spec).items()
        },
        "engines": {name: run.as_dict() for name, run in runs.items()},
        "speedup_rounds_per_sec": result["speedup"],
        "speedups_vs_loop": result.get("speedups", {}),
        "bitwise_match": result["bitwise_match"],
        "model_params": result.get("model_params"),
        "kernel_check": result.get("kernel_check"),
        "shard_check": result.get("shard_check"),
        "async_check": result.get("async_check"),
        "ttac": result.get("ttac"),
        "telemetry": telemetry or None,
    }


def report_path(out_dir, scenario: str) -> pathlib.Path:
    return pathlib.Path(out_dir) / f"BENCH_{scenario}.json"


def write_report(report: dict, out_dir) -> pathlib.Path:
    path = report_path(out_dir, report["scenario"])
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(report, indent=2, sort_keys=True) + "\n")
    return path


def load_report(path) -> dict:
    with open(path) as f:
        report = json.load(f)
    version = report.get("schema_version")
    if version != SCHEMA_VERSION:
        raise ValueError(f"{path}: schema_version {version!r} != {SCHEMA_VERSION}")
    return report


def check_regression(report: dict, baseline: dict, *, factor: float = 2.0) -> list[str]:
    """Compare a fresh report against a baseline; returns failure strings
    (empty ⇒ gate passes).  Only engines present in both are compared; a
    baseline of another scenario, backend or device is a failure."""
    for key, get in (
        ("scenario", lambda r: r.get("scenario")),
        ("backend", lambda r: r.get("backend")),
        ("device", lambda r: (r.get("device") or {}).get("name")),
    ):
        if get(report) != get(baseline):
            return [
                f"{key} mismatch: report {get(report)!r} vs baseline {get(baseline)!r}"
            ]
    failures = []
    for name, base in baseline.get("engines", {}).items():
        cur = report.get("engines", {}).get(name)
        if cur is None:
            failures.append(f"engine {name!r} missing from report")
            continue
        base_rps, cur_rps = base["rounds_per_sec"], cur["rounds_per_sec"]
        if cur_rps * factor < base_rps:
            failures.append(
                f"{name}: rounds/sec regressed >{factor:g}x "
                f"({cur_rps:.1f} vs baseline {base_rps:.1f})"
            )
        base_tc, cur_tc = base.get("trace_count"), cur.get("trace_count")
        if base_tc is not None and cur_tc is not None and cur_tc > base_tc:
            failures.append(
                f"{name}: trace_count grew ({cur_tc} vs baseline {base_tc}) "
                "— the engine retraces"
            )
    if baseline.get("bitwise_match") and report.get("bitwise_match") is False:
        failures.append("scan engine no longer bit-identical to the loop")
    base_speedup = baseline.get("speedup_rounds_per_sec")
    cur_speedup = report.get("speedup_rounds_per_sec")
    if base_speedup and cur_speedup and cur_speedup * factor < base_speedup:
        failures.append(
            f"scan-over-loop speedup collapsed: {cur_speedup:.2f}x vs "
            f"baseline {base_speedup:.2f}x"
        )
    return failures
