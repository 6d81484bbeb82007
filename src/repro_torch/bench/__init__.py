"""Benchmark subsystem: declarative scenarios, a timing harness, JSON reports.

The PyTorch counterpart of the JAX package's ``bench``.  Three layers,
consumed in order:

1. **Scenarios** (`scenarios`) — :class:`ScenarioSpec` declaratively composes
   model size × topology × fading × drift × churn × engine chunking into one
   named, registered benchmark setting (the JAX package's registry, minus
   the scenarios listed in ``scenarios.NOT_YET_PORTED``).

2. **Harness** (`harness`) — :func:`run_scenario` runs a spec under each
   engine twice (cold + warm) on the GPU or the CPU, measuring wall clock,
   the one-time cost and rounds/sec, verifies the engines' final parameters
   match bit for bit, and holds a kernel backend against ``einsum``.

3. **Reports** (`report`) — schema-versioned ``BENCH_<scenario>.json``
   emission with the device they ran on, plus :func:`check_regression`.

CLI: ``PYTHONPATH=src python -m repro_torch.bench.run --scenario bench_smoke``
(``--device cpu`` for the CPU).
"""
from repro_torch.bench.harness import EngineRun, run_scenario
from repro_torch.bench.report import (
    SCHEMA_VERSION,
    check_regression,
    load_report,
    make_report,
    write_report,
)
from repro_torch.bench.scenarios import (
    NOT_YET_PORTED,
    ScenarioSpec,
    build,
    get_scenario,
    list_scenarios,
    register,
)

__all__ = [
    "EngineRun",
    "NOT_YET_PORTED",
    "SCHEMA_VERSION",
    "ScenarioSpec",
    "build",
    "check_regression",
    "get_scenario",
    "list_scenarios",
    "load_report",
    "make_report",
    "register",
    "run_scenario",
    "write_report",
]
