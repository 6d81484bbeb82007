"""The benchmark's registry, counts and result line, on the CPU."""
import importlib
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import check, harness, timing
from portbench.metrics import fused_aggregate_us

ROOT = Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CONFIGS = {c["name"]: c for c in BENCH["configs"]}


# every configuration file, also those of cells BENCHMARK.json leaves out
CONFIG_FILES = sorted(p.stem for p in (ROOT / "portbench" / "configs").glob("*.json"))


def _cfg(name):
    return json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("cell", [c["name"] for c in BENCH["workloads"]])
def test_cell_files_found_by_name(cell):
    bench, spec, cfg, traffic = harness.load_cell(ROOT, cell)
    assert spec["config"] in CONFIGS and cfg["model"]
    importlib.import_module(f"portbench.models.{cfg['model']}")
    importlib.import_module(f"portbench.reference.{cfg['model']}")
    assert isinstance(importlib.import_module(f"portbench.data.{cfg['data']['kind']}").LM, bool)
    # every mechanism the mix names is a module of its own, on both sides
    ch, pol = traffic["channel"], traffic["policy"]
    for module in (f"topologies.{ch['topology']['kind']}", f"channels.{ch['kind']}",
                   f"reference.channels.{ch['kind']}", f"policies.{pol['kind']}",
                   f"reference.policies.{pol['kind']}", f"engines.{traffic['engine']['kind']}"):
        importlib.import_module(f"portbench.{module}")
    assert sum(traffic["check_calls"]) >= 3 and traffic["block_rounds"] >= 1
    limits = check.load_limits(ROOT, cell)
    assert limits and set(limits) <= set(check.NUMBERS) and all(v > 0 for v in limits.values())


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_found_by_name(metric):
    mod = importlib.import_module(f"portbench.metrics.{metric}")
    assert callable(mod.read)


def test_benchmark_metric_names_unique_and_workloads_known():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    cells = {c["name"] for c in BENCH["workloads"]}
    assert len(names) == len(set(names)) and "setup_s" in names
    for m in BENCH["per_layer"]:
        assert m["moves"] == "rounds_per_s" and set(m.get("workloads", cells)) <= cells


def test_resnet20_flops_by_hand():
    # multiply-adds a 32×32 image: stem 32·32·27·16; stage 1 six 3×3 16→16
    # convolutions at 32×32; stages 2 and 3 a stride-2 3×3, a 1×1 projection
    # and five 3×3 at the halved map; the 64→10 linear layer
    stem = 32 * 32 * 27 * 16
    stage1 = 6 * 32 * 32 * 9 * 16 * 16
    stage2 = 16 * 16 * (9 * 16 * 32 + 16 * 32 + 5 * 9 * 32 * 32)
    stage3 = 8 * 8 * (9 * 32 * 64 + 32 * 64 + 5 * 9 * 64 * 64)
    macs = stem + stage1 + stage2 + stage3 + 64 * 10
    assert macs == 40_813_184
    mod = importlib.import_module("portbench.models.resnet20_gn")
    cfg = _cfg("resnet20_gn_cifar_n10")
    assert mod.forward_flops_per_sample(cfg) == 2 * macs
    # a round: 3× forward for training, 10 clients × 8 steps × 64 images
    assert harness.flops_per_round(cfg) == 3 * 2 * macs * 10 * 8 * 64


def test_mlp_flops_by_hand():
    mod = importlib.import_module("portbench.models.mlp3072")
    cfg = _cfg("mlp3072_cifar_n10")
    assert mod.forward_flops_per_sample(cfg) == 2 * (3072 * 256 + 256 * 10)
    assert harness.flops_per_round(cfg) == 3 * 2 * 788_992 * 5120


@pytest.mark.parametrize("config", CONFIG_FILES)
def test_weights_match_the_ports_layout(config):
    from repro_torch.utils import tree_flatten

    cfg = _cfg(config)
    mod = importlib.import_module(f"portbench.models.{cfg['model']}")
    # the published size by its shapes; the layouts at the CPU tests' size
    assert sum(math.prod(s) for s in mod.leaf_shapes(cfg).values()) == cfg["num_params"]
    small = mod.cpu_size(cfg)
    ours = mod.init_params(small, 5, "cpu")
    assert {k: tuple(v.shape) for k, v in ours.items()} == {
        k: tuple(s) for k, s in mod.leaf_shapes(small).items()}
    if small is cfg:
        assert sum(v.numel() for v in ours.values()) == cfg["num_params"]
    port = mod.port_params(small, 0)
    flat = harness.ref_fl.flatten(port)
    assert {k: tuple(v.shape) for k, v in flat.items()} == {
        k: tuple(v.shape) for k, v in ours.items()}
    assert len(tree_flatten(port)[0]) == len(ours)


def test_fused_aggregate_bytes():
    # Δ (n, D) read, the update (D,) written, the coefficients (n,) read
    assert fused_aggregate_us.nbytes(10, 272_282) == 11 * 272_282 * 4 + 40
    bound, kind = timing.bound_ms(fused_aggregate_us.nbytes(10, 272_282), 2 * 10 * 272_282)
    assert kind == "bytes" and bound == pytest.approx(0.0035763, rel=1e-4)


def test_fused_aggregate_time_reads_the_kernels_in_the_window():
    cfg = _cfg("resnet20_gn_cifar_n10")
    ctx = harness.TraceContext(cfg=cfg, traffic={}, flops_per_round=0.0,
                               span_window=harness.Window(), spans=[], counters={})
    assert fused_aggregate_us.read(ctx) is None  # nothing launched: nothing read
    # 40 launches of 7.2 µs; the other kernels are not counted
    ctx.device_ops = {"void fused_aggregate_kernel<float>(float const*, float const*)":
                      [40 * 7.2e-6, 40], "ampere_sgemm_128x64_nn": [1.0, 3]}
    assert fused_aggregate_us.read(ctx) == pytest.approx(7.2)


def test_reference_imports_nothing_of_the_port():
    import ast

    for path in sorted((ROOT / "portbench" / "reference").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in ("repro_torch", "repro", "jax"), (path, name)


def test_blocked_modules_compare_whole_top_level_names():
    mods = ["repro_torch.fl.engine", "reprox", "jax.numpy", "repro", "repro.core", "flaxen"]
    assert harness.blocked_modules(mods) == ["jax.numpy", "repro", "repro.core"]


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys, time, json\n"
        "from pathlib import Path\n"
        "from portbench import harness, check\n"
        "root = Path('.')\n"
        "bench, cell, cfg, traffic = harness.load_cell(root, 'resnet20.fig3_static')\n"
        "cfg = dict(cfg, local_steps=1, local_batch=2, data=dict(cfg['data'], n_train=100))\n"
        "traffic = dict(traffic, check_calls=[1, 2], block_rounds=1)\n"
        "out = harness.run_cell(cell, cfg, traffic, check.load_limits(root, 'resnet20.fig3_static'),"
        " seed=3, seconds=0.01, trace=True, device='cpu', t_start=time.perf_counter(),"
        " bench=bench)\n"
        "print(json.dumps(harness.blocked_modules(sys.modules)))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT), str(ROOT / "src")]))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def test_run_exits_nonzero_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run([sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
                           "resnet20.fig3_static", "--seed", str(2**33 + 1), "--seconds", "1"],
                          cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
