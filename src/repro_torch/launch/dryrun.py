"""Multi-pod dry run: plan every (arch × input shape × mesh) layout and
record the roofline inputs, with nothing allocated.

The PyTorch counterpart of the JAX package's ``launch/dryrun.py``.  There a
dry run lowers and compiles each step on 512 placeholder devices.  Here
each step runs once on ``meta`` tensors (shapes, no storage) at full width
and depth:

* **train** shapes: the full ColRel round of `fl/distributed.py`'s
  ``build_round_step`` (T = 1 local step per client, n = the mesh's client
  axes: 16, or 32 over two pods);
* **prefill / decode** shapes: the model's ``prefill`` and ``decode``.

What it checks and records:

* the layout resolves: parameter, batch and cache specs from
  `sharding/rules.py` (``fsdp_tp`` for the reference's ``FSDP_ARCHS`` /
  ``SERVE_FSDP_ARCHS``, else ``tp``), cut with ``rules.local_shard`` on a
  shape-only mesh (`launch/mesh.py`'s ``MeshShape``).  A dim that does not
  divide raises, and the record says ``"status": "error"``, as the
  reference records a compile that fails;
* **per-device bytes** of arguments and outputs, exactly, from the shard
  shapes;
* **FLOPs and device-memory bytes** of the global step from
  `launch/hlo_cost.py` (``analyze`` on meta tensors), divided by the
  chips: the *ideal split*, not a partitioned program's count;
* the roofline seconds against one NVIDIA H100 80GB HBM3 at 700 W.

``collective_bytes_per_device`` is null: the port runs the model zoo
unsharded (each step is one device's program), so no model-parallel
collective exists to count.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch glm4-9b --shape train_4k [--multi-pod]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

Runs on the CPU in seconds to minutes a pair (``prefill_32k``'s blockwise
attention dispatches the most ops).  Artifacts:
``build/dryrun_torch/<mesh>/<arch>__<shape>.json``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Callable

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import registry as creg
from repro_torch.configs.base import INPUT_SHAPES, ModelConfig
from repro_torch.core import connectivity, opt_alpha, topology
from repro_torch.core.aggregation import ServerOpt
from repro_torch.fl.distributed import build_round_step
from repro_torch.launch import hlo_cost
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import registry as mreg
from repro_torch.optim.sgd import ClientOpt
from repro_torch.sharding import hints, rules
from repro_torch.utils import tree_flatten, tree_map

ARTIFACT_DIR = os.path.join(
    os.path.dirname(__file__), "..", "..", "..", "build", "dryrun_torch"
)

# roofline denominators: one NVIDIA H100 80GB HBM3 (SXM) at 700 W, NVIDIA's
# data sheet (dense rates)
DEVICE = "NVIDIA H100 80GB HBM3, 700 W"
PEAK_FLOPS = 989e12      # bf16 FLOP/s a card, tensor cores, dense
HBM_BW = 3.35e12         # B/s a card
HBM_BYTES = 80e9         # device memory a card
ICI_BW = 900e9           # B/s a card over NVLink 4

# the reference's choice of 2-D sharding, by arch: training when the
# parameters exceed a 1-D TP slice, serving when bf16 weights exceed a
# 16-way TP slice
FSDP_ARCHS = {
    "grok-1-314b", "mixtral-8x22b", "qwen2.5-32b", "qwen1.5-32b",
}
SERVE_FSDP_ARCHS = {"grok-1-314b", "mixtral-8x22b"}

# torch's dtypes under the reference's HLO names
DTYPE_BYTES = hlo_cost.DTYPE_BYTES


class _MetaFactories(TorchDispatchMode):
    """Every op that creates a tensor on a device creates it on ``meta``
    instead (drawing from no generator), so a model's ``init`` gives its
    full-size parameters without storage."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if "device" in kwargs:
            kwargs["device"] = torch.device("meta")
            if "generator" in kwargs:
                kwargs["generator"] = None
        return func(*args, **kwargs)


def _on_meta(make: Callable) -> Any:
    """``make()``'s tensors on meta; a leaf made from a host value (a 0-d
    position counter) is replaced by a meta tensor of its shape."""
    with _MetaFactories():
        tree = make()
    return tree_map(lambda x: torch.empty(tuple(x.shape), dtype=x.dtype, device="meta"), tree)


def _meta_params(md) -> Any:
    return _on_meta(lambda: md.init(0, device="cpu"))


@dataclasses.dataclass
class Lowered:
    """A step ready to analyse: ``fn(*args)`` on meta tensors, with the
    spec tree of each argument (None: replicated) and a function giving the
    spec trees of its outputs."""

    fn: Callable
    args: tuple
    arg_specs: tuple
    out_specs: Callable
    mode: str


def _dryrun_cfg(arch: str, shape_name: str, reduced: bool = False) -> ModelConfig:
    shape = INPUT_SHAPES[shape_name]
    cfg = creg.for_shape(creg.get_config(arch, reduced=reduced), shape)
    return dataclasses.replace(cfg, param_dtype="bfloat16", compute_dtype="bfloat16")


def _n_clients(mesh) -> int:
    n = mesh.shape["data"]
    if "pod" in mesh.axis_names:
        n *= mesh.shape["pod"]
    return n


def _replicated(x: torch.Tensor) -> tuple:
    return (None,) * x.ndim


def build_train_lowering(arch: str, shape_name: str, mesh, relay_mode: str = "faithful",
                         *, reduced: bool = False):
    """The ColRel round of ``arch`` (its ``reduced()`` config if asked) at
    ``shape_name`` on ``mesh``'s client count, on meta tensors.  Returns
    ``(Lowered, cfg, shape)``."""
    shape = INPUT_SHAPES[shape_name]
    cfg = _dryrun_cfg(arch, shape_name, reduced)
    md = mreg.get_model(cfg)
    n = _n_clients(mesh)
    p = connectivity.heterogeneous_profile(n).p
    A = opt_alpha.optimize(p, topology.ring(n, k=2), sweeps=20).A.astype(np.float32)
    step = build_round_step(
        md.loss, n_clients=n, local_steps=1, A=A, relay_mode=relay_mode,
        client_opt=ClientOpt(kind="sgd", weight_decay=1e-4), server_opt=ServerOpt(),
    )
    params = _meta_params(md)
    per_client = shape.global_batch // n
    batch = {k: torch.empty((n, 1, per_client) + tuple(v.shape[1:]), dtype=v.dtype,
                            device="meta")
             for k, v in mreg.input_specs(cfg, shape).items()}
    tau = torch.empty((n,), device="meta")
    lr = torch.empty((), device="meta")
    mode = "fsdp_tp" if arch in FSDP_ARCHS else "tp"
    pspecs = rules.param_specs(params, mesh, mode)

    def fn(params, server_state, batch, tau, lr):
        # the reference's stable blockwise-attention layout (inert on plain
        # tensors: see sharding/hints.py)
        with hints.axis_rules(mesh, {"qchunk": "model"}):
            return step(params, server_state, batch, tau, lr)

    lowered = Lowered(
        fn=fn, args=(params, None, batch, tau, lr),
        arg_specs=(pspecs, None, rules.train_batch_specs(batch, mesh), (None,), ()),
        out_specs=lambda out: (pspecs, None, _replicated(out[2])), mode=mode)
    return lowered, cfg, shape


def build_serve_lowering(arch: str, shape_name: str, mesh, *, reduced: bool = False):
    """The prefill or decode step of ``arch`` at ``shape_name``, on meta
    tensors.  Returns ``(Lowered, cfg, shape)``."""
    shape = INPUT_SHAPES[shape_name]
    cfg = _dryrun_cfg(arch, shape_name, reduced)
    md = mreg.get_model(cfg)
    mode = "fsdp_tp" if arch in SERVE_FSDP_ARCHS else "tp"
    params = _meta_params(md)
    pspecs = rules.param_specs(params, mesh, mode)
    rule = {"batch": rules.client_axes(mesh), "qchunk": "model"}
    B = shape.global_batch

    def logits_and_cache(out):
        logits, cache = out
        return (rules.serve_batch_specs({"logits": logits}, mesh)["logits"],
                rules.cache_specs(cache, mesh, B))

    if shape.kind == "prefill":
        batch = mreg.input_specs(cfg, shape)

        def fn(params, batch):
            with hints.axis_rules(mesh, rule):
                return md.prefill(params, batch)

        return Lowered(fn, (params, batch), (pspecs, rules.serve_batch_specs(batch, mesh)),
                       logits_and_cache, mode), cfg, shape
    # decode: one token against a cache of seq_len
    cache = _on_meta(lambda: md.init_cache(B, shape.seq_len, device="cpu"))
    tokens = {"tokens": torch.empty((B, 1), dtype=torch.int32, device="meta")}

    def fn(params, cache, tokens):
        with hints.axis_rules(mesh, rule):
            return md.decode(params, cache, tokens)

    return Lowered(fn, (params, cache, tokens["tokens"]),
                   (pspecs, rules.cache_specs(cache, mesh, B),
                    rules.serve_batch_specs(tokens, mesh)["tokens"]),
                   logits_and_cache, mode), cfg, shape


def model_flops(cfg: ModelConfig, shape) -> float:
    """Analytic MODEL_FLOPS per step: 6·N·D train, 2·N_active·D inference."""
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    n_active = cfg.active_param_count()
    return (6.0 if shape.kind == "train" else 2.0) * n_active * tokens


def _local_bytes(trees: tuple, specs: tuple, mesh) -> int:
    """Bytes of this rank's block of every leaf: the shard shapes, cut by
    ``rules.local_shard`` (raises where a dim does not divide)."""
    total = 0
    for tree, spec in zip(trees, specs):
        if tree is None:
            continue
        if isinstance(tree, torch.Tensor):
            tree, spec = [tree], [spec]
        for leaf in tree_flatten(rules.local_shard(tree, spec, mesh))[0]:
            total += leaf.numel() * leaf.element_size()
    return total


def run_one(arch: str, shape_name: str, *, multi_pod: bool, relay_mode: str = "faithful",
            out_dir: str | None = None, mesh=None, reduced: bool = False) -> dict:
    """Plan and cost one (arch, shape) on the production mesh (or a given
    shape-only ``mesh``, with ``reduced`` the arch's ``reduced()`` config:
    the tests' miniature); writes and returns the record."""
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    skip = creg.is_skipped(arch, shape_name)
    record: dict = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "relay_mode": relay_mode, "status": "skipped", "skip_reason": skip,
    }
    if skip is None:
        mesh = mesh or make_production_mesh(multi_pod=multi_pod, shape_only=True)
        shape = INPUT_SHAPES[shape_name]
        t0 = time.time()
        try:
            if shape.kind == "train":
                lowered, cfg, shape = build_train_lowering(arch, shape_name, mesh, relay_mode,
                                                           reduced=reduced)
            else:
                lowered, cfg, shape = build_serve_lowering(arch, shape_name, mesh,
                                                           reduced=reduced)
            arg_bytes = _local_bytes(lowered.args, lowered.arg_specs, mesh)
            outs: list = []
            cost = hlo_cost.analyze(lambda *a: outs.append(lowered.fn(*a)), *lowered.args)
            out = outs[0]
            out_bytes = _local_bytes(tuple(out), lowered.out_specs(out), mesh)
            t1 = time.time()
            chips = int(np.prod(list(mesh.shape.values())))
            flops_dev = cost["flops"] / chips
            bytes_dev = cost["hbm_bytes"] / chips
            mf = model_flops(cfg, shape)
            record.update({
                "status": "ok",
                "analysis_seconds": round(t1 - t0, 1),
                "chips": chips,
                "sharding_mode": lowered.mode,
                "global": {"flops": cost["flops"], "hbm_bytes": cost["hbm_bytes"]},
                "per_device": {
                    "flops": flops_dev, "bytes": bytes_dev,
                    "split": "ideal: the global step's count over the chips",
                    "argument_bytes": arg_bytes, "output_bytes": out_bytes,
                    "temp_bytes": None,
                    "temp_bytes_reason": "eager torch has no compiled buffer plan",
                },
                "collective_bytes_per_device": None,
                "collective_bytes_reason": (
                    "the port runs the model zoo unsharded: no model-parallel "
                    "collective exists to count"),
                "roofline_device": DEVICE,
                "roofline_seconds": {
                    "compute": flops_dev / PEAK_FLOPS,
                    "memory": bytes_dev / HBM_BW,
                    "collective": None,
                },
                "model_flops_global": mf,
                "useful_flops_ratio": mf / cost["flops"] if cost["flops"] else None,
                "n_params": cfg.param_count(),
                "n_params_active": cfg.active_param_count(),
            })
            r = {k: v for k, v in record["roofline_seconds"].items() if v is not None}
            record["bottleneck"] = max(r, key=r.get)
        except Exception as e:  # noqa: BLE001 — record the failure, don't die
            record.update({
                "status": "error",
                "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc(limit=8),
            })
    out_dir = out_dir or os.path.join(ARTIFACT_DIR, mesh_name)
    os.makedirs(out_dir, exist_ok=True)
    suffix = "" if relay_mode == "faithful" else f"__{relay_mode}"
    with open(os.path.join(out_dir, f"{arch}__{shape_name}{suffix}.json"), "w") as f:
        json.dump(record, f, indent=2)
    return record


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=sorted(creg.ASSIGNED))
    ap.add_argument("--shape", choices=sorted(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--relay-mode", default="faithful", choices=["faithful", "fused"])
    ap.add_argument("--force", action="store_true", help="recompute cached artifacts")
    args = ap.parse_args()
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")

    pairs = ([(a, s) for a in creg.ASSIGNED for s in INPUT_SHAPES]
             if args.all else [(args.arch, args.shape)])
    mesh_name = "pod2x16x16" if args.multi_pod else "pod16x16"
    for arch, shape_name in pairs:
        suffix = "" if args.relay_mode == "faithful" else f"__{args.relay_mode}"
        path = os.path.join(ARTIFACT_DIR, mesh_name, f"{arch}__{shape_name}{suffix}.json")
        if not args.force and os.path.exists(path):
            with open(path) as f:
                if json.load(f).get("status") in ("ok", "skipped"):
                    print(f"[cached] {arch} {shape_name} {mesh_name}")
                    continue
        rec = run_one(arch, shape_name, multi_pod=args.multi_pod, relay_mode=args.relay_mode)
        if rec["status"] == "ok":
            r = rec["roofline_seconds"]
            print(f"[ok] {arch} {shape_name} {mesh_name} analysis={rec['analysis_seconds']}s "
                  f"compute={r['compute']:.3e}s memory={r['memory']:.3e}s "
                  f"bottleneck={rec['bottleneck']} ({DEVICE})")
            print(f"     per device: {rec['per_device']}")
            print(f"     useful_ratio={rec['useful_flops_ratio']}")
        elif rec["status"] == "skipped":
            print(f"[skip] {arch} {shape_name}: {rec['skip_reason']}")
        else:
            print(f"[ERROR] {arch} {shape_name} {mesh_name}: {rec['error']}")


if __name__ == "__main__":
    main()
