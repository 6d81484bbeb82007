#!/usr/bin/env python3
"""Round by round, how far two relay backends' runs of a scenario drift apart.

    PYTHONPATH=src python3 tools/backend_divergence.py resnet20_cifar \\
        [--backends einsum,hopper] [--library-plain] [--device cpu]

Runs the registered scenario's per-round loop (``run_rounds_loop``, the
harness's seeds, batches and schedule) once on each backend and prints, for
every round, the largest parameter difference, how many parameters differ
and both losses.  ``--library-plain`` swaps the plain versions of the relay
kernels (the ``einsum`` backend) for one library product each (``A @ Δ``,
``c @ Δ``), whose summation order cuBLAS picks by shape — the plain versions
before they summed in the kernels' order.  Runs on the GPU unless
``--device cpu`` is given; TF32 off, cuDNN deterministic.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("scenario")
    ap.add_argument("--backends", default="einsum,hopper")
    ap.add_argument("--library-plain", action="store_true")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)

    from repro_torch.bench import harness, scenarios
    from repro_torch.fl.engine import run_rounds_loop
    from repro_torch.kernels import ref
    from repro_torch.utils import tree_flatten

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    if args.library_plain:
        ref.relay_mix_2d = lambda A, d: (A.float() @ d.float()).to(d.dtype)
        ref.fused_aggregate_2d = lambda c, d: (c.float() @ d.float()).to(d.dtype)
    spec = scenarios.get_scenario(args.scenario)

    def run(backend):
        bundle = scenarios.build(
            dataclasses.replace(spec, relay_backend=backend, check_backend="none"),
            device=args.device)
        sim = bundle.make_sim()
        params = bundle.init_fn(spec.seed)
        gen = torch.Generator(device=sim.device).manual_seed(spec.seed + 1)
        batches = iter(harness._pregenerate_batches(bundle))
        flat = []
        _, _, metrics, _ = run_rounds_loop(
            sim, gen, params, sim.init_server_state(params),
            schedule=bundle.make_schedule(), rounds=spec.rounds,
            next_batch=lambda: next(batches), lr=spec.lr, policy=bundle.make_policy(),
            on_round=lambda r, p: flat.append(
                torch.cat([x.reshape(-1) for x in tree_flatten(p)[0]]).cpu()))
        return flat, metrics["loss"].cpu()

    a_name, b_name = args.backends.split(",")
    (pa, la), (pb, lb) = run(a_name), run(b_name)
    print(f"{spec.name}: {a_name} vs {b_name}"
          f"{' (plain versions = library products)' if args.library_plain else ''}")
    for r, (x, y) in enumerate(zip(pa, pb)):
        print(f"round {r}: max |Δparam| {(x - y).abs().max().item():.3g}, "
              f"{(x != y).sum().item()} of {x.numel()} differ; "
              f"loss {la[r].item():.6f} {lb[r].item():.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
