#!/usr/bin/env python3
"""Time builds of one relay CUDA kernel against each other on one GPU.

    python3 tools/time_fused_aggregate.py [--kernel {fused_aggregate_2d,relay_mix_2d}] \\
        [--parent DIR] [--variant LABEL:NAME=VALUE[,NAME=VALUE...]] [--repeat R]

Builds, all compiled at once with the port's nvcc flags into
``build/compare/``:

* ``change``: ``src/repro_torch/kernels/csrc/relay_mix.cu`` of this checkout;
* ``parent``: the same file under ``DIR``, another checkout of the repository
  (for example the parent commit, unpacked with ``git archive`` into a
  gitignored directory);
* each ``--variant``: this checkout's source with the named
  ``constexpr int`` constants set to other values (``kSlabUnroll=1``).

Each build's ``<kernel>_launch`` is timed as ``chip_smoke.py`` times the
kernels (``device_ms``: a CUDA graph of back-to-back calls, rotating over
enough Δ copies that every call reads Δ from device memory), f32, at the
kernel's shapes (:data:`SHAPES`), beside one PyTorch call for the same
function into the same outputs (``torch.matmul(c, Δ, out=)`` or
``torch.matmul(A, Δ, out=)``).  The builds run in turns,
the order reversed every other round, ``R`` rounds; each is also checked
bitwise against ``change`` (all of them sum in the same order).  One JSON
line a shape: each build's best and median ms over the rounds, and its time
with Δ resident in L2 at the main shape.  ptxas's registers per kernel are
printed per build.  Needs a GPU.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import re
import statistics
import subprocess
import sys
from collections.abc import Callable
from typing import NamedTuple

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

SOURCE = os.path.join("src", "repro_torch", "kernels", "csrc", "relay_mix.cu")
OUT_DIR = os.path.join(ROOT, "build", "compare")

# glm4-9b's and mixtral-8x22b's parameter counts at reduced(), the widths of
# chip_smoke.py's LM ColRel rounds
LM_WIDTHS = (1_443_072, 3_804_416)

# (n, D) a kernel is timed at: the main path's shape and (8, 10⁷); the mix
# also at mesh_corr_500's width, the two LM widths, and n = 32, 64 and 128
# at the main width (the stream path's largest n and the slab path's)
SHAPES = {
    "fused_aggregate_2d": (chip_smoke.MAIN_SHAPE, chip_smoke.LARGE_SHAPE),
    "relay_mix_2d": (chip_smoke.MAIN_SHAPE, chip_smoke.LARGE_SHAPE, chip_smoke.MESH_SHAPE,
                     *((chip_smoke.N_CLIENTS, D) for D in LM_WIDTHS),
                     *chip_smoke.MIX_WIDE_SHAPES),
}


class Kernel(NamedTuple):
    weights: Callable  # (n, generator) -> the f32 weights
    out_shape: Callable  # (n, D) -> the output's shape
    library: Callable  # (weights, Δ, out) -> one PyTorch call for the same function, into out
    bound_ms: Callable  # (n, D) -> (ms, "bytes" or "operations")


KERNELS = {
    "fused_aggregate_2d": Kernel(
        lambda n, gen: torch.randn(n, generator=gen, device=gen.device) / math.sqrt(n),
        lambda n, D: (D,),
        lambda c, d, out: torch.matmul(c, d, out=out),
        lambda n, D: chip_smoke.bound_ms(4 * (n + n * D + D), 2 * n * D)),
    "relay_mix_2d": Kernel(
        lambda n, gen: torch.randn(n, n, generator=gen, device=gen.device) / math.sqrt(n),
        lambda n, D: (n, D),
        lambda A, d, out: torch.matmul(A, d, out=out),
        lambda n, D: chip_smoke.bound_ms(4 * (n * n + 2 * n * D), 2 * n * n * D)),
}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=tuple(KERNELS), default="fused_aggregate_2d")
    ap.add_argument("--parent", help="another checkout whose kernel is timed as 'parent'")
    ap.add_argument("--variant", action="append", default=[],
                    help="LABEL:NAME=VALUE[,NAME=VALUE...] on this checkout's source")
    ap.add_argument("--repeat", type=int, default=4)
    return ap.parse_args(argv)


def with_constants(text: str, assignments: str) -> str:
    for item in assignments.split(","):
        name, value = item.split("=")
        text, count = re.subn(rf"(constexpr int {name} = )[^;]+;", rf"\g<1>{int(value)};", text)
        if count != 1:
            raise ValueError(f"constant {name} found {count} times in {SOURCE}")
    return text


def compile_all(sources: dict[str, str], kernel: str) -> dict[str, ctypes.CDLL]:
    os.makedirs(OUT_DIR, exist_ok=True)
    procs = {}
    for label, text in sources.items():
        src = os.path.join(OUT_DIR, f"{label}.cu")
        with open(src, "w") as f:
            f.write(text)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v",
               "-o", os.path.join(OUT_DIR, f"lib{label}.so"), src]
        procs[label] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True)
    family = kernel.removesuffix("_2d")  # relay_mix_* or fused_aggregate_* kernels
    libs = {}
    for label, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {label}:\n{log}")
        for name, line in chip_smoke.ptxas_usage(log):
            if family in name:
                print(f"build {label}: {name}: {line}")
        lib = ctypes.CDLL(os.path.join(OUT_DIR, f"lib{label}.so"))
        fn = getattr(lib, f"{kernel}_launch")
        fn.argtypes = build._LAUNCHER_ARGTYPES
        fn.restype = ctypes.c_int
        libs[label] = lib
    return libs


def launcher(lib: ctypes.CDLL, kernel: str):
    fn = getattr(lib, f"{kernel}_launch")

    def call(w, d, out):
        err = fn(w.data_ptr(), d.data_ptr(), out.data_ptr(), d.shape[0], d.shape[1], 0,
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed with CUDA error {err}")
        return out
    return call


def main(argv=None) -> int:
    args = parse_args(argv)
    chip_smoke.phase_device()
    spec = KERNELS[args.kernel]
    with open(os.path.join(ROOT, SOURCE)) as f:
        change = f.read()
    sources = {"change": change}
    if args.parent:
        with open(os.path.join(args.parent, SOURCE)) as f:
            sources = {"parent": f.read(), **sources}
    for item in args.variant:
        label, assignments = item.split(":", 1)
        sources[label] = with_constants(change, assignments)
    fns = {label: launcher(lib, args.kernel)
           for label, lib in compile_all(sources, args.kernel).items()}
    fns["library"] = spec.library

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for n, D in SHAPES[args.kernel]:
        copies = max(1, math.ceil(2 * chip_smoke.L2_BYTES / (4 * n * D)))
        w = spec.weights(n, gen)
        arg_sets = [(w, torch.randn(n, D, generator=gen, device=dev),
                     torch.empty(spec.out_shape(n, D), device=dev)) for _ in range(copies)]
        reps = 200 if n * D < 10**7 else 40
        want = fns["change"](*arg_sets[0]).clone()
        same = {label: torch.equal(fn(*arg_sets[0]), want) for label, fn in fns.items()}
        times = {label: [] for label in fns}
        order = list(fns)
        for r in range(args.repeat):
            for label in order if r % 2 == 0 else order[::-1]:
                times[label].append(chip_smoke.device_ms(fns[label], arg_sets, reps))
        b_ms, b_by = spec.bound_ms(n, D)
        row = {"kernel": args.kernel, "shape": [n, D], "copies": copies, "bound_ms": b_ms,
               "bound_by": b_by}
        for label, ts in times.items():
            row[label] = {"best_ms": min(ts), "median_ms": statistics.median(ts),
                          "all_ms": ts, "bitwise_equal_change": same[label]}
            if (n, D) == chip_smoke.MAIN_SHAPE:
                row[label]["l2_resident_ms"] = chip_smoke.device_ms(fns[label], arg_sets[:1],
                                                                    reps)
        print(json.dumps(row))
        del arg_sets, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
