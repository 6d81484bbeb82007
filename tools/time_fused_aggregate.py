#!/usr/bin/env python3
"""Time builds of the fused-aggregate CUDA kernel against each other on one GPU.

    python3 tools/time_fused_aggregate.py [--parent DIR] \\
        [--variant LABEL:NAME=VALUE[,NAME=VALUE...]] [--repeat R]

Builds, all compiled at once with the port's nvcc flags into
``build/compare/``:

* ``change``: ``src/repro_torch/kernels/csrc/relay_mix.cu`` of this checkout;
* ``parent``: the same file under ``DIR``, another checkout of the repository
  (for example the parent commit, unpacked with ``git archive`` into a
  gitignored directory);
* each ``--variant``: this checkout's source with the named
  ``constexpr int`` constants set to other values (``kChunkBytes=64``).

Each build's ``fused_aggregate_2d_launch`` is timed as ``chip_smoke.py`` times
the kernels (``device_ms``: a CUDA graph of back-to-back calls, rotating over
enough Δ copies that every call reads Δ from device memory), f32, at the main
path's shape (10, 272,282) and at (8, 10⁷), beside one ``c @ Δ``.  The builds
run in turns, the order reversed every other round, ``R`` rounds; each is also
checked bitwise against ``change`` (all of them sum in the same order).  One
JSON line a shape: each build's best and median ms over the rounds, and its
time with Δ resident in L2 at the main shape.  Needs a GPU.
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

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

SOURCE = os.path.join("src", "repro_torch", "kernels", "csrc", "relay_mix.cu")
OUT_DIR = os.path.join(ROOT, "build", "compare")


def with_constants(text: str, assignments: str) -> str:
    for item in assignments.split(","):
        name, value = item.split("=")
        text, count = re.subn(rf"(constexpr int {name} = )[^;]+;", rf"\g<1>{int(value)};", text)
        if count != 1:
            raise ValueError(f"constant {name} found {count} times in {SOURCE}")
    return text


def compile_all(sources: dict[str, str]) -> dict[str, ctypes.CDLL]:
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
    libs = {}
    for label, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {label}:\n{log}")
        for kernel, line in chip_smoke.ptxas_usage(log):
            if "fused_aggregate" in kernel:
                print(f"build {label}: {kernel}: {line}")
        lib = ctypes.CDLL(os.path.join(OUT_DIR, f"lib{label}.so"))
        lib.fused_aggregate_2d_launch.argtypes = build._LAUNCHER_ARGTYPES
        lib.fused_aggregate_2d_launch.restype = ctypes.c_int
        libs[label] = lib
    return libs


def launcher(lib: ctypes.CDLL):
    def call(c, d, out):
        err = lib.fused_aggregate_2d_launch(c.data_ptr(), d.data_ptr(), out.data_ptr(),
                                            d.shape[0], d.shape[1], 0,
                                            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed with CUDA error {err}")
        return out
    return call


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="another checkout whose kernel is timed as 'parent'")
    ap.add_argument("--variant", action="append", default=[],
                    help="LABEL:NAME=VALUE[,NAME=VALUE...] on this checkout's source")
    ap.add_argument("--repeat", type=int, default=4)
    args = ap.parse_args()

    chip_smoke.phase_device()
    with open(os.path.join(ROOT, SOURCE)) as f:
        change = f.read()
    sources = {"change": change}
    if args.parent:
        with open(os.path.join(args.parent, SOURCE)) as f:
            sources = {"parent": f.read(), **sources}
    for spec in args.variant:
        label, assignments = spec.split(":", 1)
        sources[label] = with_constants(change, assignments)
    fns = {label: launcher(lib) for label, lib in compile_all(sources).items()}
    fns["c @ Δ"] = lambda c, d, out: c @ d

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for n, D in (chip_smoke.MAIN_SHAPE, chip_smoke.LARGE_SHAPE):
        copies = max(1, math.ceil(2 * chip_smoke.L2_BYTES / (4 * n * D)))
        c = torch.randn(n, generator=gen, device=dev) / math.sqrt(n)
        arg_sets = [(c, torch.randn(n, D, generator=gen, device=dev),
                     torch.empty(D, device=dev)) for _ in range(copies)]
        reps = 200 if D < 10**6 else 40
        want = fns["change"](*arg_sets[0]).clone()
        same = {label: torch.equal(fn(*arg_sets[0]), want) for label, fn in fns.items()}
        times = {label: [] for label in fns}
        order = list(fns)
        for r in range(args.repeat):
            for label in order if r % 2 == 0 else order[::-1]:
                times[label].append(chip_smoke.device_ms(fns[label], arg_sets, reps))
        row = {"shape": [n, D], "copies": copies,
               "bound_ms": chip_smoke.bound_ms(4 * (n + n * D + D), 2 * n * D)[0]}
        for label, ts in times.items():
            row[label] = {"best_ms": min(ts), "median_ms": statistics.median(ts),
                          "all_ms": ts, "bitwise_equal_change": same[label]}
            if (n, D) == chip_smoke.MAIN_SHAPE:
                row[label]["l2_resident_ms"] = chip_smoke.device_ms(fns[label], arg_sets[:1],
                                                                    reps)
        print(json.dumps(row))
        del arg_sets
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
