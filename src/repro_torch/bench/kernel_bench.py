"""Relay-kernel bench: the two CUDA kernels of ``kernels/relay_mix.py`` and
the plain version, µs a call across model sizes.

The counterpart of the JAX package's ``benchmarks/bench_relay_kernel.py``:
the same n = 16, the same draws from ``np.random.default_rng(0)`` (A standard
normal (n, n) f32; τ = ``rng.random(n) < 0.5``; then one standard-normal
(n, D) Δ a size, in order, cast to ``dtype``; c = (1/n)·τ·A) and the same
sizes (2¹⁴ and 2¹⁷, plus 2²¹ with ``full``).  Rows, per D:

* ``relay_kernel/D{D}/einsum_ref``: the plain Δ̃ = A·Δ (``kernels/ref.py``,
  the ``einsum`` backend);
* ``relay_kernel/D{D}/hopper``: ``relay_mix_2d``, the mix kernel;
* ``relay_kernel/D{D}/hopper_fused``: ``fused_aggregate_2d``, u = c·Δ.

The derived column keeps the reference's ``bytes`` (Δ read and the output
written: 2·n·D elements for the mix, (n+1)·D for the fused kernel) and
gives ``bound_us``, the least time an NVIDIA H100 could take for the call:
the larger of its bytes (the weights' included) over the card's memory rate
and its f32 operations (2n²D for the mix, 2nD for the fused kernel) over
the card's f32 rate, from NVIDIA's data sheet.  ``device`` names where the
times were taken, with the card's power limit.

On the GPU (the default) a row's time is device time: CUDA events around a
CUDA graph of back-to-back calls (:func:`device_ms`), with enough copies of
Δ that the calls cycle through more than twice the L2 cache; the kernels
run through the wrappers on CUDA tensors (a failed build or launch raises).
On the CPU (``device="cpu"``) it is the host's wall clock, and the wrappers
run their plain versions.

    PYTHONPATH=src python -m repro_torch.bench.kernel_bench [--full] \\
        [--dtype {bf16,f32}] [--device cpu]
"""
from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

from repro_torch.bench.report import device_info, device_label
from repro_torch.kernels import ref
from repro_torch.kernels import relay_mix as k
from repro_torch.utils import resolve_device

N = 16
SIZES = (1 << 14, 1 << 17)
FULL_SIZES = SIZES + (1 << 21,)
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}

# NVIDIA's H100 SXM data sheet (dense rates, 700 W): device memory
# rate and the f32 rate outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
L2_BYTES = 50e6


def device_ms(fn, arg_sets, reps: int) -> float:
    """Device time of one call, from CUDA events around a CUDA graph of
    ``reps`` back-to-back calls (no host launch gaps), cycling through
    ``arg_sets``; the best of three replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for args in arg_sets:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    torch.cuda.synchronize()
    best = math.inf
    for _ in range(3):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        graph.replay()
        e1.record()
        e1.synchronize()
        best = min(best, e0.elapsed_time(e1) / reps)
    del graph
    torch.cuda.synchronize()
    return best


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def host_us(fn, args, reps: int = 3) -> float:
    """Wall-clock µs of one call on the host, after one warm-up call."""
    fn(*args)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(*args)
    return 1e6 * (time.perf_counter() - t0) / reps


def draw_inputs(sizes, dtype: torch.dtype, device) -> tuple:
    """(A, c, [(D, Δ), ...]) drawn as the reference draws them, on ``device``."""
    rng = np.random.default_rng(0)
    A = torch.from_numpy(rng.standard_normal((N, N))).float()
    tau = torch.from_numpy(rng.random(N) < 0.5).float()
    deltas = [(D, torch.from_numpy(rng.standard_normal((N, D))).to(dtype).to(device))
              for D in sizes]
    c = (1.0 / N) * tau @ A
    return A.to(device), c.to(device), deltas


def mix_bytes(n: int, D: int, itemsize: int) -> int:
    """The reference's bytes of Δ̃ = A·Δ: Δ read and Δ̃ written."""
    return 2 * n * D * itemsize


def fused_bytes(n: int, D: int, itemsize: int) -> int:
    """The reference's bytes of u = c·Δ: Δ read and u written."""
    return (n + 1) * D * itemsize


def mix_bound_ms(n: int, D: int, itemsize: int) -> tuple[float, str]:
    return bound_ms(mix_bytes(n, D, itemsize) + 4 * n * n, 2 * n * n * D)


def fused_bound_ms(n: int, D: int, itemsize: int) -> tuple[float, str]:
    return bound_ms(fused_bytes(n, D, itemsize) + 4 * n, 2 * n * D)


def delta_copies(delta: torch.Tensor) -> list[torch.Tensor]:
    """Δ and enough copies of it that a cycle of calls reads more than twice
    the L2 cache, so each call finds its Δ in device memory."""
    copies = max(1, math.ceil(2 * L2_BYTES / (delta.numel() * delta.element_size())))
    return [delta] + [delta.clone() for _ in range(copies - 1)]


def graph_reps(delta: torch.Tensor) -> int:
    """Calls a timing graph records: fewer for the largest Δ."""
    return 40 if delta.numel() >= 10**7 else 200


def run(full: bool = False, dtype: str = "bf16", device=None) -> list[tuple[str, float, str]]:
    """Time each row at each size and print ``name,us_per_call,derived``;
    returns the rows."""
    dev = resolve_device(device)
    dt = DTYPES[dtype]
    itemsize = torch.empty((), dtype=dt).element_size()
    label = device_label(device_info(dev))
    A, c, deltas = draw_inputs(FULL_SIZES if full else SIZES, dt, dev)
    rows = []
    for D, d in deltas:
        calls = {
            "einsum_ref": (ref.relay_mix_2d, A),
            "hopper": (k.relay_mix_2d, A),
            "hopper_fused": (k.fused_aggregate_2d, c),
        }
        if dev.type == "cuda":
            ds = delta_copies(d)
            us = {name: 1e3 * device_ms(fn, [(w, x) for x in ds], graph_reps(d))
                  for name, (fn, w) in calls.items()}
            del ds
        else:
            us = {name: host_us(fn, (w, d)) for name, (fn, w) in calls.items()}
        b_mix, b_fused = mix_bytes(N, D, itemsize), fused_bytes(N, D, itemsize)
        tail = f"dtype={dtype};device={label}"
        rows += [
            (f"relay_kernel/D{D}/einsum_ref", us["einsum_ref"], f"bytes={b_mix};{tail}"),
            (f"relay_kernel/D{D}/hopper", us["hopper"],
             f"bytes={b_mix};bound_us={1e3 * mix_bound_ms(N, D, itemsize)[0]:.3f};{tail}"),
            (f"relay_kernel/D{D}/hopper_fused", us["hopper_fused"],
             f"bytes={b_fused};bound_us={1e3 * fused_bound_ms(N, D, itemsize)[0]:.3f};{tail}"),
        ]
    for name, us_call, derived in rows:
        print(f"{name},{us_call:.3f},{derived}")
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true", help="add D = 2^21")
    ap.add_argument("--dtype", default="bf16", choices=sorted(DTYPES),
                    help="Δ's dtype (default bf16, as the reference)")
    ap.add_argument("--device", default=None, help="default: the GPU")
    args = ap.parse_args(argv)
    print("name,us_per_call,derived")
    run(full=args.full, dtype=args.dtype, device=args.device)


if __name__ == "__main__":
    main()
