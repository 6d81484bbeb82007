#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any error:

1. device   needs ``torch.cuda.is_available()``; prints the card's name and
            power limit; turns TF32 off for matmuls and cuDNN convolutions.
2. build    compiles the CUDA kernels from ``src/repro_torch/kernels/csrc``
            with nvcc (into ``build/torch_kernels/``) and prints the seconds.
3. kernels  holds each kernel against its plain torch version on the card
            over n × D × {f32, bf16} × {Δ contiguous, Δ a row slice whose
            base address is off 16 bytes}, checks that each case's two
            calls are bitwise equal and relay_mix_2d's backward, then times
            each kernel, its plain version and one PyTorch call for the same
            function, beside the card's bound for the work; prints the fused
            kernel's launch plan (vector bytes, grid, resident blocks an SM)
            at the main shape.
4. main     ColRel rounds of ResNet-20/GN at full width (D = 272,282) for
            n = 10 clients through ``FLSimulator``, four times on the same
            τ and batches: colrel on ``hopper`` and on ``einsum``,
            colrel_fused on ``hopper_fused`` and on ``einsum``.  Each kernel
            must launch exactly once a round on its backend, every loss must
            be finite, each kernel run must agree with its plain twin after
            all rounds, and colrel with colrel_fused after one round.
5. engines  ColRel rounds of the same model, clients and data under the
            JAX package's Fig. 6 channel at a short coherence (Markov link
            fading on ring(10, 2), piecewise-constant p drift, rotating-cohort
            churn; epochs of unequal length), A from ``AdaptiveOptAlpha``,
            through ``run_rounds_loop``, ``EpochScanEngine`` and
            ``PipelinedScanEngine`` (inline and threaded prefetch), for colrel
            on ``hopper`` and colrel_fused on ``hopper_fused``.  Gates: each
            engine bitwise equal to its loop (params, server state, per-round
            loss/τ/delta_norm, generator state); the engines' scheduler
            stats equal to each other and their solves to the loop's; each
            kernel launched once a round on its backend and never on the
            other; the pipelined engine's dispatches equal to its chunks;
            finite losses and params; a churned round whose inactive τ reads
            0.  Prints ms a round after the first chunk, the prefetch
            overlap, the epochs and the OPT-α solves.
6. bench    the bench harness (``repro_torch.bench.run_scenario``) on three
            registered scenarios at their registered size: bench_smoke (the
            MLP under Markov fading and p drift, 8-round epochs in chunks of
            8), resnet20_cifar (ResNet-20/GN, D = 272,282, with the
            ``hopper`` mix-kernel check) and relay_sweep_1e7 (the MLP at
            D = 10,013,594, with the ``hopper_fused`` kernel check); the
            reports go to ``build/bench_torch/``.  Gates: the engines
            bitwise equal to the loop; each kernel check allclose with max
            |Δ| ≤ 1e-5; model_params equal to the JAX package's recorded
            sizes; each kernel launched once a round in the kernel check's
            cold and warm passes and never by the einsum engines; finite
            losses.  Prints rounds/s and compile_s per engine, the
            pipelined engine's overlap, the kernel check and model_params.
7. sparse   the bench harness on the cohort-sampling sweeps at their
            registered sizes: sample_sweep_smoke (n = 256), _n1e3 and _n1e4
            (n = 10⁴, about 28 MB of (n, D) f32 buffer): a sparse geometric
            graph, fixed-k cohorts redrawn every round, SparseOptAlpha and
            the ``segment`` backend, whose dense reduce is the fused kernel.
            Gates: the engines bitwise equal to the loop; the einsum check
            (smoke and n1e3) allclose with max |Δ| ≤ 1e-5; the fused kernel
            launched 2 × rounds × engines times from 0 and never by the
            check's pass; finite losses.  Then fused_coefficients and
            segment_mix on the n = 10⁴ graph's EdgeRelay twice each, bitwise
            equal and within 1e-5 of a float64 index_add_.  Prints rounds/s
            per engine and the loop's round split between cohort sampling,
            the sparse OPT-α solve and the round on the card.
8. async    AsyncRoundEngine on ResNet-20/GN at full width (n = 10,
            D = 272,282) under the Fig. 6 channel with churn, colrel_fused on
            ``hopper_fused`` and on ``hopper``, 20 rounds a run.  Gates: at
            ZeroDelays bitwise equal to run_rounds_loop (params, server
            state, loss/τ/delta_norm, generator state); under Poisson(1.0)
            delays (max_delay 8) at buffer_k 0 and 4 finite; the fused
            kernel launched once a round in every run.  Prints the
            arrivals, supersessions, selections and the largest staleness.
            Then the bench harness on async_smoke: the async_check gate (the
            async engine at delay 0 bitwise equal to the loop) and the
            rounds to the target loss for every engine.  (async_ttac_500
            runs on its own: ``python -m repro_torch.bench.run --scenario
            async_ttac_500``.)

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Imports neither jax nor the JAX package.
"""
from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# main path: the README's core loop at the paper's §V model
N_CLIENTS, LOCAL_STEPS, LOCAL_BATCH, LR, ROUNDS = 10, 2, 32, 0.05, 5
N_TRAIN = 2560
RESNET20_D = 272_282
MAIN_SHAPE = (N_CLIENTS, RESNET20_D)
LARGE_SHAPE = (8, 10_000_000)  # the JAX package's relay_sweep_1e7 size
# the segment backend's dense reduce in the sample sweeps (the MLP's
# D = 698): n past the fused kernel's 1,024 shared-memory coefficients
# (kCoeffChunk), one past it, and the sweep's top
SPARSE_SHAPES = ((1_000, 698), (1_025, 698), (10_000, 698))

# kernel sweep and tolerances: f32 atol 1e-5 + rtol 1e-5 (sum order differs);
# bf16 one bf16 ulp of the output (rtol 2^-7) + the same f32 atol.  Besides
# the main path's shape: D below one vector (1, 3) and odd (4,097, D + 1);
# n across the fused kernel's origin chunks (6, 12 and 24 origins for 16-,
# 8- and 4- or 2-byte loads; 16 for a chunk of 16)
SWEEP_N = (1, 7, 10, 12, 13, 15, 16, 17, 24, 25, 64, 128, 300)
SWEEP_D = (1, 3, 100, 4097, 5000, RESNET20_D, RESNET20_D + 1)
ATOL, RTOL_F32, RTOL_BF16 = 1e-5, 1e-5, 2.0**-7
PARAM_ATOL = LOSS_ATOL = 1e-4  # a kernel run against its plain twin, 5 rounds

# engines phase: the Fig. 6 channel at a coherence of a few rounds, so that
# 20 rounds cross epochs of unequal length and chunk 4 leaves remainders
ENGINE_ROUNDS, ENGINE_CHUNK = 20, 4

# bench phase: the registered scenarios it runs, and the model sizes the
# JAX package recorded for them (BENCH_resnet20_cifar.json,
# BENCH_relay_sweep_1e7.json)
BENCH_SCENARIOS = ("bench_smoke", "resnet20_cifar", "relay_sweep_1e7")
BENCH_MODEL_PARAMS = {"resnet20_cifar": 272_282, "relay_sweep_1e7": 10_013_594}
BENCH_KERNEL = {"hopper": "relay_mix_2d", "hopper_fused": "fused_aggregate_2d"}

# sparse phase: the sample sweeps at their registered sizes, the segment
# ops' and the einsum check's tolerance, and the rounds of the loop's
# host/device split
SPARSE_SCENARIOS = ("sample_sweep_smoke", "sample_sweep_n1e3", "sample_sweep_n1e4")
SPARSE_CHECK_ATOL = 1e-5
SPLIT_ROUNDS = 8

# async phase: rounds of each AsyncRoundEngine run on ResNet-20/GN, and the
# async bench scenario.  async_ttac_500 (500 rounds through four engine
# passes, about 40 s on the card) runs on its own through
# `python -m repro_torch.bench.run --scenario async_ttac_500`, which keeps
# this script near three minutes
ASYNC_ROUNDS = 20
ASYNC_SCENARIOS = ("async_smoke",)

# NVIDIA's H100 SXM data sheet (dense rates, 700 W): device memory
# rate and the f32 rate outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
L2_BYTES = 50e6


def fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke: {msg}")


def check_close(name, got, want, rtol) -> float:
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        fail(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    err = (got - want).abs()
    bad = err > ATOL + rtol * want.abs()
    if bool(bad.any()) or not bool(torch.isfinite(got).all()):
        fail(f"{name}: max |Δ| {err.max().item():.3g} outside atol {ATOL} rtol {rtol:.3g}")
    return err.max().item()


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


def phase_device() -> str:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)  # the card's name and power limit, as nvidia-smi gives them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    print("settings: TF32 off for matmul and cuDNN (full f32); cuDNN deterministic")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    return smi


def ptxas_usage(log: str) -> list[tuple[str, str]]:
    """(kernel, what ptxas -v says of it): registers, shared memory, and
    spills where there are any."""
    rows, kernel = [], "?"
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            kernel = m.group(1)
        spills = "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line
        if "registers" in line or spills:
            rows.append((kernel, line.split(":", 1)[-1].strip()))
    return rows


def phase_build() -> None:
    from repro_torch.kernels import build

    res = build.build(verbose=True)
    print(f"build: {res.seconds:.2f} s nvcc -> {os.path.relpath(res.path, ROOT)}")
    for kernel, line in ptxas_usage(res.log):
        print(f"  ptxas {kernel}: {line}")


def phase_kernels() -> dict:
    from repro_torch.kernels import ref
    from repro_torch.kernels import relay_mix as k

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    worst = {("mix", "f32"): 0.0, ("mix", "bf16"): 0.0,
             ("fused", "f32"): 0.0, ("fused", "bf16"): 0.0}
    main_err = {}
    cases = 0
    # information, not a gate: f32 cases bitwise equal to the plain version
    # (the kernels' order) and to the library product (cuBLAS's order)
    same = {"plain": 0, "library": 0, "f32 cases": 0}
    for n in SWEEP_N:
        for D in SWEEP_D:
            A = torch.randn(n, n, generator=gen, device=dev) / math.sqrt(n)
            c = torch.randn(n, generator=gen, device=dev) / math.sqrt(n)
            big32 = torch.randn(n + 1, D, generator=gen, device=dev)
            for tag, dt, rtol in (("f32", torch.float32, RTOL_F32),
                                  ("bf16", torch.bfloat16, RTOL_BF16)):
                big = big32.to(dt)
                # Δ contiguous, and a row slice of an (n + 1, D) buffer: also
                # contiguous, its base a row pitch further (off 16 bytes
                # unless 16 divides the pitch)
                for layout, d in (("", big[:n]), (" row slice", big[1:])):
                    name = f"n={n} D={D} {tag}{layout}"
                    m = k.relay_mix_2d(A, d)
                    e_mix = check_close(f"relay_mix_2d {name}", m,
                                        ref.relay_mix_2d(A.to(dt), d), rtol)
                    u = k.fused_aggregate_2d(c, d)
                    e_fused = check_close(f"fused_aggregate_2d {name}", u,
                                          ref.fused_aggregate_2d(c.to(dt), d), rtol)
                    # no atomics: a second call is bitwise equal
                    if not (torch.equal(k.relay_mix_2d(A, d), m)
                            and torch.equal(k.fused_aggregate_2d(c, d), u)):
                        fail(f"{name}: two calls of a kernel differ")
                    if tag == "f32":
                        same["f32 cases"] += 2
                        same["plain"] += (torch.equal(m, ref.relay_mix_2d(A, d))
                                          + torch.equal(u, ref.fused_aggregate_2d(c, d)))
                        same["library"] += torch.equal(m, A @ d) + torch.equal(u, c @ d)
                    worst["mix", tag] = max(worst["mix", tag], e_mix)
                    worst["fused", tag] = max(worst["fused", tag], e_fused)
                    if (n, D) == MAIN_SHAPE and tag == "f32" and not layout:
                        main_err = {"mix": e_mix, "fused": e_fused}
                    cases += 2
    torch.cuda.synchronize()
    print(f"kernels: {cases} cases within tolerance, each call bitwise repeatable; max |Δ| "
          + ", ".join(f"{a} {b} {v:.3g}" for (a, b), v in worst.items()))
    print(f"kernels: bitwise equal to the plain version in {same['plain']} and to the "
          f"library product in {same['library']} of {same['f32 cases']} f32 cases")

    # backward of the mix: (dA, dΔ) against autograd through the library
    # product.  Not through the plain version: its autograd reduces
    # dA = g·Δᵀ over D in the order of its addcmul chain's backward, where
    # the wrapper's dA is one f32 product, and two sums of 272,282 terms in
    # different orders part by more than the tolerance
    for n, D in ((5, 700), MAIN_SHAPE):
        A = torch.randn(n, n, generator=gen, device=dev) / math.sqrt(n)
        d = torch.randn(n, D, generator=gen, device=dev)
        cot = torch.randn(n, D, generator=gen, device=dev)
        grads = []
        for fn in (k.relay_mix_2d, torch.matmul):
            A_ = A.clone().requires_grad_(True)
            d_ = d.clone().requires_grad_(True)
            (fn(A_, d_) * cot).sum().backward()
            grads.append((A_.grad, d_.grad))
        check_close(f"relay_mix_2d dA n={n} D={D}", grads[0][0], grads[1][0], RTOL_F32)
        check_close(f"relay_mix_2d dΔ n={n} D={D}", grads[0][1], grads[1][1], RTOL_F32)
    print("kernels: relay_mix_2d backward (dA, dΔ) matches autograd through A @ Δ")

    # times: kernel, plain version, one PyTorch call; f32 as on the main path
    timing = {"relay_mix_2d": {}, "fused_aggregate_2d": {}}
    for label, (n, D) in (("main", MAIN_SHAPE), ("large", LARGE_SHAPE)):
        # rotate over enough Δ copies that the working set exceeds 2× L2,
        # so each call finds Δ in device memory, as the round does
        copies = max(1, math.ceil(2 * L2_BYTES / (4 * n * D)))
        A = torch.randn(n, n, generator=gen, device=dev) / math.sqrt(n)
        c = torch.randn(n, generator=gen, device=dev) / math.sqrt(n)
        ds = [torch.randn(n, D, generator=gen, device=dev) for _ in range(copies)]
        reps = 200 if label == "main" else 40
        mix_args = [(A, d) for d in ds]
        fused_args = [(c, d) for d in ds]
        rows = {
            "relay_mix_2d": (
                (k.relay_mix_2d, lambda A_, d_: ref.relay_mix_2d(A_.to(d_.dtype), d_),
                 torch.matmul), mix_args,
                bound_ms(4 * (n * n + 2 * n * D), 2 * n * n * D)),
            "fused_aggregate_2d": (
                (k.fused_aggregate_2d,
                 lambda c_, d_: ref.fused_aggregate_2d(c_.to(d_.dtype), d_),
                 lambda c_, d_: c_ @ d_), fused_args,
                bound_ms(4 * (n + n * D + D), 2 * n * D)),
        }
        for name, ((kern, plain, lib), args, (b_ms, b_by)) in rows.items():
            t = {
                "shape": [n, D],
                "ms": device_ms(kern, args, reps),
                "plain_ms": device_ms(plain, args, reps),
                "library_ms": device_ms(lib, args, reps),
                "bound_ms": b_ms,
                "bound_by": b_by,
            }
            if label == "main":
                t["ms_l2_resident"] = device_ms(kern, args[:1], reps)
            if name == "fused_aggregate_2d":
                t["plan"] = {"f32": k.fused_aggregate_plan(ds[0]),
                             "bf16": k.fused_aggregate_plan(ds[0].to(torch.bfloat16))}
                # information, not a gate: cuBLAS sums in another order
                t["bitwise_equal_c_at_delta"] = torch.equal(
                    k.fused_aggregate_2d(c, ds[0]), c @ ds[0])
            timing[name][label] = t
            print(f"time {name} {label} (n={n}, D={D}, {copies} Δ copies): "
                  + json.dumps({key: v for key, v in t.items() if key != "shape"}))
        del ds, mix_args, fused_args
        torch.cuda.empty_cache()

    # the fused kernel at the segment backend's shapes: bitwise equal to the
    # plain version (the same ascending fmaf chain) and repeatable, then
    # timed beside c @ Δ and the bound
    timing["fused_aggregate_2d"]["sparse"] = []
    for n, D in SPARSE_SHAPES:
        c = torch.randn(n, generator=gen, device=dev) / math.sqrt(n)
        d32 = torch.randn(n, D, generator=gen, device=dev)
        for tag, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            d = d32.to(dt)
            u = k.fused_aggregate_2d(c, d)
            if not torch.equal(u, ref.fused_aggregate_2d(c.to(dt), d)):
                fail(f"fused_aggregate_2d n={n} D={D} {tag}: not bitwise equal to the plain version")
            if not torch.equal(k.fused_aggregate_2d(c, d), u):
                fail(f"fused_aggregate_2d n={n} D={D} {tag}: two calls differ")
        copies = max(1, math.ceil(2 * L2_BYTES / (4 * n * D)))
        ds = [torch.randn(n, D, generator=gen, device=dev) for _ in range(copies)]
        args = [(c, d) for d in ds]
        b_ms, b_by = bound_ms(4 * (n + n * D + D), 2 * n * D)
        t = {
            "shape": [n, D],
            "ms": device_ms(k.fused_aggregate_2d, args, 200),
            # n launches a call: a few calls a graph
            "plain_ms": device_ms(lambda c_, d_: ref.fused_aggregate_2d(c_, d_), args,
                                  max(1, 4000 // n)),
            "library_ms": device_ms(lambda c_, d_: c_ @ d_, args, 200),
            "bound_ms": b_ms,
            "bound_by": b_by,
            "plan": k.fused_aggregate_plan(ds[0]),
        }
        timing["fused_aggregate_2d"]["sparse"].append(t)
        print(f"time fused_aggregate_2d sparse (n={n}, D={D}, {copies} Δ copies; f32 and "
              f"bf16 bitwise equal to the plain version): "
              + json.dumps({key: v for key, v in t.items() if key != "shape"}))
        del ds, args
    torch.cuda.empty_cache()
    return {"worst": worst, "main_err": main_err, "timing": timing}


def profile_round(sim, params, state, batch, lr) -> None:
    """One more round under torch.profiler: device busy share and the
    kernels that take the device time (after the counted runs, so its
    launches count nowhere)."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.run_round(gen, params, state, batch, lr)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if device_ms == 0.0:
        print("profile: the profiler recorded no device time (not measured)")
        return
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    print(f"profile colrel_fused/hopper_fused round: wall {wall_ms:.3f} ms (profiled), "
          f"device busy {device_ms:.3f} ms ({100 * device_ms / wall_ms:.1f}%), "
          f"{sum(e.count for e in kernels)} kernel launches")
    for e in top:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:5d}x  {e.key[:90]}")


def phase_main() -> dict:
    import numpy as np

    from repro_torch.configs.resnet20_cifar import CONFIG
    from repro_torch.core import connectivity, opt_alpha, topology
    from repro_torch.data.loader import FederatedLoader
    from repro_torch.data.partition import iid_partition
    from repro_torch.data.synthetic import cifar_like
    from repro_torch.fl.simulator import FLSimulator
    from repro_torch.kernels import relay_mix as k
    from repro_torch.models.resnet import init_resnet20, resnet20_loss
    from repro_torch.utils import tree_flatten, tree_size

    p = connectivity.paper_heterogeneous().p
    adj = topology.ring(N_CLIENTS, k=1)
    opt = opt_alpha.optimize(p, adj, sweeps=50)
    print(f"OPT-α: S {opt.S_history[0]:.4f} -> {opt.S_history[-1]:.4f} in {opt.sweeps} sweeps")
    ds = cifar_like(N_TRAIN, seed=0)
    parts = iid_partition(ds, N_CLIENTS, seed=0)

    def loss_fn(params, batch):
        return resnet20_loss(params, CONFIG, batch)

    runs = {}
    for strategy, backend in (("colrel", "hopper"), ("colrel", "einsum"),
                              ("colrel_fused", "hopper_fused"),
                              ("colrel_fused", "einsum")):
        sim = FLSimulator(loss_fn, n_clients=N_CLIENTS, strategy=strategy, A=opt.A, p=p,
                          local_steps=LOCAL_STEPS, relay_backend=backend)
        loader = FederatedLoader(ds, parts, seed=0)
        params = init_resnet20(0, CONFIG)
        if tree_size(params) != RESNET20_D:
            fail(f"ResNet-20 has {tree_size(params)} parameters, expected {RESNET20_D}")
        state = sim.init_server_state(params)
        gen = torch.Generator(device="cuda").manual_seed(42)
        batches = [loader.round_batch(LOCAL_STEPS, LOCAL_BATCH) for _ in range(ROUNDS)]
        losses, taus, round_ms = [], [], []
        k.reset_launches()
        for r in range(ROUNDS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, m = sim.run_round(gen, params, state, batches[r], LR)
            torch.cuda.synchronize()
            round_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(m["loss"]))
            taus.append(m["tau"].tolist())
            if r == 0:
                leaves_r1 = [x.clone() for x in tree_flatten(params)[0]]
        launches = dict(k.LAUNCHES)
        tag = f"{strategy}/{backend}"
        print(f"main {tag}: round ms {[round(x, 3) for x in round_ms]} "
              f"losses {losses} launches {launches}")
        if not all(math.isfinite(x) for x in losses):
            fail(f"{tag}: non-finite loss {losses}")
        want = {"relay_mix_2d": ROUNDS if backend == "hopper" else 0,
                "fused_aggregate_2d": ROUNDS if backend == "hopper_fused" else 0}
        if launches != want:
            fail(f"{tag}: kernel launches {launches}, expected {want}")
        leaves = tree_flatten(params)[0]
        if not all(bool(torch.isfinite(x).all()) for x in leaves):
            fail(f"{tag}: non-finite parameters")
        runs[tag] = {"losses": losses, "taus": taus, "leaves": leaves,
                     "leaves_r1": leaves_r1, "round_ms": round_ms, "launches": launches}
        if tag == "colrel_fused/hopper_fused":
            profile_round(sim, params, state, batches[0], LR)

    def diff(a, b, key):
        return max((x - y).abs().max().item() for x, y in zip(runs[a][key], runs[b][key]))

    # each kernel run against the same strategy on plain torch, through all
    # rounds: the kernels must not move the trajectory
    for tag, ref_tag in (("colrel/hopper", "colrel/einsum"),
                         ("colrel_fused/hopper_fused", "colrel_fused/einsum")):
        if runs[tag]["taus"] != runs[ref_tag]["taus"]:
            fail(f"{tag}: τ stream differs from {ref_tag}")
        dl = float(np.max(np.abs(np.subtract(runs[tag]["losses"], runs[ref_tag]["losses"]))))
        dp = diff(tag, ref_tag, "leaves")
        print(f"main {tag} vs {ref_tag}: max |Δloss| {dl:.3g}, max |Δparam| {dp:.3g} "
              f"after {ROUNDS} rounds")
        if dl > LOSS_ATOL or dp > PARAM_ATOL:
            fail(f"{tag} disagrees with {ref_tag}: |Δloss| {dl} |Δparam| {dp}")
    # colrel and colrel_fused are the same increment summed in another order
    # ((w·τᵀ)(AΔ) vs (w·τᵀA)Δ): one round from the same start agrees to the
    # kernel tolerance; the trajectories then drift apart as training
    # amplifies the last-bit difference (reported, not asserted)
    d1 = diff("colrel/hopper", "colrel_fused/hopper_fused", "leaves_r1")
    dend = diff("colrel/hopper", "colrel_fused/hopper_fused", "leaves")
    print(f"main colrel vs colrel_fused: max |Δparam| {d1:.3g} after 1 round, "
          f"{dend:.3g} after {ROUNDS}")
    if d1 > ATOL:
        fail(f"colrel and colrel_fused differ by {d1} after one round")
    return runs


def _leaves(tree) -> list:
    from repro_torch.utils import tree_flatten

    return [] if tree is None else tree_flatten(tree)[0]


def _bitwise_equal(a, b) -> bool:
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def fig6_schedule():
    """The JAX package's fig6 channel (bench/scenarios.py, seed 0 + 7) with
    adj_every 6, p_every 8 and cohorts held 6 rounds: Markov link fading on
    ring(10, 2), piecewise-constant p drift, rotating-cohort churn."""
    from repro_torch import channels
    from repro_torch.core import connectivity, topology

    p0 = connectivity.paper_heterogeneous().p
    link = channels.MarkovLinkProcess(topology.ring(N_CLIENTS, 2), p_up_to_down=0.3,
                                      p_down_to_up=0.5, seed=7)
    drift = channels.PiecewiseConstantDrift(p0, hold=1, low=0.1, high=0.9, seed=8)
    member = channels.RotatingCohorts(N_CLIENTS, n_cohorts=5, hold=6)
    return channels.ChurnSchedule(membership=member, link_process=link, p_process=drift,
                                  adj_every=6, p_every=8)


def phase_engines() -> dict:
    """The loop and the three engine runs on each kernel backend under a
    churned, fading, drifting channel; see the module docstring for the
    gates.  Returns each kernel's launches summed over its four runs."""
    import numpy as np

    from repro_torch import channels
    from repro_torch.configs.resnet20_cifar import CONFIG
    from repro_torch.core.aggregation import ServerOpt
    from repro_torch.data.loader import FederatedLoader
    from repro_torch.data.partition import iid_partition
    from repro_torch.data.synthetic import cifar_like
    from repro_torch.fl.engine import EpochScanEngine, PipelinedScanEngine, run_rounds_loop
    from repro_torch.fl.simulator import FLSimulator
    from repro_torch.kernels import relay_mix as k
    from repro_torch.models.resnet import init_resnet20, resnet20_loss

    schedule = fig6_schedule
    segs = list(schedule().segments(ENGINE_ROUNDS))
    lengths = [s.n_rounds for s in segs]
    chunks = sum(math.ceil(n / ENGINE_CHUNK) for n in lengths)
    print(f"engines: {len(segs)} epochs of lengths {lengths} in {ENGINE_ROUNDS} rounds, "
          f"{chunks} chunks of at most {ENGINE_CHUNK}")
    if len(segs) < 3 or all(n % ENGINE_CHUNK == 0 for n in lengths):
        fail(f"engines: epochs {lengths} give no multi-epoch run with remainder chunks")
    ds = cifar_like(N_TRAIN, seed=0)
    parts = iid_partition(ds, N_CLIENTS, seed=0)

    def loss_fn(params, batch):
        return resnet20_loss(params, CONFIG, batch)

    launches_total = {}
    for strategy, backend, kernel in (("colrel", "hopper", "relay_mix_2d"),
                                      ("colrel_fused", "hopper_fused", "fused_aggregate_2d")):
        runs = {}
        for engine in ("loop", "scan", "pipelined_inline", "pipelined_thread"):
            # a fresh schedule, policy, loader, generator and model a run
            sim = FLSimulator(loss_fn, n_clients=N_CLIENTS, strategy=strategy,
                              local_steps=LOCAL_STEPS, relay_backend=backend,
                              server_opt=ServerOpt(momentum=0.5))
            # an event after every round (no sync): device timestamps for the
            # first chunk's end
            events, round_math = [], sim.round_math

            def timed_round_math(*args, _f=round_math, _ev=events):
                res = _f(*args)
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                _ev.append(ev)
                return res

            sim.round_math = timed_round_math
            policy = channels.AdaptiveOptAlpha(sweeps=40, warm_sweeps=12)
            loader = FederatedLoader(ds, parts, seed=0)
            params = init_resnet20(0, CONFIG)
            state = sim.init_server_state(params)
            gen = torch.Generator(device="cuda").manual_seed(42)
            kw = dict(schedule=schedule(), rounds=ENGINE_ROUNDS, policy=policy, lr=LR,
                      next_batch=lambda: loader.round_batch(LOCAL_STEPS, LOCAL_BATCH))
            eng = None
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            k.reset_launches()
            t0 = time.perf_counter()
            start.record()
            if engine == "loop":
                res = run_rounds_loop(sim, gen, params, state, **kw)
            elif engine == "scan":
                res = EpochScanEngine(sim, chunk=ENGINE_CHUNK).run_schedule(gen, params, state, **kw)
            else:
                eng = PipelinedScanEngine(sim, chunk=ENGINE_CHUNK,
                                          prefetch=engine.removeprefix("pipelined_"))
                res = eng.run_schedule(gen, params, state, **kw)
            torch.cuda.synchronize()
            total_ms = (time.perf_counter() - t0) * 1e3
            launches = dict(k.LAUNCHES)
            params, state, metrics, gen = res
            first_ms = start.elapsed_time(events[ENGINE_CHUNK - 1])
            tag = f"{strategy}/{backend} {engine}"
            run = {"params": params, "state": state, "metrics": metrics,
                   "gen": gen.get_state(), "stats": policy.stats, "launches": launches}
            ms_a_round = (total_ms - first_ms) / (ENGINE_ROUNDS - ENGINE_CHUNK)
            line = (f"engines {tag}: {ms_a_round:.3f} ms a round "
                    f"after the first chunk ({total_ms:.3f} ms in all, first chunk "
                    f"{first_ms:.3f} ms); OPT-α solves {policy.stats.solves}, cache hits "
                    f"{policy.stats.cache_hits}; launches {launches}")
            if eng is not None:
                st = eng.prefetch_stats
                # host staging a chunk after the pipeline fill, and the part
                # of it the consumer waited for
                steady = max(st.chunks - 1, 1)
                staging_ms = (st.prep_s - st.first_prep_s) * 1e3 / steady
                exposed_ms = (st.wait_s - st.first_wait_s) * 1e3 / steady
                line += (f"; dispatches {eng.dispatches}; overlap_fraction "
                         f"{st.overlap_fraction:.4f} (steady {st.steady_overlap_fraction:.4f}); "
                         f"staging {staging_ms:.3f} ms a chunk after the first, "
                         f"{exposed_ms:.3f} ms of it exposed")
                if eng.dispatches != chunks:
                    fail(f"{tag}: {eng.dispatches} dispatches for {chunks} chunks")
            print(line)
            want = {name: ENGINE_ROUNDS if name == kernel else 0 for name in launches}
            if launches != want:
                fail(f"{tag}: kernel launches {launches}, expected {want}")
            losses = metrics["loss"]
            if tuple(losses.shape) != (ENGINE_ROUNDS,) or not bool(torch.isfinite(losses).all()):
                fail(f"{tag}: losses {losses.tolist()} not {ENGINE_ROUNDS} finite values")
            if not all(bool(torch.isfinite(x).all()) for x in _leaves(params)):
                fail(f"{tag}: non-finite parameters")
            runs[engine] = run

        loop = runs["loop"]
        for engine, run in runs.items():
            if engine == "loop":
                continue
            tag = f"{strategy}/{backend} {engine}"
            for part in ("params", "state", "metrics"):
                if not _bitwise_equal(run[part], loop[part]):
                    fail(f"{tag}: {part} differ from the loop's")
            if not torch.equal(run["gen"], loop["gen"]):
                fail(f"{tag}: generator state differs from the loop's")
            # the loop asks the policy every round, the engines once a
            # segment: the same solves, and the loop's extra calls are hits
            ls, es = loop["stats"], run["stats"]
            if es != runs["scan"]["stats"]:
                fail(f"{tag}: scheduler stats {es} != the epoch engine's {runs['scan']['stats']}")
            if ((es.solves, es.warm_solves, es.sweeps_total, es.cache_misses)
                    != (ls.solves, ls.warm_solves, ls.sweeps_total, ls.cache_misses)
                    or ls.cache_hits - es.cache_hits != ENGINE_ROUNDS - len(segs)):
                fail(f"{tag}: scheduler stats {es} do not match the loop's {ls}")
        print(f"engines {strategy}/{backend}: scan, pipelined inline and pipelined thread "
              f"bitwise equal to the loop (params, server state, loss/τ/delta_norm, "
              f"generator state); scheduler stats {runs['scan']['stats']}")
        # churn: a round with an inactive client reports its τ as 0
        churned = [(s.round, s.active) for seg in segs for s in seg.states
                   if s.active is not None and not s.active.all()]
        if not churned:
            fail("engines: no round had an inactive client")
        tau = loop["metrics"]["tau"].cpu().numpy()
        for r, active in churned:
            if np.any(tau[r][~active] != 0):
                fail(f"engines {strategy}: round {r} reports τ {tau[r]} for inactive clients")
        launches_total[kernel] = sum(run["launches"][kernel] for run in runs.values())
    print(f"engines: {len(churned)} of {ENGINE_ROUNDS} rounds churned; inactive τ reported 0")
    return launches_total


def phase_bench() -> dict:
    """The bench harness on each of ``BENCH_SCENARIOS``; see the module
    docstring for the gates.  Returns each kernel's launches over the
    phase."""
    from repro_torch.bench import harness, report, scenarios
    from repro_torch.kernels import relay_mix as k

    out_dir = os.path.join(ROOT, "build", "bench_torch")
    totals = dict.fromkeys(k.LAUNCHES, 0)
    for name in BENCH_SCENARIOS:
        spec = scenarios.get_scenario(name)
        t0 = time.perf_counter()
        k.reset_launches()
        result = harness.run_scenario(spec)
        launches = dict(k.LAUNCHES)
        seconds = time.perf_counter() - t0
        rep = report.make_report(spec, result)
        path = report.write_report(rep, out_dir)
        runs, check = result["runs"], result["kernel_check"]
        if result["bitwise_match"] is not True:
            fail(f"bench {name}: bitwise_match {result['bitwise_match']}")
        kernel = BENCH_KERNEL.get(spec.check_backend)
        none = dict.fromkeys(launches, 0)
        want = {kn: 2 * spec.rounds if kn == kernel else 0 for kn in launches}
        if launches != want:
            fail(f"bench {name}: kernel launches {launches}, expected {want}")
        for engine, run in runs.items():
            if run.kernel_launches != (want if engine.startswith("scan_") else none):
                fail(f"bench {name} {engine}: kernel launches {run.kernel_launches}")
            if not all(math.isfinite(x) for x in run.losses):
                fail(f"bench {name} {engine}: non-finite loss {run.losses}")
        if kernel is not None and not (check and check["allclose"]
                                       and check["max_abs_diff"] <= harness.KERNEL_CHECK_ATOL):
            fail(f"bench {name}: kernel check {check}")
        if name in BENCH_MODEL_PARAMS and result["model_params"] != BENCH_MODEL_PARAMS[name]:
            fail(f"bench {name}: model_params {result['model_params']}, "
                 f"expected {BENCH_MODEL_PARAMS[name]}")
        engines = "; ".join(
            f"{e} {r.rounds_per_sec:.3f} rounds/s compile_s {r.compile_s:.3f}"
            + ("" if r.overlap_fraction is None else
               f" overlap {r.overlap_fraction:.4f} (steady {r.steady_overlap_fraction:.4f})")
            for e, r in runs.items())
        kc = ("no kernel check" if check is None else
              f"kernel_check {check['backend']} max_abs_diff {check['max_abs_diff']:.3g}")
        print(f"bench {name} ({spec.rounds} rounds, n={spec.n_clients}, {seconds:.1f} s on "
              f"{rep['device']['name']} at {rep['device']['power_limit_w']} W): {engines}; "
              f"{kc}; model_params {result['model_params']}; launches {launches}; "
              f"bitwise_match True; report {os.path.relpath(path, ROOT)}")
        for kn in totals:
            totals[kn] += launches[kn]
    return totals


def _split_rounds(bundle, rounds: int) -> dict:
    """The loop's round split between host and device, over ``rounds``
    rounds after one warm-up: host seconds drawing the cohort (the
    schedule's step) and solving sparse OPT-α (the policy), and the seconds
    from the round's launch until ``torch.cuda.synchronize()`` returns
    (staging the batch and the relay operand, the launches and the device
    work)."""
    spec = bundle.spec
    sim = bundle.make_sim()
    schedule, policy, loader = bundle.make_schedule(), bundle.make_policy(), bundle.make_loader()
    params = bundle.init_fn(spec.seed)
    state = sim.init_server_state(params)
    gen = torch.Generator(device=sim.device).manual_seed(spec.seed + 1)
    it = schedule.rounds(rounds + 1)
    split = {"sample_s": 0.0, "solve_s": 0.0, "round_s": 0.0}
    for r in range(rounds + 1):
        t0 = time.perf_counter()
        st = next(it)
        t1 = time.perf_counter()
        A = policy.relay_matrix(st)
        t2 = time.perf_counter()
        batch = loader.round_batch(spec.local_steps, spec.local_batch)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        params, state, m = sim.run_round(gen, params, state, batch, spec.lr, A=A, p=st.p,
                                         active=st.active)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        if r:  # the first round warms the caches and is left out
            split["sample_s"] += t1 - t0
            split["solve_s"] += t2 - t1
            split["round_s"] += t4 - t3
    return {key: v / rounds * 1e3 for key, v in split.items()}


def phase_sparse() -> dict:
    """The sample sweeps through the bench harness (the segment backend,
    sparse OPT-α and cohort sampling at their registered sizes), the segment
    ops' determinism at n = 10⁴, and the loop's host/device split; see the
    module docstring for the gates.  Returns each kernel's launches over
    the phase."""
    from repro_torch.bench import harness, report, scenarios
    from repro_torch.core import relay as relay_lib
    from repro_torch.kernels import relay_mix as k

    out_dir = os.path.join(ROOT, "build", "bench_torch")
    totals = dict.fromkeys(k.LAUNCHES, 0)
    for name in SPARSE_SCENARIOS:
        spec = scenarios.get_scenario(name)
        t0 = time.perf_counter()
        k.reset_launches()
        result = harness.run_scenario(spec)
        launches = dict(k.LAUNCHES)
        seconds = time.perf_counter() - t0
        rep = report.make_report(spec, result)
        path = report.write_report(rep, out_dir)
        runs, check = result["runs"], result["kernel_check"]
        if result["bitwise_match"] is not True:
            fail(f"sparse {name}: bitwise_match {result['bitwise_match']}")
        # segment's reduce is the fused kernel: once a round in the cold and
        # warm pass of every engine; the einsum check's pass launches none
        per_run = {"relay_mix_2d": 0, "fused_aggregate_2d": 2 * spec.rounds}
        want = {"relay_mix_2d": 0,
                "fused_aggregate_2d": 2 * spec.rounds * len(spec.engines)}
        if launches != want:
            fail(f"sparse {name}: kernel launches {launches}, expected {want}")
        for engine, run in runs.items():
            expect = dict.fromkeys(per_run, 0) if engine.startswith("scan_") else per_run
            if run.kernel_launches != expect:
                fail(f"sparse {name} {engine}: kernel launches {run.kernel_launches}")
            if not all(math.isfinite(x) for x in run.losses):
                fail(f"sparse {name} {engine}: non-finite loss {run.losses}")
        if spec.check_backend != "none" and not (
                check and check["allclose"] and check["max_abs_diff"] <= SPARSE_CHECK_ATOL):
            fail(f"sparse {name}: einsum check {check}")
        bundle = scenarios.build(spec)
        split = _split_rounds(bundle, SPLIT_ROUNDS)
        engines = "; ".join(f"{e} {r.rounds_per_sec:.3f} rounds/s compile_s {r.compile_s:.3f}"
                            for e, r in runs.items())
        kc = ("no einsum check" if check is None else
              f"einsum check max_abs_diff {check['max_abs_diff']:.3g}")
        print(f"sparse {name} ({spec.rounds} rounds, n={spec.n_clients}, k={spec.sample_k}, "
              f"{seconds:.1f} s on {rep['device']['name']} at "
              f"{rep['device']['power_limit_w']} W): {engines}; {kc}; launches {launches}; "
              f"bitwise_match True; report {os.path.relpath(path, ROOT)}")
        print(f"sparse {name} loop round split over {SPLIT_ROUNDS} warm rounds (ms a round): "
              f"cohort sampling {split['sample_s']:.3f}, sparse OPT-α solve "
              f"{split['solve_s']:.3f}, round launch to synchronize {split['round_s']:.3f}")
        for kn in totals:
            totals[kn] += launches[kn]

    # the segment ops on the n = 10⁴ graph's first EdgeRelay: two calls give
    # the same bits, and both agree with a float64 index_add_ reference
    bundle = scenarios.build(scenarios.get_scenario(SPARSE_SCENARIOS[-1]))
    dev = bundle.device
    st = next(bundle.make_schedule().rounds(1))
    er = relay_lib.as_relay_operand(bundle.make_policy().relay_matrix(st),
                                    n=st.p.shape[0], backend="segment", device=dev)
    n, E = st.p.shape[0], er.rows.shape[0]
    gen = torch.Generator(device=dev).manual_seed(1)
    tau = torch.bernoulli(torch.full((n,), 0.5, device=dev), generator=gen)
    buf = torch.randn(n, 698, generator=gen, device=dev)
    rows, cols = er.rows.long(), er.cols.long()
    c64 = torch.zeros(n, dtype=torch.float64, device=dev).index_add_(
        0, cols, tau.double()[rows] * er.vals.double())
    mix64 = torch.zeros(n, 698, dtype=torch.float64, device=dev).index_add_(
        0, rows, er.vals.double()[:, None] * buf.double()[cols])
    for label, fn, want64 in (("fused_coefficients", lambda: relay_lib.fused_coefficients(er, tau),
                               c64),
                              ("segment_mix", lambda: relay_lib.segment_mix(er, buf), mix64)):
        a, b = fn(), fn()
        if not torch.equal(a, b):
            fail(f"sparse {label} at n={n}: two calls differ")
        err = (a.double() - want64).abs().max().item()
        if err > SPARSE_CHECK_ATOL:
            fail(f"sparse {label} at n={n}: max |Δ| {err:.3g} against float64 index_add_")
        print(f"sparse {label} at n={n}, E={E}, W={er.layout.by_row.shape[1]} (rows) / "
              f"{er.layout.by_col.shape[1]} (cols): two calls bitwise equal; max |Δ| "
              f"{err:.3g} against float64 index_add_")
    return totals


def phase_async() -> dict:
    """``AsyncRoundEngine`` on ResNet-20/GN at full width under the Fig. 6
    channel with churn, then the async bench scenarios; see the module
    docstring for the gates.  Returns each kernel's launches over the
    phase."""
    from repro_torch.bench import harness, report, scenarios
    from repro_torch.channels import PoissonDelays, ZeroDelays
    from repro_torch.configs.resnet20_cifar import CONFIG
    from repro_torch.core.aggregation import ServerOpt
    from repro_torch.data.loader import FederatedLoader
    from repro_torch.data.partition import iid_partition
    from repro_torch.data.synthetic import cifar_like
    from repro_torch.fl.async_engine import AsyncRoundEngine
    from repro_torch.fl.engine import run_rounds_loop
    from repro_torch.fl.simulator import FLSimulator
    from repro_torch.kernels import relay_mix as k
    from repro_torch.models.resnet import init_resnet20, resnet20_loss
    from repro_torch.obs import Tracer
    from repro_torch import channels

    ds = cifar_like(N_TRAIN, seed=0)
    parts = iid_partition(ds, N_CLIENTS, seed=0)

    def loss_fn(params, batch):
        return resnet20_loss(params, CONFIG, batch)

    def run(backend, engine, delays=None, buffer_k=0):
        sim = FLSimulator(loss_fn, n_clients=N_CLIENTS, strategy="colrel_fused",
                          local_steps=LOCAL_STEPS, relay_backend=backend,
                          server_opt=ServerOpt(momentum=0.5))
        loader = FederatedLoader(ds, parts, seed=0)
        params = init_resnet20(0, CONFIG)
        state = sim.init_server_state(params)
        gen = torch.Generator(device=sim.device).manual_seed(42)
        policy = channels.AdaptiveOptAlpha(sweeps=40, warm_sweeps=12)
        kw = dict(schedule=fig6_schedule(), rounds=ASYNC_ROUNDS, policy=policy, lr=LR,
                  next_batch=lambda: loader.round_batch(LOCAL_STEPS, LOCAL_BATCH))
        tracer = Tracer()
        torch.cuda.synchronize()
        k.reset_launches()
        t0 = time.perf_counter()
        if engine == "loop":
            res = run_rounds_loop(sim, gen, params, state, **kw)
        else:
            eng = AsyncRoundEngine(sim, delays=delays, staleness_decay=0.8,
                                   buffer_k=buffer_k, tracer=tracer)
            res = eng.run_schedule(gen, params, state, **kw)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / ASYNC_ROUNDS
        launches = dict(k.LAUNCHES)
        params, state, metrics, gen = res
        tag = f"colrel_fused/{backend} {engine}"
        want = {"relay_mix_2d": 0, "fused_aggregate_2d": ASYNC_ROUNDS}
        if launches != want:
            fail(f"async {tag}: kernel launches {launches}, expected {want}")
        losses = metrics["loss"]
        if not (bool(torch.isfinite(losses).all())
                and all(bool(torch.isfinite(x).all()) for x in _leaves(params))):
            fail(f"async {tag}: non-finite losses or params")
        buffers = [e.attrs for e in tracer.instants if e.name == "async.buffer"]
        counters = dict(tracer.counters)
        return {"params": params, "state": state, "metrics": metrics, "gen": gen.get_state(),
                "ms": ms, "launches": launches, "counters": counters,
                "max_staleness": max((b["max_staleness"] for b in buffers), default=0),
                "mean_selected": (sum(b["selected"] for b in buffers) / len(buffers)
                                  if buffers else None)}

    totals = dict.fromkeys(k.LAUNCHES, 0)
    for backend in ("hopper_fused", "hopper"):
        loop = run(backend, "loop")
        zero = run(backend, "async", ZeroDelays(N_CLIENTS))
        for part in ("params", "state", "metrics"):
            if not _bitwise_equal(zero[part], loop[part]):
                fail(f"async colrel_fused/{backend}: delay 0 {part} differ from the loop's")
        if not torch.equal(zero["gen"], loop["gen"]):
            fail(f"async colrel_fused/{backend}: delay 0 generator state differs from the loop's")
        print(f"async colrel_fused/{backend}: delay 0 bitwise equal to the loop over "
              f"{ASYNC_ROUNDS} rounds (params, server state, loss/τ/delta_norm, generator "
              f"state); loop {loop['ms']:.3f} ms a round, async {zero['ms']:.3f}; launches "
              f"{zero['launches']}")
        for kn in totals:
            totals[kn] += loop["launches"][kn] + zero["launches"][kn]
        for buffer_k in (0, 4):
            delayed = run(backend, "async",
                          PoissonDelays(N_CLIENTS, rate=1.0, max_delay=8, seed=11),
                          buffer_k=buffer_k)
            c = delayed["counters"]
            print(f"async colrel_fused/{backend} Poisson(1.0) max_delay 8 buffer_k {buffer_k}: "
                  f"{delayed['ms']:.3f} ms a round; final loss "
                  f"{float(delayed['metrics']['loss'][-1]):.4f}; arrivals "
                  f"{c.get('async.arrivals', 0)}, superseded {c.get('async.superseded', 0)}, "
                  f"selected {c.get('async.selected', 0)} ({delayed['mean_selected']:.2f} a "
                  f"round), max staleness {delayed['max_staleness']}; launches "
                  f"{delayed['launches']}")
            for kn in totals:
                totals[kn] += delayed["launches"][kn]

    out_dir = os.path.join(ROOT, "build", "bench_torch")
    for name in ASYNC_SCENARIOS:
        spec = scenarios.get_scenario(name)
        t0 = time.perf_counter()
        k.reset_launches()
        result = harness.run_scenario(spec)
        launches = dict(k.LAUNCHES)
        seconds = time.perf_counter() - t0
        rep = report.make_report(spec, result)
        path = report.write_report(rep, out_dir)
        check, runs = result["async_check"], result["runs"]
        if not (check and check["bitwise"] is True):
            fail(f"async {name}: async_check {check}")
        want = dict.fromkeys(launches, 0)  # the einsum backend launches nothing
        if launches != want:
            fail(f"async {name}: kernel launches {launches}, expected {want}")
        for engine, run_ in runs.items():
            if not all(math.isfinite(x) for x in run_.losses):
                fail(f"async {name} {engine}: non-finite loss {run_.losses}")
        engines = "; ".join(f"{e} {r.rounds_per_sec:.3f} rounds/s" for e, r in runs.items())
        ttac = "; ".join(
            f"{e} {t['rounds_to_target'] if t['reached'] else 'not reached'}"
            for e, t in sorted(result["ttac"]["engines"].items()))
        print(f"async {name} ({spec.rounds} rounds, {seconds:.1f} s on {rep['device']['name']} "
              f"at {rep['device']['power_limit_w']} W): {engines}; async_check bitwise True; "
              f"rounds to loss {result['ttac']['target_loss']}: {ttac}; report "
              f"{os.path.relpath(path, ROOT)}")
    return totals


def main() -> int:
    phase_device()
    sys.path.insert(0, os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    phase_build()
    kern = phase_kernels()
    runs = phase_main()
    engine_launches = phase_engines()
    bench_launches = phase_bench()
    t_sparse = time.perf_counter()
    sparse_launches = phase_sparse()
    t_async = time.perf_counter()
    async_launches = phase_async()
    print(f"phases: sparse {t_async - t_sparse:.1f} s, async {time.perf_counter() - t_async:.1f} s")
    launches = {"relay_mix_2d": runs["colrel/hopper"]["launches"]["relay_mix_2d"],
                "fused_aggregate_2d":
                    runs["colrel_fused/hopper_fused"]["launches"]["fused_aggregate_2d"]}
    source = "src/repro_torch/kernels/csrc/relay_mix.cu"
    replaces = {"relay_mix_2d": "src/repro/kernels/relay_mix.py:47",
                "fused_aggregate_2d": "src/repro/kernels/relay_mix.py:94"}
    errs = {"relay_mix_2d": "mix", "fused_aggregate_2d": "fused"}
    kernels = []
    for name in ("relay_mix_2d", "fused_aggregate_2d"):
        main_t, large_t = kern["timing"][name]["main"], kern["timing"][name]["large"]
        e = errs[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces[name],
            "launches": launches[name],
            # each path's own count, from zero just before it: the main
            # phase's 5 rounds, the engines phase's four runs of 20, the
            # bench phase's kernel checks (cold and warm passes), the sample
            # sweeps' engines (cold and warm, the segment reduce) and the
            # async engine's and its loops' rounds on the kernel backends
            "launches_by_path": {
                "main": launches[name],
                "engines": engine_launches[name],
                "bench": bench_launches[name],
                "sparse": sparse_launches[name],
                "async": async_launches[name],
            },
            "max_abs_err": kern["main_err"][e],
            "tolerance": {"f32": {"atol": ATOL, "rtol": RTOL_F32},
                          "bf16": {"atol": ATOL, "rtol": RTOL_BF16}},
            "sweep_max_abs_err": {"f32": kern["worst"][e, "f32"],
                                  "bf16": kern["worst"][e, "bf16"]},
            "shape": main_t["shape"],
            "ms": main_t["ms"], "plain_ms": main_t["plain_ms"],
            "bound_ms": main_t["bound_ms"], "bound_by": main_t["bound_by"],
            "library_ms": main_t["library_ms"],
            "ms_l2_resident": main_t["ms_l2_resident"],
            **({"plan": main_t["plan"]} if "plan" in main_t else {}),
            "large": {key: large_t[key] for key in
                      ("shape", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            **({"sparse": kern["timing"][name]["sparse"]}
               if "sparse" in kern["timing"][name] else {}),
        })
    print(f"total {time.perf_counter() - t0:.1f} s after the device check")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
