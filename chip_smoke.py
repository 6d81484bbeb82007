#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any error:

1. device   needs ``torch.cuda.is_available()``; prints the card's name and
            power limit; turns TF32 off for matmuls and cuDNN convolutions.
2. build    compiles the CUDA kernels from ``src/repro_torch/kernels/csrc``
            with nvcc (into ``build/torch_kernels/``) and prints the seconds.
3. kernels  holds each kernel against its plain torch version on the card
            over n × D × {f32, bf16}, checks relay_mix_2d's backward and that
            two calls are bitwise equal, then times each kernel, its plain
            version and one PyTorch call for the same function, beside the
            card's bound for the work.
4. main     ColRel rounds of ResNet-20/GN at full width (D = 272,282) for
            n = 10 clients through ``FLSimulator``, four times on the same
            τ and batches: colrel on ``hopper`` and on ``einsum``,
            colrel_fused on ``hopper_fused`` and on ``einsum``.  Each kernel
            must launch exactly once a round on its backend, every loss must
            be finite, each kernel run must agree with its plain twin after
            all rounds, and colrel with colrel_fused after one round.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Imports neither jax nor the JAX package.
"""
from __future__ import annotations

import json
import math
import os
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

# kernel sweep and tolerances: f32 atol 1e-5 + rtol 1e-5 (sum order differs);
# bf16 one bf16 ulp of the output (rtol 2^-7) + the same f32 atol
SWEEP_N = (1, 7, 10, 64, 128, 300)
SWEEP_D = (100, 5000, RESNET20_D)
ATOL, RTOL_F32, RTOL_BF16 = 1e-5, 1e-5, 2.0**-7
PARAM_ATOL = LOSS_ATOL = 1e-4  # a kernel run against its plain twin, 5 rounds

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


def phase_build() -> None:
    from repro_torch.kernels import build

    res = build.build(verbose=True)
    print(f"build: {res.seconds:.2f} s nvcc -> {os.path.relpath(res.path, ROOT)}")
    for line in res.log.splitlines():
        spills = "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line
        if "registers" in line or spills:
            print(f"  ptxas {line.strip()}")


def phase_kernels() -> dict:
    from repro_torch.kernels import ref
    from repro_torch.kernels import relay_mix as k

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    worst = {("mix", "f32"): 0.0, ("mix", "bf16"): 0.0,
             ("fused", "f32"): 0.0, ("fused", "bf16"): 0.0}
    main_err = {}
    cases = 0
    for n in SWEEP_N:
        for D in SWEEP_D:
            A = (torch.randn(n, n, generator=gen) / math.sqrt(n)).to(dev)
            c = (torch.randn(n, generator=gen) / math.sqrt(n)).to(dev)
            d32 = torch.randn(n, D, generator=gen).to(dev)
            for tag, dt, rtol in (("f32", torch.float32, RTOL_F32),
                                  ("bf16", torch.bfloat16, RTOL_BF16)):
                d = d32.to(dt)
                e_mix = check_close(f"relay_mix_2d n={n} D={D} {tag}", k.relay_mix_2d(A, d),
                                    ref.relay_mix_2d(A.to(dt), d), rtol)
                e_fused = check_close(f"fused_aggregate_2d n={n} D={D} {tag}",
                                      k.fused_aggregate_2d(c, d),
                                      ref.fused_aggregate_2d(c.to(dt), d), rtol)
                worst["mix", tag] = max(worst["mix", tag], e_mix)
                worst["fused", tag] = max(worst["fused", tag], e_fused)
                if (n, D) == MAIN_SHAPE and tag == "f32":
                    main_err = {"mix": e_mix, "fused": e_fused}
                cases += 2
    torch.cuda.synchronize()
    print(f"kernels: {cases} cases within tolerance; max |Δ| "
          + ", ".join(f"{a} {b} {v:.3g}" for (a, b), v in worst.items()))

    # backward of the mix: (dA, dΔ) against autograd through the plain version
    for n, D in ((5, 700), MAIN_SHAPE):
        A = (torch.randn(n, n, generator=gen) / math.sqrt(n)).to(dev)
        d = torch.randn(n, D, generator=gen).to(dev)
        cot = torch.randn(n, D, generator=gen).to(dev)
        grads = []
        for fn in (k.relay_mix_2d, ref.relay_mix_2d):
            A_ = A.clone().requires_grad_(True)
            d_ = d.clone().requires_grad_(True)
            (fn(A_, d_) * cot).sum().backward()
            grads.append((A_.grad, d_.grad))
        check_close(f"relay_mix_2d dA n={n} D={D}", grads[0][0], grads[1][0], RTOL_F32)
        check_close(f"relay_mix_2d dΔ n={n} D={D}", grads[0][1], grads[1][1], RTOL_F32)
    print("kernels: relay_mix_2d backward (dA, dΔ) matches autograd through the plain version")

    # determinism: no atomics, so two calls are bitwise equal
    n, D = MAIN_SHAPE
    A = torch.randn(n, n, generator=gen).to(dev)
    c = torch.randn(n, generator=gen).to(dev)
    d = torch.randn(n, D, generator=gen).to(dev)
    if not (torch.equal(k.relay_mix_2d(A, d), k.relay_mix_2d(A, d))
            and torch.equal(k.fused_aggregate_2d(c, d), k.fused_aggregate_2d(c, d))):
        fail("kernels are not bitwise deterministic")
    print("kernels: two calls are bitwise equal")

    # times: kernel, plain version, one PyTorch call; f32 as on the main path
    timing = {"relay_mix_2d": {}, "fused_aggregate_2d": {}}
    for label, (n, D) in (("main", MAIN_SHAPE), ("large", LARGE_SHAPE)):
        # rotate over enough Δ copies that the working set exceeds 2× L2,
        # so each call finds Δ in device memory, as the round does
        copies = max(1, math.ceil(2 * L2_BYTES / (4 * n * D)))
        A = (torch.randn(n, n, generator=gen) / math.sqrt(n)).to(dev)
        c = (torch.randn(n, generator=gen) / math.sqrt(n)).to(dev)
        ds = [torch.randn(n, D, device=dev) for _ in range(copies)]
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
            timing[name][label] = t
            print(f"time {name} {label} (n={n}, D={D}, {copies} Δ copies): "
                  + json.dumps({key: v for key, v in t.items() if key != "shape"}))
        del ds, mix_args, fused_args
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


def main() -> int:
    phase_device()
    sys.path.insert(0, os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    phase_build()
    kern = phase_kernels()
    runs = phase_main()
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
            "large": {key: large_t[key] for key in
                      ("shape", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        })
    print(f"total {time.perf_counter() - t0:.1f} s after the device check")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
