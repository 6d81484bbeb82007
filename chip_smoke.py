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
            function, beside the card's bound for the work, at the main
            shape, at (8, 10⁷), at mesh_corr_500's (10, 2,410) and at the
            channel figures' MLP (10, 789,258), and the
            mix also at n = 32, 64 and 128 on the main width (bitwise equal
            to its plain version there), and the fused kernel at the sample
            sweeps' shapes (n = 256 … 10⁴, D = 698; bitwise equal to its
            plain version in its two-level order); fails where the fused
            kernel's f32 output at a shape with one origin range (S = 1) is
            not the single ascending chain; prints each kernel's launch plan
            (the mix's path, the fused kernel's origin ranges S, vector
            bytes, grid, resident blocks an SM, threads a block) at each.
4. main     ColRel rounds of ResNet-20/GN at full width (D = 272,282) for
            n = 10 clients through ``FLSimulator``, four times on the same
            τ and batches: colrel on ``hopper`` and on ``einsum``,
            colrel_fused on ``hopper_fused`` and on ``einsum``.  Each kernel
            must launch exactly once a round on its backend, every loss must
            be finite, each kernel run must agree with its plain twin after
            all rounds, and colrel with colrel_fused after one round.
5. figures  the paper's Figs. 2-4 protocol (``repro_torch.bench.figures``)
            at ResNet-20/GN (D = 272,282, n = 10) with the reference's
            T = 8, b = 64, lr 0.1 and 4,000 ``cifar_like`` training images,
            10 of its 30 rounds a run: Fig. 2 (p = 0.2, fully connected),
            Fig. 3 (the paper's heterogeneous p on ring(10, 1), initial and
            optimized A) and Fig. 4 (non-IID sort-and-partition, ring(10, 2),
            server momentum 0.9), every strategy on ``hopper_fused``; Fig. 3's
            optimized run also as paper-faithful colrel on ``hopper``, and
            both kernel runs again on ``einsum`` with the same τ and
            batches.  Gates: each kernel run launches its kernel once a round
            and the other never; every loss and parameter finite; each
            kernel run within PARAM_ATOL/LOSS_ATOL of its einsum twin after
            all rounds.  Prints each run's accuracy curve, final loss,
            rounds to 90% and ms a round, the reference's CSV rows, and
            whether the paper's order held (not gated).
6. channel_figures  the beyond-paper channel figures
            (``repro_torch.bench.figures``: the reference's
            ``fig5_timevarying.py``, ``fig6_churn.py`` and
            ``fig_correlated.py``) at 10 of the reference run()'s 30 rounds
            a run and the MLP's full width (3,072 → 256 → 10, D = 789,258, n = 10, T = 8,
            b = 64, lr 0.1, 4,000 ``cifar_like`` images), the round's p taken
            from the channel: Figs. 5 and 6, each of the three policies
            (blind FedAvg, the round-0 A kept stale, OPT-α re-solved per
            epoch) through the loop, the scan engine and the pipelined engine
            with inline and threaded prefetch (chunk 2), and the correlated
            sweep at ℓ = 0, 0.2, 0.5, ∞ through the loop, every run on
            ``hopper_fused``; Fig. 6's adaptive run also as paper-faithful
            colrel on ``hopper``, and both kernel runs again on ``einsum``
            with the same τ and batches.  Gates: each call's kernel launched
            once a round for each of its runs and the other kernel never;
            every loss and parameter finite; scan and pipelined losses and
            final parameters bitwise equal to the loop's; each engine's
            trace_count in 1..2 and its replays + eager chunks equal to its
            chunks; each kernel run within PARAM_ATOL/LOSS_ATOL of its einsum
            twin.  Prints the reference's CSV, scheduler and sweep_mean rows,
            the pipelined engine's overlap_fraction, ms a round (median, the
            first round apart) and whether each figure's claim held (not
            gated).
7. claims   the quadratic oracle of the reference's
            ``tests/test_fl_convergence.py`` (``repro_torch.bench.claims``):
            150 rounds a run, τ from a CUDA generator for seeds 42, 43, 44,
            every run on ``hopper_fused``.  Gates, the reference's bounds
            unchanged: colrel < 0.3 × blind FedAvg-dropout (seed 42); mean
            optimized < 1.05 × mean initial A; mean colrel < 250 ×
            max(mean no-dropout, 1e-4); the fused kernel launched once a
            round; every error finite.  The kernel's shape here, (10, 20),
            is one of the kernels phase's cases.  Prints each run's error
            by seed.
8. engines  ColRel rounds of the same model, clients and data under the
            JAX package's Fig. 6 channel at a short coherence (Markov link
            fading on ring(10, 2), piecewise-constant p drift, rotating-cohort
            churn; epochs of unequal length), A from ``AdaptiveOptAlpha``,
            through ``run_rounds_loop``, ``EpochScanEngine`` and
            ``PipelinedScanEngine`` (inline and threaded prefetch), 12 rounds
            a run, for colrel on ``hopper`` and colrel_fused on
            ``hopper_fused``.  The engines replay their full chunks from
            CUDA graphs and run the remainders eagerly.  Gates: each
            engine bitwise equal to its loop (params, server state, per-round
            loss/τ/delta_norm, generator state); the engines' scheduler
            stats equal to each other and their solves to the loop's; each
            kernel launched once a round on its backend (replays counted)
            and never on the other; trace_count in 1..2, replays equal to
            the full chunks and replays + eager chunks to all chunks; the
            pipelined engine's dispatches equal to its chunks;
            finite losses and params; a churned round whose inactive τ reads
            0.  Prints ms a round, the captures, the prefetch
            overlap, the epochs and the OPT-α solves.  Then the timing run:
            one 16-round epoch of the same model in chunks of 4 on each
            kernel backend, eager and replayed (3 timed runs each, replayed
            bitwise equal to eager); prints ms a round each way, the
            capture's ms, the graph pool beside one round's activations and
            the device busy share of one replayed chunk (profiler).
9. bench    the bench harness (``repro_torch.bench.run_scenario``) on three
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
            losses; no engine above 2 captures.  Prints rounds/s, compile_s
            and trace_count per engine, the pipelined engine's overlap, the
            kernel check and model_params.
10. suite    the port's benchmark orchestrator's rows
            (``repro_torch.bench``): the relay-kernel rows of
            ``kernel_bench`` (the reference's ``bench_relay_kernel.py``
            draws, n = 16) at D = 2^14, 2^17 and 2^21 in bf16 and f32,
            each kernel held against its plain version at the kernels
            phase's tolerances and timed beside it, the library call
            (``torch.matmul(A.to(dt), Δ)``, ``c.to(dt) @ Δ``) and the bound;
            the OPT-α rows (``opt_alpha_bench``: S_opt ≤ S_init, finite);
            a dry run of glm4-9b decode_32k on the one-pod mesh and the
            roofline rows and table over it (collective n/a, no 16 GB
            figure); the relay-sweep row of the bench phase's
            relay_sweep_1e7 report.  Gates: both kernels launched by the
            rows; every check above.
11. sparse   the bench harness on the cohort-sampling sweeps at their
            registered sizes: sample_sweep_smoke (n = 256), _n1e3 (8 of its
            16 rounds, for time) and _n1e4 (n = 10⁴, about 28 MB of (n, D)
            f32 buffer): a sparse geometric
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
12. async    AsyncRoundEngine on ResNet-20/GN at full width (n = 10,
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
13. service  the continuous-training service (``repro_torch.launch``) on
            ResNet-20/GN at full width (n = 10, D = 272,282) under the Fig. 6
            channel with churn, AdaptiveOptAlpha and server momentum 0.9:
            ``ContinuousTrainer`` on loop, scan and pipelined with
            colrel_fused on ``hopper_fused``, and on the loop with colrel on
            ``hopper``.  Per engine: one uninterrupted 12-round run; a
            trainer publishing every 4 rounds (``checkpoint.publish``) whose
            params, server state, per-round loss/τ/delta_norm and generator
            state are bitwise equal to it, while a ``SnapshotEvalLoop``
            follows each snapshot in order and scores a held-out batch within
            1e-6 of the same loss on the trainer's params; a trainer that runs
            8 rounds and is dropped; and one rebuilt from seeds that calls
            ``restore_latest`` + ``advance_stream`` and runs 4 rounds,
            bitwise equal to rounds 9–12.  The async engine under Poisson(1.0)
            delays (max_delay 8) in bursts of 4 bitwise equal to one 12-round
            call.  Each kernel launched once a round on its backend and never
            on the other.  Prints ms a round per engine and ms per publish and
            per ``restore_training_state`` of the ResNet snapshot.
14. distributed  the distributed round steps (``repro_torch.fl.distributed``)
            on ResNet-20/GN at full width (n = 10, T = 2, the main phase's
            batch): ``build_round_step`` faithful on ``hopper`` and
            ``einsum``, fused on ``hopper_fused`` and ``einsum``,
            ``build_scan_round_step`` and ``build_fused_scan_round_step`` on
            ``hopper_fused``, 3 rounds each on one τ stream; the T = 1
            weighted-loss step and the T = 1 per-client step (``hopper``).
            Gates: each kernel run within PARAM_ATOL/LOSS_ATOL of einsum;
            the scan and fused scan steps bitwise equal to the per-round
            step (the fused scan's generator equal to the host draws'); the
            weighted-loss step within 1e-5 of the per-client step, with no
            launch.  Then ``init_process_group("nccl", world_size=1)`` and
            ``ShardedScanEngine`` 8 rounds under the Fig. 6 channel with
            churn at lr 1e-3, each epoch captured as a CUDA graph (NCCL
            collectives inside): gather on ``hopper_fused`` bitwise equal
            to the same engine eager and to the single-device fused engine
            (the fused scan step an epoch), ring
            and shard="d" on ``einsum`` within the harness tolerance, each
            with the fused engine's generator state and one call an epoch,
            trace_count the distinct (epoch length, masked) pairs (0 eager);
            the single-device loop bitwise equal to the fused engine.  Then
            the bench harness on ``mesh_corr_500`` (100 of its 500 rounds)
            with a ``hopper_fused`` kernel check: the three mesh steps
            bitwise equal, the check ≤ 1e-5, 2 × rounds fused launches.
            Each kernel launched once a round on its backend and never
            elsewhere.  Prints ms a round per run and the world size;
            multi-rank exchange is not measured on one card.
15. lm       the LM model zoo (``repro_torch.models``) and its serving path.
            glm4-9b at full width and depth (9,399,767,040 f32 parameters,
            drawn on the card) through ``get_model`` and
            ``launch/serve.py::_decode_demo`` at the serving CLI's defaults
            (batch 4, prompt 64, 16 new tokens), after a 2-token warm-up
            demo.  Gates: the parameter count equals ``param_count()``; the
            first decode step's logits within relative max error 2e-3 of a
            teacher-forced prefill of the prompt plus that token (the
            reference test's bar); every decoded logit finite.  The demo
            replays its decode step as a CUDA graph.  Prints prefill ms,
            the capture's ms, decode ms a token, tokens/s, peak GB, the
            decode step's byte bounds, ms a token of the same step eager
            and one profiled eager step.  Then every
            assigned architecture at ``reduced()`` (B = 2, S = 96): prefill
            logits and loss for CPU-made parameters within atol 1e-5 + rtol
            1e-5 of the port's CPU run, decode against teacher forcing (MoE
            at capacity factor 8) and 8 greedy steps finite.  Then
            ``FLSimulator`` ColRel on glm4-9b and mixtral-8x22b at
            ``reduced()`` (n = 10, T = 2, ``lm_tokens`` batches of 8 × 64, 4
            rounds): colrel on ``hopper`` and colrel_fused on
            ``hopper_fused`` within the harness's 1e-5 of ``einsum``, each
            kernel launched once a round on its backend and never on the
            other.  Then both kernels at the two LM widths
            (D = 1,443,072 and 3,804,416): checked against the plain
            version, timed beside it, the library call and the bound.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Imports neither jax nor the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# the timing and the card's figures, shared with the port's kernel bench:
# the H100's data-sheet rates (dense, 700 W), its L2, device ms from CUDA
# events around a CUDA graph of calls, and the bound of a call's work
from repro_torch.bench.kernel_bench import (  # noqa: E402
    L2_BYTES,
    PEAK_BYTES_PER_S,
    bound_ms,
    device_ms,
)

# main path: the README's core loop at the paper's §V model
N_CLIENTS, LOCAL_STEPS, LOCAL_BATCH, LR, ROUNDS = 10, 2, 32, 0.05, 5
N_TRAIN = 2560
RESNET20_D = 272_282
MAIN_SHAPE = (N_CLIENTS, RESNET20_D)
LARGE_SHAPE = (8, 10_000_000)  # the JAX package's relay_sweep_1e7 size
# the segment backend's dense reduce in the sample sweeps (the MLP's
# D = 698): sample_sweep_smoke's n, n1e3's, one past the 1,024
# coefficients the single-chain kernel stages at once, and n1e4's; all
# summed in fused_splits ranges (4, 16, 17 and 157)
SPARSE_SHAPES = ((256, 698), (1_000, 698), (1_025, 698), (10_000, 698))
# the fused kernel in mesh_corr_500's kernel check: n = 10 clients of its
# MLP (dim 64, width 32: D = 64·32 + 32 + 32·10 + 10)
MESH_SHAPE = (10, 2_410)
# the channel figures' MLP: 3,072 → 256 → 10 (D = 3,072·256 + 256 + 256·10 + 10)
MLP_SHAPE = (N_CLIENTS, 789_258)
# the mix timed at the main width for more clients: n = 32 (its stream
# path's largest n) and its slab path at 64 and 128 (the JAX kernel's regime)
MIX_WIDE_SHAPES = tuple((n, RESNET20_D) for n in (32, 64, 128))

# kernel sweep and tolerances: f32 atol 1e-5 + rtol 1e-5 (sum order differs);
# bf16 one bf16 ulp of the output (rtol 2^-7) + the same f32 atol.  Besides
# the main path's shape: D below one vector (1, 3) and odd (4,097, D + 1);
# n across the fused kernel's origin chunks (6, 12 and 24 origins for 16-,
# 8- and 4- or 2-byte loads; 16 for a chunk of 16) and across the mix's
# paths (32 the stream path's last, 33 the slab path's first); D = 20 is
# the claims phase's quadratic (n = 10), D = 789,258 the channel figures' MLP
SWEEP_N = (1, 7, 10, 12, 13, 15, 16, 17, 24, 25, 32, 33, 64, 128, 300)
SWEEP_D = (1, 3, 20, 100, MESH_SHAPE[1], 4097, 5000, RESNET20_D, RESNET20_D + 1,
           MLP_SHAPE[1])
ATOL, RTOL_F32, RTOL_BF16 = 1e-5, 1e-5, 2.0**-7
PARAM_ATOL = LOSS_ATOL = 1e-4  # a kernel run against its plain twin, 5 rounds

# figures phase: the paper's Figs. 2-4 protocol (repro_torch.bench.figures)
# at ResNet-20/GN with the reference's T = 8, b = 64, lr 0.1, 4,000 training
# images and an evaluation every 2 rounds; 10 of the reference's 30 rounds a
# run, for time (16 runs of about half a second a round)
FIG_ROUNDS = 10

# channel_figures phase: the reference's channel studies at the MLP's full
# width, 10 of its run()'s 30 rounds a run (6 link epochs, a p change at
# round 5, cohort shifts at 4 and 8), for time: 39 runs of host-bound rounds
# at 60-130 ms took 104.0 s at 30 rounds and 75.5 s at 16 on an H100 host
CHANNEL_ROUNDS = 10

# engines phase: the Fig. 6 channel at a coherence of a few rounds, so that
# 12 rounds cross epochs of unequal length (6, 2 and 4) and chunk 4 leaves
# remainders (20 rounds until the service phase came; cut for time).  The
# timing run: one 16-round epoch in chunks of 4 (every chunk full, so every
# chunk replays), eager and replayed, 3 timed runs each
ENGINE_ROUNDS, ENGINE_CHUNK = 12, 4
TIMING_ROUNDS, TIMING_CHUNK, TIMING_RUNS = 16, 4, 3

# bench phase: the registered scenarios it runs, and the model sizes the
# JAX package recorded for them (BENCH_resnet20_cifar.json,
# BENCH_relay_sweep_1e7.json)
BENCH_SCENARIOS = ("bench_smoke", "resnet20_cifar", "relay_sweep_1e7")
BENCH_MODEL_PARAMS = {"resnet20_cifar": 272_282, "relay_sweep_1e7": 10_013_594}
BENCH_KERNEL = {"hopper": "relay_mix_2d", "hopper_fused": "fused_aggregate_2d"}

# suite phase: the port's benchmark orchestrator (repro_torch.bench.suite)
# beyond its figures and scenarios: the relay-kernel rows in both dtypes at
# n = 16 and D = 2^14, 2^17, 2^21 (the reference's bench_relay_kernel.py
# draws), the OPT-α rows, the roofline rows over one dry run that takes
# seconds on the host (the lm phase's served model, one token of decode on
# the one-pod mesh) and the relay-sweep rows over the bench phase's reports
SUITE_DTYPES = ("bf16", "f32")
SUITE_DRYRUN = ("glm4-9b", "decode_32k")

# sparse phase: the sample sweeps at their registered sizes, the segment
# ops' and the einsum check's tolerance, and the rounds of the loop's
# host/device split
SPARSE_SCENARIOS = ("sample_sweep_smoke", "sample_sweep_n1e3", "sample_sweep_n1e4")
SPARSE_CHECK_ATOL = 1e-5
SPLIT_ROUNDS = 8
# rounds of a scenario cut below its registered count for time: n1e3's
# sparse OPT-α re-solve takes ~0.4 s a round on the host, over 8 passes
SPARSE_ROUNDS = {"sample_sweep_n1e3": 8}

# async phase: rounds of each AsyncRoundEngine run on ResNet-20/GN, and the
# async bench scenario.  async_ttac_500 (500 rounds through four engine
# passes, about 40 s on the card) runs on its own through
# `python -m repro_torch.bench.run --scenario async_ttac_500`, which keeps
# this script near three minutes
ASYNC_ROUNDS = 20
ASYNC_SCENARIOS = ("async_smoke",)

# service phase: rounds of each run, the publish interval (a burst), the
# round after which a run crashes, and the publish/restore timing repeats
SERVICE_ROUNDS, SERVICE_BURST, SERVICE_CRASH, SERVICE_REPS = 12, 4, 8, 5

# distributed phase: rounds of each single-device step run, rounds of each
# sharded engine run (the Fig. 6 channel: epochs of 6 and 2 rounds), and
# mesh_corr_500's rounds (500 registered; cut for time, about 8 passes).
# The sharded runs train at lr 1e-3, as the repo's ResNet comparisons across
# summation orders do: the ring sums in another order than the dense
# backends, and at lr 0.05 a ResNet trajectory grows a 3e-8 difference
# after one round past 1e-3 within 8 rounds (CPU rehearsal)
DIST_ROUNDS, SHARD_ROUNDS, MESH_ROUNDS, SHARD_LR = 3, 8, 100, 1e-3

# lm phase: glm4-9b at full width and depth served through the decode demo
# at the serving CLI's defaults (batch 4, prompt 64, 16 new tokens); every
# assigned architecture at reduced() (B = 2, S = 96, 8 greedy steps);
# ColRel rounds of glm4-9b and mixtral-8x22b at reduced() with the training
# CLI's lm_tokens batches (n = 10, T = 2, local batch 8, sequence 64).  The
# decode/teacher-forcing bar is the reference test's (relative max error
# < 2e-3); card against CPU atol 1e-5 + rtol 1e-5
LM_SERVE_ARCH, LM_SERVE_REDUCED = "glm4-9b", False
LM_BATCH, LM_PROMPT, LM_NEW_TOKENS = 4, 64, 16
LM_TF_REL = 2e-3
LM_EAGER_STEPS = 3
LM_B, LM_S, LM_DECODE_STEPS = 2, 96, 8
LM_FL_ARCHS = ("glm4-9b", "mixtral-8x22b")
LM_FL_CLIENTS, LM_FL_T, LM_FL_BATCH, LM_FL_SEQ, LM_FL_ROUNDS, LM_FL_LR = 10, 2, 8, 64, 4, 0.1


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


def single_chain(c, d):
    """u = c·Δ as one ascending addcmul chain over all n origins from 0 (in
    Δ's dtype's weights): the fused kernel's order wherever fused_splits
    gives S = 1."""
    c, d32 = c.to(d.dtype).float(), d.float()
    out = torch.zeros_like(d32[0])
    for j in range(d.shape[0]):
        out = torch.addcmul(out, c[j], d32[j])
    return out.to(d.dtype)


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
    main_err, mesh_err, mlp_err = {}, {}, {}
    cases = 0
    # information, not a gate: f32 cases bitwise equal to the plain version
    # (the kernels' order) and to the library product (cuBLAS's order).  A
    # gate: the fused kernel's f32 output wherever S = 1 is the single chain
    same = {"plain": 0, "library": 0, "f32 cases": 0}
    single = 0
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
                    if tag == "f32" and k.fused_splits(n, D) == 1:
                        if not torch.equal(u, single_chain(c, d)):
                            fail(f"fused_aggregate_2d {name}: S = 1 but not the single chain")
                        single += 1
                    if tag == "f32":
                        same["f32 cases"] += 2
                        same["plain"] += (torch.equal(m, ref.relay_mix_2d(A, d))
                                          + torch.equal(u, ref.fused_aggregate_2d(c, d)))
                        same["library"] += torch.equal(m, A @ d) + torch.equal(u, c @ d)
                    worst["mix", tag] = max(worst["mix", tag], e_mix)
                    worst["fused", tag] = max(worst["fused", tag], e_fused)
                    if (n, D) == MAIN_SHAPE and tag == "f32" and not layout:
                        main_err = {"mix": e_mix, "fused": e_fused}
                    if (n, D) == MESH_SHAPE and tag == "f32" and not layout:
                        mesh_err = {"mix": e_mix, "fused": e_fused}
                    if (n, D) == MLP_SHAPE and tag == "f32" and not layout:
                        mlp_err = {"mix": e_mix, "fused": e_fused}
                    cases += 2
    torch.cuda.synchronize()
    print(f"kernels: {cases} cases within tolerance, each call bitwise repeatable; max |Δ| "
          + ", ".join(f"{a} {b} {v:.3g}" for (a, b), v in worst.items()))
    print(f"kernels: bitwise equal to the plain version in {same['plain']} and to the "
          f"library product in {same['library']} of {same['f32 cases']} f32 cases; the "
          f"fused kernel equal to the single chain in all {single} f32 cases with S = 1")

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
    for label, (n, D) in (("main", MAIN_SHAPE), ("large", LARGE_SHAPE), ("mesh", MESH_SHAPE),
                          ("mlp", MLP_SHAPE)):
        # rotate over enough Δ copies that the working set exceeds 2× L2,
        # so each call finds Δ in device memory, as the round does
        copies = max(1, math.ceil(2 * L2_BYTES / (4 * n * D)))
        A = torch.randn(n, n, generator=gen, device=dev) / math.sqrt(n)
        c = torch.randn(n, generator=gen, device=dev) / math.sqrt(n)
        ds = [torch.randn(n, D, generator=gen, device=dev) for _ in range(copies)]
        reps = 40 if label == "large" else 200
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
            plan = k.relay_mix_plan if name == "relay_mix_2d" else k.fused_aggregate_plan
            t["plan"] = {"f32": plan(ds[0]), "bf16": plan(ds[0].to(torch.bfloat16))}
            if name == "fused_aggregate_2d":
                u = k.fused_aggregate_2d(c, ds[0])
                if not torch.equal(u, single_chain(c, ds[0])):
                    fail(f"fused_aggregate_2d {label}: S = 1 but not the single chain")
                # information, not a gate: cuBLAS sums in another order
                t["bitwise_equal_c_at_delta"] = torch.equal(u, c @ ds[0])
            timing[name][label] = t
            print(f"time {name} {label} (n={n}, D={D}, {copies} Δ copies): "
                  + json.dumps({key: v for key, v in t.items() if key != "shape"}))
        del ds, mix_args, fused_args
        torch.cuda.empty_cache()

    # the mix for more clients at the main width: n = 32 (the stream path's
    # largest) and the slab path at 64 and 128; bitwise equal to the plain
    # version and repeatable, then timed.  The plain version launches n
    # addcmuls a call, so it takes fewer calls a graph
    timing["relay_mix_2d"]["wide"] = []
    for n, D in MIX_WIDE_SHAPES:
        copies = max(1, math.ceil(2 * L2_BYTES / (4 * n * D)))
        A = torch.randn(n, n, generator=gen, device=dev) / math.sqrt(n)
        ds = [torch.randn(n, D, generator=gen, device=dev) for _ in range(copies)]
        m = k.relay_mix_2d(A, ds[0])
        if not torch.equal(m, ref.relay_mix_2d(A, ds[0])):
            fail(f"relay_mix_2d n={n} D={D}: not bitwise equal to the plain version")
        if not torch.equal(k.relay_mix_2d(A, ds[0]), m):
            fail(f"relay_mix_2d n={n} D={D}: two calls differ")
        args = [(A, d) for d in ds]
        reps = 200 if n * D < 10**7 else 40
        b_ms, b_by = bound_ms(4 * (n * n + 2 * n * D), 2 * n * n * D)
        t = {
            "shape": [n, D],
            "ms": device_ms(k.relay_mix_2d, args, reps),
            "plain_ms": device_ms(ref.relay_mix_2d, args, max(1, 400 // n)),
            "library_ms": device_ms(torch.matmul, args, reps),
            "bound_ms": b_ms,
            "bound_by": b_by,
            "plan": k.relay_mix_plan(ds[0]),
        }
        timing["relay_mix_2d"]["wide"].append(t)
        print(f"time relay_mix_2d wide (n={n}, D={D}, {copies} Δ copies; bitwise equal to the "
              f"plain version): " + json.dumps({key: v for key, v in t.items() if key != "shape"}))
        del ds, args, m
        torch.cuda.empty_cache()

    # the fused kernel at the segment backend's shapes: bitwise equal to the
    # plain version (the same two-level order: fused_splits ranges, each an
    # ascending fmaf chain, then the partials in ascending order) and
    # repeatable, then timed beside c @ Δ and the bound
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
        print(f"time fused_aggregate_2d sparse (n={n}, D={D}, splits {t['plan']['splits']}, "
              f"grid {t['plan']['grid']}, {copies} Δ copies; f32 and "
              f"bf16 bitwise equal to the plain version): "
              + json.dumps({key: v for key, v in t.items() if key != "shape"}))
        del ds, args
    torch.cuda.empty_cache()
    return {"worst": worst, "main_err": main_err, "mesh_err": mesh_err, "mlp_err": mlp_err,
            "timing": timing}


def device_busy_ms(prof) -> tuple[float, int]:
    """The device's busy ms in a profile: the union of the device
    activities' intervals (kernels, copies, sets), each instant counted
    once; and the number of activities.  (Summing the kernels' own times
    over-counts a CUDA graph replay, whose kernels the profiler also lists
    under the graph launch.)"""
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, end = 0.0, -math.inf
    for lo, hi in spans:
        busy_us += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    return busy_us / 1e3, len(spans)


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
    busy_ms, _ = device_busy_ms(prof)
    print(f"profile colrel_fused/hopper_fused round: wall {wall_ms:.3f} ms (profiled), "
          f"device busy {busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%; kernel times "
          f"summed {device_ms:.3f} ms), {sum(e.count for e in kernels)} kernel launches")
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


def phase_figures() -> dict:
    """The paper's Figs. 2-4 at ResNet-20/GN on the card; see the module
    docstring for the gates.  Returns each kernel's launches over the
    phase's runs."""
    import numpy as np

    from repro_torch.bench import figures
    from repro_torch.kernels import relay_mix as k

    launches = {"relay_mix_2d": 0, "fused_aggregate_2d": 0}

    def run(figure, setting, name, strategy, A, backend):
        k.reset_launches()
        res = figures.run_figure(**{**setting, "strategies": {name: (strategy, A)}},
                                 model="resnet20", rounds=FIG_ROUNDS,
                                 relay_backend=backend)[name]
        got = dict(k.LAUNCHES)
        tag = f"{figure}/{name} {strategy}/{backend}"
        want = {"relay_mix_2d": FIG_ROUNDS if backend == "hopper" else 0,
                "fused_aggregate_2d": FIG_ROUNDS if backend == "hopper_fused" else 0}
        if got != want:
            fail(f"figures {tag}: kernel launches {got}, expected {want}")
        if not all(math.isfinite(x) for x in res.losses):
            fail(f"figures {tag}: non-finite loss {res.losses}")
        if not all(bool(torch.isfinite(x).all()) for x in _leaves(res.params)):
            fail(f"figures {tag}: non-finite parameters")
        for kname in launches:
            launches[kname] += got[kname]
        ms = sorted(res.round_ms[1:])
        print(f"figures {tag}: acc {[(r, round(a, 4)) for r, a in res.accs]} "
              f"final_loss {res.losses[-1]:.6f} rounds_to_90pct "
              f"{figures.rounds_to(res, 0.90)} ms a round median {ms[len(ms) // 2]:.3f} "
              f"(first {res.round_ms[0]:.3f}) launches {got}")
        return res

    results = {}
    for figure in figures.FIGURES:
        setting = figures.figure_setting(figure)
        if figure == "fig3":
            print(figures.fig3_variance_line(setting))
        res = {name: run(figure, setting, name, strategy, A, "hopper_fused")
               for name, (strategy, A) in setting["strategies"].items()}
        figures.print_figure_csv(figure, res)
        results[figure] = res
        if figure != "fig3":
            continue
        # the optimized run once more as paper-faithful colrel on the mix
        # kernel, and each kernel run against its einsum twin (same τ and
        # batches), as the main phase holds its kernel runs
        A = setting["strategies"]["colrel_optimized"][1]
        pairs = {
            ("colrel_fused", "hopper_fused"): res["colrel_optimized"],
            ("colrel", "hopper"): run(figure, setting, "colrel_optimized", "colrel", A,
                                      "hopper"),
        }
        for (strategy, backend), kernel_run in pairs.items():
            twin = run(figure, setting, "colrel_optimized", strategy, A, "einsum")
            dl = float(np.max(np.abs(np.subtract(kernel_run.losses, twin.losses))))
            dp = max((x - y).abs().max().item()
                     for x, y in zip(_leaves(kernel_run.params), _leaves(twin.params)))
            print(f"figures fig3/colrel_optimized {strategy}/{backend} vs {strategy}/einsum: "
                  f"max |Δloss| {dl:.3g}, max |Δparam| {dp:.3g} after {FIG_ROUNDS} rounds")
            if dl > LOSS_ATOL or dp > PARAM_ATOL:
                fail(f"figures fig3 {strategy}/{backend} disagrees with einsum: "
                     f"|Δloss| {dl} |Δparam| {dp}")

    # the paper's order, reported and not gated (10 rounds at ResNet-20 on
    # cifar_like have not been shown to separate it)
    acc = {(fig, name): r.accs[-1][1] for fig, res in results.items() for name, r in res.items()}
    for fig, res in results.items():
        print(f"figures order {fig} (final accuracy, final loss): "
              + ", ".join(f"{name} {r.accs[-1][1]:.3f} {r.losses[-1]:.4f}"
                          for name, r in res.items()))
    fedavg = max(acc["fig4", "fedavg_dropout_blind"], acc["fig4", "fedavg_dropout_nonblind"])
    print(f"figures order: fig4 ColRel ahead of both FedAvg-dropout runs in accuracy "
          f"{acc['fig4', 'colrel_optimized'] > fedavg}; fig3 optimized >= unoptimized "
          f"{acc['fig3', 'colrel_optimized'] >= acc['fig3', 'colrel_unoptimized']}")
    return launches


def phase_channel_figures() -> dict:
    """The beyond-paper channel figures at the MLP's full width on the card;
    see the module docstring for the gates.  Returns each kernel's launches
    over the phase's runs."""
    import numpy as np

    from repro_torch.bench import figures
    from repro_torch.kernels import relay_mix as k

    R, hold = CHANNEL_ROUNDS, figures.HOLD
    kernel_of = {"hopper": "relay_mix_2d", "hopper_fused": "fused_aggregate_2d"}
    launches = {"relay_mix_2d": 0, "fused_aggregate_2d": 0}

    def run(label, make_schedule, eval_round, engine, backend="hopper_fused", policies=None,
            prefetch="inline"):
        policies = figures.channel_policies() if policies is None else policies
        k.reset_launches()
        res = figures.run_channel_figure(make_schedule, rounds=R, eval_round=eval_round,
                                         policies=policies, engine=engine, prefetch=prefetch,
                                         relay_backend=backend)
        got = dict(k.LAUNCHES)
        want = {name: R * len(res) if name == kernel_of.get(backend) else 0 for name in got}
        if got != want:
            fail(f"channel_figures {label} on {backend}: kernel launches {got}, expected "
                 f"{want} (once a round for each of {len(res)} runs)")
        for name in launches:
            launches[name] += got[name]
        chunks = sum(math.ceil(s.n_rounds / hold) for s in make_schedule().segments(R))
        for name, r in res.items():
            tag = f"channel_figures {label} {name} {policies[name][0]}/{backend}"
            if len(r.losses) != R or not all(math.isfinite(x) for x in r.losses):
                fail(f"{tag}: losses {r.losses} not {R} finite values")
            if not all(bool(torch.isfinite(x).all()) for x in _leaves(r.params)):
                fail(f"{tag}: non-finite parameters")
            ms = sorted(r.round_ms[1:])
            line = (f"{tag}: final acc {r.accs[-1][1]:.4f} final_loss {r.losses[-1]:.6f} ms a "
                    f"round median {ms[len(ms) // 2]:.3f} (first {r.round_ms[0]:.3f})")
            c = r.engine_counts
            if c is not None:
                if not 0 < c["trace_count"] <= 2:
                    fail(f"{tag}: trace_count {c['trace_count']} not in 1..2")
                if c["replays"] + c["eager_chunks"] != chunks:
                    fail(f"{tag}: {c['replays']} replays + {c['eager_chunks']} eager chunks for "
                         f"{chunks} chunks")
                line += (f"; trace_count {c['trace_count']}, replays {c['replays']}, "
                         f"eager_chunks {c['eager_chunks']}")
                if engine == "pipelined":
                    st = c["prefetch_stats"]
                    line += (f"; overlap_fraction {st.overlap_fraction:.4f} (steady "
                             f"{st.steady_overlap_fraction:.4f})")
            print(line)
        return res

    def every_2nd(r):
        return r % 2 == 0 or r == R - 1

    engines = (("loop", "loop", "inline"), ("scan", "scan", "inline"),
               ("pipelined_inline", "pipelined", "inline"),
               ("pipelined_thread", "pipelined", "thread"))
    claims = {}
    for figure, make in (("fig5", figures.fig5_schedule), ("fig6", figures.fig6_schedule)):
        def schedule(make=make):
            return make(N_CLIENTS, seed=7)  # the reference's seed + 7, seed 0

        by_engine = {label: run(f"{figure} {label}", schedule, every_2nd, engine,
                                prefetch=prefetch)
                     for label, engine, prefetch in engines}
        loop = by_engine["loop"]
        for label, res in by_engine.items():
            print(f"channel_figures {figure} {label} rows:")
            figures.print_figure_csv(figure, res)
            print(figures.scheduler_line(figure, res["colrel_adaptive"].policy.stats))
            for name, r in res.items():
                if r.losses != loop[name].losses or not _bitwise_equal(r.params,
                                                                       loop[name].params):
                    fail(f"channel_figures {figure} {label} {name}: losses or parameters differ "
                         f"from the loop's")
        print(f"channel_figures {figure}: scan, pipelined inline and pipelined thread bitwise "
              f"equal to the loop (per-round losses, final parameters) for every policy")
        fin = {name: (r.accs[-1][1], r.losses[-1]) for name, r in loop.items()}
        a, s, b = fin["colrel_adaptive"], fin["colrel_stale"], fin["fedavg_dropout_blind"]
        claims[figure] = ((a[0] >= s[0] >= b[0] and a[1] < s[1] < b[1]) if figure == "fig5"
                          else (a[0] >= b[0] and a[1] <= b[1]))
        if figure != "fig6":
            continue
        # Fig. 6's adaptive run once more as paper-faithful colrel on the
        # mix kernel, and each kernel run against its einsum twin (the same
        # τ and batches), as the figures phase holds its kernel runs
        make_policy = figures.channel_policies()["colrel_adaptive"][1]
        adaptive = {"colrel_adaptive": ("colrel_fused", make_policy)}
        faithful = {"colrel_adaptive": ("colrel", make_policy)}
        pairs = {
            ("colrel_fused", "hopper_fused"): (loop["colrel_adaptive"], adaptive),
            ("colrel", "hopper"): (run("fig6 loop", schedule, every_2nd, "loop", "hopper",
                                       faithful)["colrel_adaptive"], faithful),
        }
        for (strategy, backend), (kernel_run, policies) in pairs.items():
            twin = run("fig6 loop", schedule, every_2nd, "loop", "einsum",
                       policies)["colrel_adaptive"]
            dl = float(np.max(np.abs(np.subtract(kernel_run.losses, twin.losses))))
            dp = max((x - y).abs().max().item()
                     for x, y in zip(_leaves(kernel_run.params), _leaves(twin.params)))
            print(f"channel_figures fig6/colrel_adaptive {strategy}/{backend} vs "
                  f"{strategy}/einsum: max |Δloss| {dl:.3g}, max |Δparam| {dp:.3g} after {R} "
                  f"rounds")
            if dl > LOSS_ATOL or dp > PARAM_ATOL:
                fail(f"channel_figures fig6 {strategy}/{backend} disagrees with einsum: "
                     f"|Δloss| {dl} |Δparam| {dp}")

    corr = {}
    for ell in figures.CORR_SWEEP:
        res = run(f"fig_corr ell={figures.ell_label(ell)} loop",
                  lambda ell=ell: figures.corr_schedule(N_CLIENTS, ell, seed=7),
                  lambda r: r % hold == hold - 1 or r == R - 1, "loop")
        corr.update({f"{name}@ell={figures.ell_label(ell)}": r for name, r in res.items()})
    figures.print_figure_csv("fig_corr", corr)
    sweep = figures.sweep_mean_line(corr)
    print(sweep)
    claims["fig_corr"] = all(f"{check}=True" in sweep.split(";") for check in (
        "adaptive_ge_stale_ge_fedavg_acc", "adaptive_le_stale_le_fedavg_loss"))
    print("channel_figures claims (not gated): fig5 adaptive > stale > FedAvg in final loss, "
          f">= in final accuracy {claims['fig5']}; fig6 adaptive >= FedAvg in final accuracy "
          f"and <= in final loss {claims['fig6']}; fig_corr adaptive >= stale >= FedAvg in mean "
          f"accuracy and <= in mean final loss {claims['fig_corr']}")
    return launches


def phase_claims() -> dict:
    """The quadratic oracle's three claims on the card with the port's own
    τ from a CUDA generator (``repro_torch.bench.claims``), every run on
    ``hopper_fused``; see the module docstring.  Returns each kernel's
    launches."""
    from repro_torch.bench import claims
    from repro_torch.kernels import relay_mix as k

    if claims.N_CLIENTS not in SWEEP_N or claims.DIM not in SWEEP_D:
        fail(f"claims: the kernels phase does not check its shape "
             f"({claims.N_CLIENTS}, {claims.DIM})")
    q = claims.quadratic_setting(device="cuda")
    k.reset_launches()
    out = claims.check_claims(q, relay_backend="hopper_fused")
    launches = dict(k.LAUNCHES)
    n_runs = sum(len(v) for v in out["errors"].values())
    want = {"relay_mix_2d": 0, "fused_aggregate_2d": n_runs * claims.ROUNDS}
    for name, errs in out["errors"].items():
        print(f"claims errors {name} by seed {list(claims.SEEDS[:len(errs)])}: {errs}")
    for name, c in out["claims"].items():
        print(f"claims {name}: {c['value']:.6g} < {c['bound']:.6g}: {c['holds']}")
    if launches != want:
        fail(f"claims: kernel launches {launches}, expected {want}")
    if not all(math.isfinite(e) for errs in out["errors"].values() for e in errs):
        fail("claims: non-finite error")
    broken = [name for name, c in out["claims"].items() if not c["holds"]]
    if broken:
        fail(f"claims: {broken} do not hold on the card")
    return launches


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
    full_chunks = sum(n // ENGINE_CHUNK for n in lengths)
    print(f"engines: {len(segs)} epochs of lengths {lengths} in {ENGINE_ROUNDS} rounds, "
          f"{chunks} chunks of at most {ENGINE_CHUNK}, {full_chunks} of them full")
    if len(segs) < 3 or all(n % ENGINE_CHUNK == 0 for n in lengths) or not full_chunks:
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
            policy = channels.AdaptiveOptAlpha(sweeps=40, warm_sweeps=12)
            loader = FederatedLoader(ds, parts, seed=0)
            params = init_resnet20(0, CONFIG)
            state = sim.init_server_state(params)
            gen = torch.Generator(device="cuda").manual_seed(42)
            kw = dict(schedule=schedule(), rounds=ENGINE_ROUNDS, policy=policy, lr=LR,
                      next_batch=lambda: loader.round_batch(LOCAL_STEPS, LOCAL_BATCH))
            eng = None
            torch.cuda.synchronize()
            k.reset_launches()
            t0 = time.perf_counter()
            if engine == "loop":
                res = run_rounds_loop(sim, gen, params, state, **kw)
            elif engine == "scan":
                eng = EpochScanEngine(sim, chunk=ENGINE_CHUNK)
                res = eng.run_schedule(gen, params, state, **kw)
            else:
                eng = PipelinedScanEngine(sim, chunk=ENGINE_CHUNK,
                                          prefetch=engine.removeprefix("pipelined_"))
                res = eng.run_schedule(gen, params, state, **kw)
            torch.cuda.synchronize()
            total_ms = (time.perf_counter() - t0) * 1e3
            launches = dict(k.LAUNCHES)
            params, state, metrics, gen = res
            tag = f"{strategy}/{backend} {engine}"
            run = {"params": params, "state": state, "metrics": metrics,
                   "gen": gen.get_state(), "stats": policy.stats, "launches": launches}
            line = (f"engines {tag}: {total_ms / ENGINE_ROUNDS:.3f} ms a round over "
                    f"{ENGINE_ROUNDS} rounds, first calls and captures included; OPT-α "
                    f"solves {policy.stats.solves}, cache hits {policy.stats.cache_hits}; "
                    f"launches {launches}")
            if eng is not None:
                # full chunks replayed from CUDA graphs, remainders eager
                line += (f"; trace_count {eng.trace_count}, replays {eng.replays}, "
                         f"eager_chunks {eng.eager_chunks}")
                if not 0 < eng.trace_count <= 2:
                    fail(f"{tag}: trace_count {eng.trace_count} not in 1..2")
                if eng.replays + eng.eager_chunks != chunks or eng.replays != full_chunks:
                    fail(f"{tag}: {eng.replays} replays + {eng.eager_chunks} eager chunks "
                         f"for {chunks} chunks, {full_chunks} of them full")
            if isinstance(eng, PipelinedScanEngine):
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
    for kn, n in engine_timing().items():
        launches_total[kn] = launches_total.get(kn, 0) + n
    return launches_total


def engine_timing() -> dict:
    """The timing run of the engines phase: one channel epoch of
    ``TIMING_ROUNDS`` rounds of ResNet-20/GN at n = 10 through
    ``EpochScanEngine.run_segment`` in chunks of ``TIMING_CHUNK`` on each
    kernel backend, eager (``capture=False``, after one warm-up run) and
    replayed (the first run captures), ``TIMING_RUNS`` timed runs each, on
    the same batches and τ.  Gates: the replayed runs bitwise equal to the
    eager ones, one capture, every chunk replayed.  Prints ms a round
    (median), the capture's ms, the graph pool's bytes beside one eager
    round's peak activations, and the device busy share of one replayed
    chunk under the profiler.  Returns each kernel's launches."""
    import statistics

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.resnet20_cifar import CONFIG
    from repro_torch.core import connectivity, opt_alpha, topology
    from repro_torch.data.loader import FederatedLoader
    from repro_torch.data.partition import iid_partition
    from repro_torch.data.synthetic import cifar_like
    from repro_torch.fl.engine import EpochScanEngine
    from repro_torch.fl.simulator import FLSimulator
    from repro_torch.kernels import relay_mix as k
    from repro_torch.models.resnet import init_resnet20, resnet20_loss

    p = connectivity.paper_heterogeneous().p
    A = opt_alpha.optimize(p, topology.ring(N_CLIENTS, k=1), sweeps=50).A
    ds = cifar_like(N_TRAIN, seed=0)
    loader = FederatedLoader(ds, iid_partition(ds, N_CLIENTS, seed=0), seed=0)
    host = [loader.round_batch(LOCAL_STEPS, LOCAL_BATCH) for _ in range(TIMING_ROUNDS)]
    batches = {key: torch.as_tensor(np.stack([b[key] for b in host]), device="cuda")
               for key in host[0]}
    params0 = init_resnet20(0, CONFIG)
    launches = dict.fromkeys(k.LAUNCHES, 0)
    for strategy, backend in (("colrel", "hopper"), ("colrel_fused", "hopper_fused")):
        sim = FLSimulator(lambda prm, b: resnet20_loss(prm, CONFIG, b), n_clients=N_CLIENTS,
                          strategy=strategy, A=A, p=p, local_steps=LOCAL_STEPS,
                          relay_backend=backend)
        gen = torch.Generator(device="cuda").manual_seed(42)
        taus = torch.stack([sim.sample_tau(gen) for _ in range(TIMING_ROUNDS)])
        state = sim.init_server_state(params0)

        def once(eng, rounds=TIMING_ROUNDS):
            sub = {key: x[:rounds] for key, x in batches.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = eng.run_segment(params0, state, sub, taus[:rounds], LR)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3, res

        k.reset_launches()
        eager = EpochScanEngine(sim, chunk=TIMING_CHUNK, capture=False)
        once(eager)  # warm-up: cuDNN's, cuBLAS's and torch.func's first calls
        eager_runs = [once(eager) for _ in range(TIMING_RUNS)]
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        once(eager, 1)
        round_peak = torch.cuda.max_memory_allocated() - base
        graphed = EpochScanEngine(sim, chunk=TIMING_CHUNK)
        reserved = torch.cuda.memory_reserved()
        first_ms, first = once(graphed)
        pool = torch.cuda.memory_reserved() - reserved
        replay_runs = [once(graphed) for _ in range(TIMING_RUNS)]
        for kn in launches:
            launches[kn] += k.LAUNCHES[kn]
        tag = f"{strategy}/{backend}"
        for _, (rp, rs, rm) in [(first_ms, first)] + replay_runs:
            if not (_bitwise_equal(rp, eager_runs[0][1][0]) and _bitwise_equal(rm, eager_runs[0][1][2])):
                fail(f"engine timing {tag}: a replayed run differs from the eager run")
        if (graphed.trace_count, graphed.eager_chunks) != (1, 0):
            fail(f"engine timing {tag}: trace_count {graphed.trace_count}, eager chunks "
                 f"{graphed.eager_chunks}; expected 1 capture and every chunk replayed")
        eager_ms = statistics.median(t for t, _ in eager_runs) / TIMING_ROUNDS
        replay_ms = statistics.median(t for t, _ in replay_runs) / TIMING_ROUNDS
        capture_ms = first_ms - replay_ms * TIMING_ROUNDS
        # one replayed chunk under the profiler (after the counted runs)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            once(graphed, TIMING_CHUNK)
            wall_ms = (time.perf_counter() - t0) * 1e3
        busy_ms, n_act = device_busy_ms(prof)
        busy = (f"device busy {busy_ms:.3f} of {wall_ms:.3f} ms "
                f"({100 * busy_ms / wall_ms:.1f}%, {n_act} device activities) in one "
                f"replayed chunk of {TIMING_CHUNK} rounds (profiled)" if busy_ms else
                "device busy share of a replayed chunk: not measured (the profiler "
                "recorded no device time)")
        print(f"engine timing {tag} (ResNet-20/GN, n = {N_CLIENTS}, one {TIMING_ROUNDS}-round "
              f"epoch in chunks of {TIMING_CHUNK}, median of {TIMING_RUNS}): eager "
              f"{eager_ms:.3f} ms a round {[round(t / TIMING_ROUNDS, 3) for t, _ in eager_runs]}, "
              f"replayed {replay_ms:.3f} ms a round "
              f"{[round(t / TIMING_ROUNDS, 3) for t, _ in replay_runs]} "
              f"({eager_ms / replay_ms:.2f}x); capture {capture_ms:.3f} ms "
              f"({capture_ms / (eager_ms * TIMING_CHUNK):.2f} eager chunks); graph pool "
              f"{pool / 1e6:.1f} MB beside {round_peak / 1e6:.1f} MB of one eager round's peak "
              f"activations; {busy}; replayed bitwise equal to eager")
        del eager, graphed, eager_runs, replay_runs, first
        torch.cuda.empty_cache()
    return launches


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
            if run.trace_count is not None and run.trace_count > 2:
                fail(f"bench {name} {engine}: trace_count {run.trace_count} > 2")
            if not all(math.isfinite(x) for x in run.losses):
                fail(f"bench {name} {engine}: non-finite loss {run.losses}")
        if kernel is not None and not (check and check["allclose"]
                                       and check["max_abs_diff"] <= harness.KERNEL_CHECK_ATOL):
            fail(f"bench {name}: kernel check {check}")
        if name in BENCH_MODEL_PARAMS and result["model_params"] != BENCH_MODEL_PARAMS[name]:
            fail(f"bench {name}: model_params {result['model_params']}, "
                 f"expected {BENCH_MODEL_PARAMS[name]}")
        engines = "; ".join(
            f"{e} {r.rounds_per_sec:.3f} rounds/s compile_s {r.compile_s:.3f} "
            f"trace_count {r.trace_count}"
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


def phase_suite() -> dict:
    """The suite's kernel, OPT-α and roofline rows; see the module
    docstring for the gates.  Returns each kernel's launches over the kernel
    rows and, per kernel, each row's times, bound and error against the
    plain version."""
    from repro_torch.bench import kernel_bench, opt_alpha_bench, roofline, tables
    from repro_torch.kernels import ref
    from repro_torch.kernels import relay_mix as k
    from repro_torch.launch import dryrun

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    k.reset_launches()
    rows = {(name, tag): us for tag in SUITE_DTYPES
            for name, us, _ in kernel_bench.run(full=True, dtype=tag)}
    launches = dict(k.LAUNCHES)
    if not all(launches.values()):
        fail(f"suite: a kernel of the rows was never launched: {launches}")

    # each kernel against its plain version on the rows' inputs, then the
    # fused plain version and the library calls timed on the same copies
    # (the mix's plain time is the einsum_ref row's)
    n, out = kernel_bench.N, {"relay_mix_2d": [], "fused_aggregate_2d": []}
    for tag in SUITE_DTYPES:
        dt = kernel_bench.DTYPES[tag]
        rtol = RTOL_BF16 if tag == "bf16" else RTOL_F32
        itemsize = torch.empty((), dtype=dt).element_size()
        A, c, deltas = kernel_bench.draw_inputs(kernel_bench.FULL_SIZES, dt, dev)
        for D, d in deltas:
            e_mix = check_close(f"suite relay_mix_2d D={D} {tag}", k.relay_mix_2d(A, d),
                                ref.relay_mix_2d(A.to(dt), d), rtol)
            e_fused = check_close(f"suite fused_aggregate_2d D={D} {tag}",
                                  k.fused_aggregate_2d(c, d),
                                  ref.fused_aggregate_2d(c.to(dt), d), rtol)
            ds = kernel_bench.delta_copies(d)
            reps = kernel_bench.graph_reps(d)
            mix_args, fused_args = [(A, x) for x in ds], [(c, x) for x in ds]
            timed = {
                "relay_mix_2d": (
                    e_mix, "hopper", kernel_bench.mix_bound_ms(n, D, itemsize),
                    rows[f"relay_kernel/D{D}/einsum_ref", tag] / 1e3,
                    device_ms(lambda A_, d_: torch.matmul(A_.to(d_.dtype), d_), mix_args,
                              reps)),
                "fused_aggregate_2d": (
                    e_fused, "hopper_fused", kernel_bench.fused_bound_ms(n, D, itemsize),
                    device_ms(lambda c_, d_: ref.fused_aggregate_2d(c_.to(d_.dtype), d_),
                              fused_args, reps),
                    device_ms(lambda c_, d_: c_.to(d_.dtype) @ d_, fused_args, reps)),
            }
            for name, (err, row, (b_ms, b_by), plain_ms, lib_ms) in timed.items():
                t = {"shape": [n, D], "dtype": tag,
                     "ms": rows[f"relay_kernel/D{D}/{row}", tag] / 1e3,
                     "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "max_abs_err": err}
                out[name].append(t)
                print(f"suite {name} (n={n}, D={D}, {tag}, {len(ds)} Δ copies; within "
                      f"atol {ATOL} rtol {rtol:.3g} of the plain version): "
                      + json.dumps({key: v for key, v in t.items()
                                    if key not in ("shape", "dtype")}))
            del ds, mix_args, fused_args
        del A, c, deltas
        torch.cuda.empty_cache()

    for name, us, derived in opt_alpha_bench.run():
        fields = dict(kv.split("=") for kv in derived.split(";"))
        if not (math.isfinite(us) and 0.0 < float(fields["S_opt"]) <= float(fields["S_init"])):
            fail(f"suite {name}: {us} µs a sweep, {derived}")

    arch, shape = SUITE_DRYRUN
    rec = dryrun.run_one(arch, shape, multi_pod=False)
    if rec["status"] != "ok":
        fail(f"suite: dry run {arch} {shape}: {rec.get('error')}")
    lines = roofline.table("pod16x16")
    md = tables.tables("roofline")
    print("\n".join(md))
    if not any(line.startswith(f"roofline/pod16x16/{arch}/{shape},")
               and "collective=n/a" in line for line in lines):
        fail(f"suite: no roofline row for the dry run of {arch} {shape}")
    if any("16 GB" in line for line in lines + md):
        fail("suite: a roofline row judged against 16 GB")
    relay = roofline.relay_table()
    if not any(line.startswith("relay/relay_sweep_1e7,") for line in relay):
        fail(f"suite: no relay row for the bench phase's relay_sweep_1e7 report: {relay}")
    print(f"suite: {time.perf_counter() - t0:.1f} s; kernel-row launches {launches}")
    return {"launches": launches, "rows": out}


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
        if name in SPARSE_ROUNDS:
            spec = dataclasses.replace(spec, rounds=SPARSE_ROUNDS[name])
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


def phase_service() -> dict:
    """The continuous-training service (``repro_torch.launch``) on ResNet-20/GN
    at full width under the Fig. 6 channel with churn; see the module
    docstring for the gates.  Returns each kernel's launches over the
    phase."""
    import shutil
    import tempfile

    import numpy as np

    from repro_torch import channels, checkpoint
    from repro_torch.channels import PoissonDelays
    from repro_torch.configs.resnet20_cifar import CONFIG
    from repro_torch.core.aggregation import ServerOpt
    from repro_torch.data.loader import FederatedLoader
    from repro_torch.data.partition import iid_partition
    from repro_torch.data.synthetic import cifar_like
    from repro_torch.fl.simulator import FLSimulator
    from repro_torch.kernels import relay_mix as k
    from repro_torch.launch.serve import SnapshotEvalLoop
    from repro_torch.launch.train import ContinuousTrainer
    from repro_torch.models.resnet import init_resnet20, resnet20_loss

    ds = cifar_like(N_TRAIN, seed=0)
    parts = iid_partition(ds, N_CLIENTS, seed=0)
    held = cifar_like(LOCAL_BATCH, seed=1)  # the eval loop's held-out batch
    held_batch = {"images": held.inputs, "labels": held.labels}
    held_dev = {key: torch.as_tensor(v, device="cuda") for key, v in held_batch.items()}

    def loss_fn(params, batch):
        return resnet20_loss(params, CONFIG, batch)

    def trainer(strategy, backend, engine, ckpt_dir=None, publish_every=0, delays=None):
        """A trainer rebuilt from seeds: model, stream, policy, generator."""
        sim = FLSimulator(loss_fn, n_clients=N_CLIENTS, strategy=strategy,
                          local_steps=LOCAL_STEPS, relay_backend=backend,
                          server_opt=ServerOpt(momentum=0.9))
        loader = FederatedLoader(ds, parts, seed=0)
        t = ContinuousTrainer(
            sim, schedule=fig6_schedule(), lr=LR, engine=engine, chunk=SERVICE_BURST,
            policy=channels.AdaptiveOptAlpha(sweeps=40, warm_sweeps=12), delays=delays,
            next_batch=lambda: loader.round_batch(LOCAL_STEPS, LOCAL_BATCH),
            ckpt_dir=ckpt_dir, publish_every=publish_every, keep=0)
        t.init(init_resnet20(0, CONFIG), torch.Generator(device="cuda").manual_seed(42))
        return t

    def run(t, rounds, tag, kernel, **kw):
        """``t.run(rounds)`` with its launches counted from 0 and gated."""
        torch.cuda.synchronize()
        k.reset_launches()
        t0 = time.perf_counter()
        metrics = t.run(rounds, **kw)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / rounds
        launches = dict(k.LAUNCHES)
        want = {name: rounds if name == kernel else 0 for name in launches}
        if launches != want:
            fail(f"service {tag}: kernel launches {launches}, expected {want}")
        if metrics["loss"].shape != (rounds,) or not np.isfinite(metrics["loss"]).all():
            fail(f"service {tag}: losses {metrics['loss']} not {rounds} finite values")
        for kn in totals:
            totals[kn] += launches[kn]
        return metrics, ms

    def same_state(a, b, a_metrics, b_metrics, what):
        for part in ("params", "server_state"):
            if not _bitwise_equal(getattr(a, part), getattr(b, part)):
                fail(f"service {what}: {part} differ")
        for key in b_metrics:
            if not np.array_equal(a_metrics[key], b_metrics[key]):
                fail(f"service {what}: per-round {key} differ")
        if not torch.equal(a.generator.get_state(), b.generator.get_state()):
            fail(f"service {what}: generator state differs")

    totals = dict.fromkeys(k.LAUNCHES, 0)
    work = tempfile.mkdtemp(prefix="service_", dir=os.path.join(ROOT, "build"))
    try:
        for strategy, backend, kernel, engines in (
                ("colrel_fused", "hopper_fused", "fused_aggregate_2d",
                 ("loop", "scan", "pipelined")),
                ("colrel", "hopper", "relay_mix_2d", ("loop",))):
            for engine in engines:
                tag = f"{strategy}/{backend} {engine}"
                ref = trainer(strategy, backend, engine)
                ref_m, ms = run(ref, SERVICE_ROUNDS, f"{tag} uninterrupted", kernel)

                # bursts published every SERVICE_BURST rounds, followed by
                # the eval loop as each snapshot lands
                d = os.path.join(work, f"{strategy}_{engine}")
                loop = SnapshotEvalLoop(d, params_like=init_resnet20(1, CONFIG),
                                        eval_fn=loss_fn)
                burst = trainer(strategy, backend, engine, d, SERVICE_BURST)
                seen, worst = [], 0.0

                def on_publish(path, rnd, burst=burst, loop=loop, seen=seen):
                    nonlocal worst
                    if not loop.poll() or loop.round != rnd:
                        fail(f"service {tag}: eval loop missed the round-{rnd} snapshot")
                    got = loop.eval_batch(held_batch)
                    want = float(loss_fn(burst.params, held_dev))
                    worst = max(worst, abs(got - want))
                    seen.append(rnd)

                burst_m, burst_ms = run(burst, SERVICE_ROUNDS, f"{tag} bursts", kernel,
                                        on_publish=on_publish)
                same_state(burst, ref, burst_m, ref_m, f"{tag} bursts vs one run")
                want_rounds = list(range(SERVICE_BURST, SERVICE_ROUNDS + 1, SERVICE_BURST))
                if seen != want_rounds or worst > 1e-6:
                    fail(f"service {tag}: eval loop saw rounds {seen} (expected "
                         f"{want_rounds}), max |Δloss| {worst}")

                # a crash after the round-SERVICE_CRASH snapshot; a trainer
                # rebuilt from seeds restores it, replays the stream, runs on
                d2 = os.path.join(work, f"{strategy}_{engine}_crashed")
                run(trainer(strategy, backend, engine, d2, SERVICE_BURST), SERVICE_CRASH,
                    f"{tag} crashed run", kernel)
                resumed = trainer(strategy, backend, engine, d2, SERVICE_BURST)
                if not resumed.restore_latest() or resumed.round != SERVICE_CRASH:
                    fail(f"service {tag}: restore_latest gave round {resumed.round}")
                resumed.advance_stream()
                res_m, _ = run(resumed, SERVICE_ROUNDS - SERVICE_CRASH, f"{tag} resumed",
                               kernel)
                same_state(resumed, ref, res_m,
                           {key: v[SERVICE_CRASH:] for key, v in ref_m.items()},
                           f"{tag} resumed vs rounds {SERVICE_CRASH + 1}–{SERVICE_ROUNDS}")
                captures = getattr(ref._engine, "trace_count", None)
                if captures is not None and captures > 2:
                    fail(f"service {tag}: trace_count {captures} > 2")
                print(f"service {tag}: {ms:.3f} ms a round uninterrupted (trace_count "
                      f"{captures}), {burst_ms:.3f} "
                      f"with a publish every {SERVICE_BURST}; bursts and the resume from "
                      f"round {SERVICE_CRASH} bitwise equal to one {SERVICE_ROUNDS}-round "
                      f"run (params, server state, loss/τ/delta_norm, generator state); "
                      f"eval loop followed rounds {seen}, max |Δloss| {worst:.3g}")

        # the async engine keeps its arrival buffer across bursts
        runs = []
        for every in (0, SERVICE_BURST):
            t = trainer("colrel_fused", "hopper_fused", "async", publish_every=every,
                        delays=PoissonDelays(N_CLIENTS, rate=1.0, max_delay=8, seed=11))
            m, ms = run(t, SERVICE_ROUNDS, f"async publish_every {every}",
                        "fused_aggregate_2d")
            runs.append((t, m, ms))
        same_state(runs[1][0], runs[0][0], runs[1][1], runs[0][1],
                   "async bursts vs one call")
        print(f"service colrel_fused/hopper_fused async Poisson(1.0) max_delay 8: "
              f"{runs[0][2]:.3f} ms a round in one call, {runs[1][2]:.3f} in bursts of "
              f"{SERVICE_BURST}; bitwise equal (params, server state, loss/τ/delta_norm, "
              f"generator state)")

        # publish and restore of the ResNet-20/GN snapshot (params + momentum)
        t = ref
        pub_ms, res_ms = [], []
        d = os.path.join(work, "timing")
        for i in range(SERVICE_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            path = checkpoint.publish(d, params=t.params, server_state=t.server_state,
                                      generator=t.generator, round=i, keep=2)
            pub_ms.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            params, state, gen, _ = checkpoint.restore_training_state(
                path, params_like=t.params, server_state_like=t.server_state)
            torch.cuda.synchronize()
            res_ms.append((time.perf_counter() - t0) * 1e3)
            if not (_bitwise_equal(params, t.params) and _bitwise_equal(state, t.server_state)
                    and torch.equal(gen.get_state(), t.generator.get_state())):
                fail("service: restore_training_state is not the published state")
        size = os.path.getsize(path)
        print(f"service checkpoint ({size} bytes, params + server momentum + generator): "
              f"publish {np.median(pub_ms):.3f} ms, restore_training_state "
              f"{np.median(res_ms):.3f} ms (median of {SERVICE_REPS}; all {pub_ms} / "
              f"{res_ms})")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return totals


def phase_distributed() -> dict:
    """The distributed round steps (``repro_torch.fl.distributed``), the
    sharded engine over an NCCL world of one rank, and the mesh bench
    scenario; see the module docstring for the gates.  Returns each
    kernel's launches over the phase."""
    import shutil
    import tempfile

    import numpy as np
    import torch.distributed as dist

    from repro_torch import channels
    from repro_torch.bench import harness, report, scenarios
    from repro_torch.configs.resnet20_cifar import CONFIG
    from repro_torch.core import connectivity, opt_alpha, topology
    from repro_torch.data.loader import FederatedLoader
    from repro_torch.data.partition import iid_partition
    from repro_torch.data.synthetic import cifar_like
    from repro_torch.fl.distributed import (
        build_fused_scan_round_step,
        build_round_step,
        build_scan_round_step,
        build_sharded_scan_round_step,
    )
    from repro_torch.fl.engine import ShardedScanEngine
    from repro_torch.kernels import relay_mix as k
    from repro_torch.launch.mesh import make_client_mesh
    from repro_torch.models.resnet import init_resnet20, resnet20_loss

    ds = cifar_like(N_TRAIN, seed=0)
    parts = iid_partition(ds, N_CLIENTS, seed=0)
    p = connectivity.paper_heterogeneous().p
    A = opt_alpha.optimize(p, topology.ring(N_CLIENTS, k=1), sweeps=50).A
    p_dev = torch.as_tensor(p, dtype=torch.float32, device="cuda")

    def loss_fn(params, batch):
        return resnet20_loss(params, CONFIG, batch)

    loader = FederatedLoader(ds, parts, seed=0)
    batches = [loader.round_batch(LOCAL_STEPS, LOCAL_BATCH) for _ in range(DIST_ROUNDS)]
    stacked = {key: np.stack([b[key] for b in batches]) for key in batches[0]}
    host_gen = torch.Generator(device="cuda").manual_seed(42)
    taus = [torch.bernoulli(p_dev, generator=host_gen) for _ in range(DIST_ROUNDS)]
    kw = dict(n_clients=N_CLIENTS, local_steps=LOCAL_STEPS)
    totals = dict.fromkeys(k.LAUNCHES, 0)

    def timed(tag, fn, rounds, want):
        """Run ``fn()`` from zero counts; check its launches against ``want``
        (kernel → launches a round) and print its ms a round."""
        torch.cuda.synchronize()
        k.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / rounds
        launches = dict(k.LAUNCHES)
        expect = {kn: want.get(kn, 0) * rounds for kn in launches}
        if launches != expect:
            fail(f"distributed {tag}: kernel launches {launches}, expected {expect}")
        for kn in totals:
            totals[kn] += launches[kn]
        print(f"distributed {tag}: {ms:.3f} ms a round over {rounds} rounds (the first "
              f"includes warm-up); launches {launches}")
        return out

    def per_round(step, params, rounds_batches, round_taus):
        losses = []
        for batch, tau in zip(rounds_batches, round_taus):
            params, _, loss = step(params, None, batch, tau, LR)
            losses.append(loss)
        return params, torch.stack(losses)

    # single device: the per-round step in both relay modes on each kernel
    # and on einsum, then the epoch steps on hopper_fused
    params0 = init_resnet20(0, CONFIG)
    runs = {}
    for mode, backend, kernel in (("faithful", "hopper", "relay_mix_2d"),
                                  ("faithful", "einsum", None),
                                  ("fused", "hopper_fused", "fused_aggregate_2d"),
                                  ("fused", "einsum", None)):
        step = build_round_step(loss_fn, A=A, relay_mode=mode, relay_backend=backend, **kw)
        runs[mode, backend] = timed(f"build_round_step {mode}/{backend}",
                                    lambda step=step: per_round(step, params0, batches, taus),
                                    DIST_ROUNDS, {kernel: 1} if kernel else {})
    for mode, backend in (("faithful", "hopper"), ("fused", "hopper_fused")):
        (pk, lk), (pe, le) = runs[mode, backend], runs[mode, "einsum"]
        dp = max((x - y).abs().max().item() for x, y in zip(_leaves(pk), _leaves(pe)))
        dl = (lk - le).abs().max().item()
        print(f"distributed {mode}/{backend} vs {mode}/einsum: max |Δparam| {dp:.3g}, "
              f"max |Δloss| {dl:.3g} after {DIST_ROUNDS} rounds")
        if not (math.isfinite(dp) and dp <= PARAM_ATOL and dl <= LOSS_ATOL):
            fail(f"distributed {mode}/{backend} disagrees with einsum: {dp} {dl}")
    ref_p, ref_l = runs["fused", "hopper_fused"]
    fused_kw = dict(relay_mode="fused", relay_backend="hopper_fused", **kw)
    scan = build_scan_round_step(loss_fn, **fused_kw)
    sp, _, sl = timed("build_scan_round_step fused/hopper_fused",
                      lambda: scan(params0, None, stacked, torch.stack(taus), LR, A=A),
                      DIST_ROUNDS, {"fused_aggregate_2d": 1})
    fused = build_fused_scan_round_step(loss_fn, **fused_kw)
    gen, fp, _, fl = timed(
        "build_fused_scan_round_step fused/hopper_fused",
        lambda: fused(torch.Generator(device="cuda").manual_seed(42), params0, None,
                      stacked, p, LR, A=A),
        DIST_ROUNDS, {"fused_aggregate_2d": 1})
    if not (_bitwise_equal(sp, ref_p) and torch.equal(sl, ref_l)):
        fail("distributed: the scan step differs from the per-round step")
    if not (_bitwise_equal(fp, ref_p) and torch.equal(fl, ref_l)
            and torch.equal(gen.get_state(), host_gen.get_state())):
        fail("distributed: the fused scan step differs from host τ draws + the round step")
    print(f"distributed: scan and fused scan steps bitwise equal to {DIST_ROUNDS} per-round "
          "steps on the same τ (params, losses; the fused scan's generator state equal to "
          "the host draws')")
    batch1 = loader.round_batch(1, LOCAL_BATCH)
    weighted = build_round_step(loss_fn, n_clients=N_CLIENTS, local_steps=1, A=A,
                                relay_mode="fused", relay_backend="hopper_fused")
    per_client = build_round_step(loss_fn, n_clients=N_CLIENTS, local_steps=1, A=A,
                                  relay_mode="faithful", relay_backend="hopper")
    wp, _, wl = timed("T = 1 weighted-loss step fused/hopper_fused",
                      lambda: weighted(params0, None, batch1, taus[0], LR), 1, {})
    cp, _, cl = timed("T = 1 per-client step faithful/hopper",
                      lambda: per_client(params0, None, batch1, taus[0], LR), 1,
                      {"relay_mix_2d": 1})
    dp = max((x - y).abs().max().item() for x, y in zip(_leaves(wp), _leaves(cp)))
    print(f"distributed T = 1: weighted-loss vs per-client max |Δparam| {dp:.3g}, "
          f"|Δloss| {abs(float(wl) - float(cl)):.3g}")
    if not (dp <= ATOL and abs(float(wl) - float(cl)) <= ATOL):
        fail(f"distributed T = 1: weighted-loss step off the per-client step by {dp}")

    # sharded: the engine over an NCCL world of one rank, against the
    # single-device loop and fused engine on the same churned schedule
    def walk(engine):
        loader_ = FederatedLoader(ds, parts, seed=0)
        policy = channels.AdaptiveOptAlpha(sweeps=40, warm_sweeps=12)
        sched = fig6_schedule()
        gen_ = torch.Generator(device="cuda").manual_seed(42)
        params = init_resnet20(0, CONFIG)
        next_batch = lambda: loader_.round_batch(LOCAL_STEPS, LOCAL_BATCH)  # noqa: E731
        if not isinstance(engine, str):
            params, _, metrics, gen_ = engine.run_schedule(
                gen_, params, None, schedule=sched, rounds=SHARD_ROUNDS,
                next_batch=next_batch, lr=SHARD_LR, policy=policy)
            return params, metrics["loss"], gen_.get_state()
        step = (build_round_step if engine == "loop" else build_fused_scan_round_step)(
            loss_fn, **fused_kw)
        losses = []
        for seg in sched.segments(SHARD_ROUNDS):
            A_seg = policy.relay_matrix(seg.state)
            p_seg = torch.as_tensor(seg.p, dtype=torch.float32, device="cuda")
            act = (None if seg.active is None else
                   torch.as_tensor(seg.active, dtype=torch.float32, device="cuda"))
            host = [next_batch() for _ in range(seg.n_rounds)]
            if engine == "loop":
                for b in host:
                    tau = torch.bernoulli(p_seg, generator=gen_)
                    params, _, loss = step(params, None, b, tau, SHARD_LR, A=A_seg,
                                           active=act)
                    losses.append(loss.reshape(1))
            else:
                seg_b = {key: np.stack([b[key] for b in host]) for key in host[0]}
                gen_, params, _, seg_l = step(gen_, params, None, seg_b, p_seg, SHARD_LR,
                                              A=A_seg, active=act)
                losses.append(seg_l)
        return params, torch.cat(losses), gen_.get_state()

    seg_list = list(fig6_schedule().segments(SHARD_ROUNDS))
    segs = [s.n_rounds for s in seg_list]
    keys = len({(s.n_rounds, s.active is None) for s in seg_list})
    fused_ref = timed("single-device fused engine (fused scan step an epoch) hopper_fused",
                      lambda: walk("fused"), SHARD_ROUNDS, {"fused_aggregate_2d": 1})
    loop_ref = timed("single-device loop (round step, host τ) hopper_fused",
                     lambda: walk("loop"), SHARD_ROUNDS, {"fused_aggregate_2d": 1})
    if not (_bitwise_equal(loop_ref[0], fused_ref[0]) and torch.equal(loop_ref[1], fused_ref[1])
            and torch.equal(loop_ref[2], fused_ref[2])):
        fail("distributed: the single-device loop differs from the fused engine")
    work = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    dist.init_process_group("nccl", init_method=f"file://{work}/store", world_size=1, rank=0)
    try:
        print(f"distributed sharded: world size {dist.get_world_size()} over NCCL "
              f"(epochs {segs} under the Fig. 6 channel with churn); multi-rank exchange is "
              "not measured on one card")
        uncaptured = None
        for tag, shard, exchange, backend, capture in (
                ("gather", "clients", "gather", "hopper_fused", False),
                ("gather", "clients", "gather", "hopper_fused", True),
                ("ring", "clients", "ring", "einsum", True),
                ("d", "d", "gather", "einsum", True)):
            mesh = make_client_mesh(axis="clients" if shard == "clients" else "model")
            step = build_sharded_scan_round_step(
                loss_fn, mesh=mesh, shard=shard, exchange=exchange, relay_mode="fused",
                relay_backend=backend, **kw)
            eng = ShardedScanEngine(step, mesh=mesh, shard=shard, prefetch="inline",
                                    capture=capture)
            want = {"fused_aggregate_2d": 1} if backend == "hopper_fused" else {}
            how = "captured" if capture else "eager"
            got = timed(f"ShardedScanEngine {tag} {shard}/{backend} {how} (world size "
                        f"{mesh.size}; trace_count counted below)", lambda eng=eng: walk(eng),
                        SHARD_ROUNDS, want)
            print(f"distributed {tag} {how}: trace_count {eng.trace_count}, replays "
                  f"{eng.replays}, eager epochs {eng.eager_chunks}")
            if eng.dispatches != len(segs):
                fail(f"distributed {tag}: {eng.dispatches} calls for {len(segs)} epochs")
            if eng.trace_count != (keys if capture else 0):
                fail(f"distributed {tag} {how}: trace_count {eng.trace_count}, expected "
                     f"{keys if capture else 0} (distinct epoch lengths and masks)")
            if not capture:
                uncaptured = got
                continue
            if tag == "gather" and not (_bitwise_equal(got[0], uncaptured[0])
                                        and torch.equal(got[1], uncaptured[1])
                                        and torch.equal(got[2], uncaptured[2])):
                fail("distributed gather: captured run not bitwise equal to the eager one")
            if not torch.equal(got[2], fused_ref[2]):
                fail(f"distributed {tag}: generator state differs from the fused engine's")
            if tag == "gather":
                if not (_bitwise_equal(got[0], fused_ref[0]) and torch.equal(got[1], fused_ref[1])):
                    fail("distributed gather: not bitwise equal to the fused engine")
                print("distributed gather: captured bitwise equal to eager and to the "
                      "single-device fused engine")
                continue
            dp = max((x - y).abs().max().item() for x, y in zip(_leaves(got[0]),
                                                                _leaves(fused_ref[0])))
            close = all(torch.allclose(x, y, rtol=harness.KERNEL_CHECK_RTOL,
                                       atol=harness.KERNEL_CHECK_ATOL)
                        for x, y in zip(_leaves(got[0]), _leaves(fused_ref[0])))
            print(f"distributed {tag}: max |Δparam| {dp:.3g} against the fused engine "
                  f"(harness tolerance rtol {harness.KERNEL_CHECK_RTOL:g} atol "
                  f"{harness.KERNEL_CHECK_ATOL:g})")
            if not close:
                fail(f"distributed {tag}: off the fused engine by {dp}")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(work, ignore_errors=True)

    # the mesh bench scenario, with the fused kernel's check at its width
    spec = dataclasses.replace(scenarios.get_scenario("mesh_corr_500"), rounds=MESH_ROUNDS,
                               check_backend="hopper_fused")
    t0 = time.perf_counter()
    k.reset_launches()
    result = harness.run_scenario(spec)
    launches = dict(k.LAUNCHES)
    rep = report.make_report(spec, result)
    path = report.write_report(rep, os.path.join(ROOT, "build", "bench_torch"))
    check, runs_ = result["kernel_check"], result["runs"]
    want = {"relay_mix_2d": 0, "fused_aggregate_2d": 2 * spec.rounds}
    if launches != want:
        fail(f"distributed mesh_corr_500: kernel launches {launches}, expected {want}")
    if result["bitwise_match"] is not True or not (
            check and check["allclose"] and check["max_abs_diff"] <= harness.KERNEL_CHECK_ATOL):
        fail(f"distributed mesh_corr_500: bitwise {result['bitwise_match']}, check {check}")
    if result["model_params"] != MESH_SHAPE[1]:
        fail(f"distributed mesh_corr_500: model_params {result['model_params']}")
    for engine, r in runs_.items():
        if not all(math.isfinite(x) for x in r.losses):
            fail(f"distributed mesh_corr_500 {engine}: non-finite loss")
    for kn in totals:
        totals[kn] += launches[kn]
    engines = "; ".join(f"{e} {r.rounds_per_sec:.3f} rounds/s ({1e3 / r.rounds_per_sec:.3f} "
                        f"ms a round) dispatches {r.dispatches}" for e, r in runs_.items())
    print(f"distributed mesh_corr_500 ({spec.rounds} of its 500 rounds, "
          f"{time.perf_counter() - t0:.1f} s on {rep['device']['name']} at "
          f"{rep['device']['power_limit_w']} W): {engines}; kernel_check hopper_fused "
          f"max_abs_diff {check['max_abs_diff']:.3g}; bitwise_match True; model_params "
          f"{result['model_params']}; launches {launches}; report {os.path.relpath(path, ROOT)}")
    return totals


def _lm_batch(cfg, seed: int, B: int, S: int) -> dict:
    """Numpy tokens (B, S + 1) and the family's stub frontend input."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)}
    if cfg.family == "audio":
        out["frame_embeds"] = rng.standard_normal((B, cfg.enc_frames, cfg.d_model)).astype(
            np.float32)
    if cfg.family == "vlm":
        out["img_embeds"] = rng.standard_normal(
            (B, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return out


def _rel_err(got, want) -> float:
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp(min=1e-9)).item()


def _lm_serve() -> None:
    """glm4-9b at full width served through ``launch/serve.py::_decode_demo``
    on the card: init on the device, a warm-up demo, the measured demo, the
    decode/teacher-forcing gate, and one decode step under the profiler."""
    import argparse

    from repro_torch.configs import registry as creg
    from repro_torch.launch.serve import _decode_demo
    from repro_torch.models import get_model
    from repro_torch.utils import tree_flatten, tree_size

    cfg = creg.get_config(LM_SERVE_ARCH, reduced=LM_SERVE_REDUCED)
    md = get_model(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = md.init(0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = tree_size(params)
    if n_params != cfg.param_count():
        fail(f"lm serve {cfg.name}: {n_params} parameters, param_count() {cfg.param_count()}")
    leaves = tree_flatten(params)[0]
    if any(x.device.type != "cuda" for x in leaves):
        fail(f"lm serve {cfg.name}: parameters off the card")
    param_bytes = sum(x.numel() * x.element_size() for x in leaves)
    init_peak = torch.cuda.max_memory_allocated()
    print(f"lm serve {cfg.name} (L={cfg.n_layers}, d_model={cfg.d_model}, "
          f"{cfg.n_heads}H/{cfg.n_kv}KV×{cfg.hd}, d_ff={cfg.d_ff}, vocab={cfg.vocab}, "
          f"{cfg.param_dtype}): {n_params:,} parameters, {param_bytes / 1e9:.3f} GB, "
          f"init on the card {init_s:.3f} s, peak {init_peak / 1e9:.3f} GB")

    warm = argparse.Namespace(batch=LM_BATCH, prompt_len=LM_PROMPT, new_tokens=2, seed=1)
    _decode_demo(md, cfg, params, warm)
    args = argparse.Namespace(batch=LM_BATCH, prompt_len=LM_PROMPT, new_tokens=LM_NEW_TOKENS,
                              seed=0)
    out = _decode_demo(md, cfg, params, args)
    steps = LM_NEW_TOKENS - 1
    if not all(bool(torch.isfinite(x).all()) for x in out["decode_logits"]):
        fail(f"lm serve {cfg.name}: non-finite decode logits")
    # the first decode step against a teacher-forced prefill of the prompt
    # plus the token the prefill chose
    prompt = out["batch"]["tokens"]
    first = torch.as_tensor(out["generated"][:, :1], device=prompt.device, dtype=prompt.dtype)
    with torch.no_grad():
        forced, _ = md.prefill(params, {**out["batch"],
                                        "tokens": torch.cat([prompt, first], dim=1)})
    rel = _rel_err(out["decode_logits"][0], forced)
    if not rel < LM_TF_REL:
        fail(f"lm serve {cfg.name}: decode/teacher-forced relative error {rel:.3g}")
    peak = torch.cuda.max_memory_allocated()
    decode_ms = out["decode_s"] * 1e3 / steps
    # bytes a decode step must move: every parameter but the embedding
    # table's unread rows, and the caches read and written
    table = params["embed"]["table"]
    step_bytes = (param_bytes - table.numel() * table.element_size()
                  + LM_BATCH * cfg.d_model * table.element_size())
    cap = LM_PROMPT + 128  # the prefill's ring capacity (PREFILL_HEADROOM)
    step_bytes += 2 * 2 * cfg.n_layers * LM_BATCH * cap * cfg.n_kv * cfg.hd * 4
    res = {
        "arch": cfg.name, "params": n_params, "param_gb": param_bytes / 1e9,
        "batch": LM_BATCH, "prompt": LM_PROMPT, "new_tokens": LM_NEW_TOKENS,
        "init_s": init_s, "prefill_ms": out["prefill_s"] * 1e3,
        "capture_ms": out["capture_s"] * 1e3, "decode_ms_per_token": decode_ms,
        "decode_tokens_per_s": LM_BATCH * steps / out["decode_s"],
        "decode_bound_ms_param_bytes": param_bytes / PEAK_BYTES_PER_S * 1e3,
        "decode_bound_ms_step_bytes": step_bytes / PEAK_BYTES_PER_S * 1e3,
        "peak_gb": peak / 1e9, "teacher_forced_rel_err": rel,
    }
    print(f"lm serve {cfg.name}: decode vs teacher-forced prefill relative error {rel:.3g} "
          f"(bar {LM_TF_REL:g}); " + json.dumps(res))

    # the same step eager (no graph): ms a token over a few steps, then one
    # step under the profiler, for the device's busy share and launches
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad():
        _, cache = md.prefill(params, out["batch"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(LM_EAGER_STEPS):
            _, step_cache = md.decode(params, cache, first)
        torch.cuda.synchronize()
        eager_ms = (time.perf_counter() - t0) * 1e3 / LM_EAGER_STEPS
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            md.decode(params, cache, first)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    summed_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    busy_ms, _ = device_busy_ms(prof)
    print(f"lm serve eager decode (no graph): {eager_ms:.3f} ms a token over "
          f"{LM_EAGER_STEPS} steps, against {decode_ms:.3f} ms replaying the graph")
    if busy_ms == 0.0:
        print("lm serve profile: the profiler recorded no device time (not measured)")
    else:
        print(f"lm serve profile, one eager decode step: wall {wall_ms:.3f} ms (profiled), "
              f"device busy {busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%; kernel times "
              f"summed {summed_ms:.3f} ms), {sum(e.count for e in kernels)} kernel launches")
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
            print(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:5d}x  {e.key[:90]}")
    del params, out, cache, step_cache, forced, table, leaves
    torch.cuda.empty_cache()


def _lm_reduced() -> None:
    """Every assigned architecture at reduced() on the card: decode against
    teacher forcing, 8 greedy steps finite, and the card's prefill logits
    and loss against the port's CPU run for the same parameters."""
    import dataclasses as dc

    from repro_torch.configs import registry as creg
    from repro_torch.models import get_model
    from repro_torch.utils import tree_map

    dev = torch.device("cuda")
    for arch in creg.ASSIGNED:
        cfg = creg.get_config(arch, reduced=True)
        md = get_model(cfg)
        host = md.init(0, device="cpu")
        params = tree_map(lambda x: x.to(dev), host)
        data = _lm_batch(cfg, 0, LM_B, LM_S)
        cpu_in = {key: torch.from_numpy(v) for key, v in data.items()}
        dev_in = {key: v.to(dev) for key, v in cpu_in.items()}
        extra = lambda d: {key: v for key, v in d.items() if key != "tokens"}  # noqa: E731
        errs = {}
        with torch.no_grad():
            for tag, p_, d_ in (("cpu", host, cpu_in), ("card", params, dev_in)):
                tk = d_["tokens"]
                logits, _ = md.prefill(p_, {"tokens": tk[:, :-1], **extra(d_)})
                loss = md.loss(p_, {"tokens": tk[:, :-1], "labels": tk[:, 1:], **extra(d_)})
                errs[tag] = (logits.cpu(), loss.cpu())
        for name, i in (("prefill logits", 0), ("loss", 1)):
            got, want = errs["card"][i], errs["cpu"][i]
            err = (got - want).abs().max().item()
            if not torch.allclose(got, want, atol=1e-5, rtol=1e-5):
                fail(f"lm {arch}: card {name} off the CPU run by {err:.3g}")
            errs[name] = err
        # decode against teacher forcing (MoE at capacity factor 8, as the
        # reference test: capacity drops depend on the batch)
        if cfg.family == "moe":
            md = get_model(dc.replace(cfg, moe=dc.replace(cfg.moe, capacity_factor=8.0)))
        tk = dev_in["tokens"]
        with torch.no_grad():
            full, _ = md.prefill(params, {"tokens": tk, **extra(dev_in)})
            _, cache = md.prefill(params, {"tokens": tk[:, :-1], **extra(dev_in)})
            dec, cache = md.decode(params, cache, tk[:, -1:])
            rel = _rel_err(dec, full)
            if not rel < LM_TF_REL:
                fail(f"lm {arch}: decode/teacher-forced relative error {rel:.3g}")
            tok = dec[:, -1].argmax(-1)[:, None].int()
            for _ in range(LM_DECODE_STEPS):
                logits, cache = md.decode(params, cache, tok)
                if not bool(torch.isfinite(logits).all()):
                    fail(f"lm {arch}: non-finite logits in greedy decode")
                tok = logits[:, -1].argmax(-1)[:, None].int()
        if int(cache["t"]) != LM_S + 1 + LM_DECODE_STEPS:
            fail(f"lm {arch}: cache position {int(cache['t'])}")
        print(f"lm {arch} reduced: card vs CPU max |Δ| prefill logits "
              f"{errs['prefill logits']:.3g}, loss {errs['loss']:.3g}; decode vs teacher "
              f"forcing {rel:.3g}; {LM_DECODE_STEPS} greedy steps finite")


def _lm_colrel() -> tuple[dict, dict]:
    """ColRel rounds of an LM: each kernel backend against einsum on the same
    τ, batches and parameters.  Returns each kernel's launches over the runs
    and the model widths D."""
    import numpy as np

    from repro_torch.bench import harness
    from repro_torch.configs import registry as creg
    from repro_torch.core import connectivity, opt_alpha, topology
    from repro_torch.data.loader import FederatedLoader
    from repro_torch.data.partition import iid_partition
    from repro_torch.data.synthetic import lm_tokens
    from repro_torch.fl.simulator import FLSimulator
    from repro_torch.kernels import relay_mix as k
    from repro_torch.models import get_model
    from repro_torch.utils import tree_flatten, tree_size

    n = LM_FL_CLIENTS
    conn = connectivity.heterogeneous_profile(n)
    A = opt_alpha.optimize(conn.p, topology.ring(n, 1), sweeps=50).A
    totals = dict.fromkeys(k.LAUNCHES, 0)
    widths = {}
    for arch in LM_FL_ARCHS:
        cfg = creg.get_config(arch, reduced=True)
        md = get_model(cfg)
        ds = lm_tokens(4096, LM_FL_SEQ, vocab=cfg.vocab, seed=0)
        loader = FederatedLoader(ds, iid_partition(ds, n, seed=0), seed=0)
        batches = [loader.round_batch(LM_FL_T, LM_FL_BATCH, lm=True)
                   for _ in range(LM_FL_ROUNDS)]
        widths[arch] = tree_size(md.init(0))
        runs = {}
        for strategy, backend in (("colrel", "hopper"), ("colrel", "einsum"),
                                  ("colrel_fused", "hopper_fused"),
                                  ("colrel_fused", "einsum")):
            sim = FLSimulator(md.loss, n_clients=n, strategy=strategy, A=A, p=conn.p,
                              local_steps=LM_FL_T, relay_backend=backend)
            params = md.init(0)
            state = sim.init_server_state(params)
            gen = torch.Generator(device="cuda").manual_seed(42)
            losses, round_ms = [], []
            torch.cuda.synchronize()
            k.reset_launches()
            for b in batches:
                t0 = time.perf_counter()
                params, state, m = sim.run_round(gen, params, state, b, LM_FL_LR)
                torch.cuda.synchronize()
                round_ms.append((time.perf_counter() - t0) * 1e3)
                losses.append(float(m["loss"]))
            launches = dict(k.LAUNCHES)
            kernel = BENCH_KERNEL.get(backend)
            want = {kn: LM_FL_ROUNDS if kn == kernel else 0 for kn in launches}
            if launches != want:
                fail(f"lm colrel {arch} {strategy}/{backend}: launches {launches}, "
                     f"expected {want}")
            if not all(math.isfinite(x) for x in losses):
                fail(f"lm colrel {arch} {strategy}/{backend}: non-finite loss {losses}")
            for kn in totals:
                totals[kn] += launches[kn]
            runs[strategy, backend] = (tree_flatten(params)[0], losses)
            print(f"lm colrel {arch} (n={n}, D={widths[arch]:,}, T={LM_FL_T}, local batch "
                  f"{LM_FL_BATCH}×{LM_FL_SEQ}) {strategy}/{backend}: round ms "
                  f"{[round(x, 3) for x in round_ms]} losses {losses} launches {launches}")
        for strategy, backend in (("colrel", "hopper"), ("colrel_fused", "hopper_fused")):
            (pk, lk), (pe, le) = runs[strategy, backend], runs[strategy, "einsum"]
            dp = max((x - y).abs().max().item() for x, y in zip(pk, pe))
            dl = float(np.max(np.abs(np.subtract(lk, le))))
            close = all(torch.allclose(x, y, rtol=harness.KERNEL_CHECK_RTOL,
                                       atol=harness.KERNEL_CHECK_ATOL) for x, y in zip(pk, pe))
            print(f"lm colrel {arch} {strategy}/{backend} vs einsum after {LM_FL_ROUNDS} "
                  f"rounds: max |Δparam| {dp:.3g}, max |Δloss| {dl:.3g}")
            if not (close and dl <= harness.KERNEL_CHECK_ATOL):
                fail(f"lm colrel {arch} {strategy}/{backend} off einsum: {dp} {dl}")
    return totals, widths


def _lm_kernel_times(widths: dict) -> dict:
    """Both kernels at the LM widths: checked against their plain versions,
    then timed beside the plain version, the library call and the bound."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import relay_mix as k

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    out = {"relay_mix_2d": [], "fused_aggregate_2d": []}
    for arch in LM_FL_ARCHS:
        n, D = LM_FL_CLIENTS, widths[arch]
        copies = max(1, math.ceil(2 * L2_BYTES / (4 * n * D)))
        A = torch.randn(n, n, generator=gen, device=dev) / math.sqrt(n)
        c = torch.randn(n, generator=gen, device=dev) / math.sqrt(n)
        ds = [torch.randn(n, D, generator=gen, device=dev) for _ in range(copies)]
        rows = {
            "relay_mix_2d": (k.relay_mix_2d, ref.relay_mix_2d, torch.matmul, A,
                             bound_ms(4 * (n * n + 2 * n * D), 2 * n * n * D)),
            "fused_aggregate_2d": (k.fused_aggregate_2d, ref.fused_aggregate_2d,
                                   lambda c_, d_: c_ @ d_, c,
                                   bound_ms(4 * (n + n * D + D), 2 * n * D)),
        }
        for name, (kern, plain, lib, coef, (b_ms, b_by)) in rows.items():
            err = check_close(f"{name} lm n={n} D={D}", kern(coef, ds[0]), plain(coef, ds[0]),
                              RTOL_F32)
            args = [(coef, d) for d in ds]
            t = {"arch": arch, "shape": [n, D], "max_abs_err": err,
                 "ms": device_ms(kern, args, 100), "plain_ms": device_ms(plain, args, 100),
                 "library_ms": device_ms(lib, args, 100), "bound_ms": b_ms, "bound_by": b_by,
                 "plan": (k.relay_mix_plan if name == "relay_mix_2d"
                          else k.fused_aggregate_plan)(ds[0])}
            out[name].append(t)
            print(f"time {name} lm {arch} (n={n}, D={D}, {copies} Δ copies): "
                  + json.dumps({key: v for key, v in t.items() if key not in ("shape", "arch")}))
        del ds
    torch.cuda.empty_cache()
    return out


def phase_lm() -> dict:
    """The LM model zoo and its serving path; see the module docstring for
    the gates.  Returns each kernel's launches over the ColRel rounds and
    the kernels' times at the LM widths."""
    from repro_torch.kernels import relay_mix as k

    t0 = time.perf_counter()
    _lm_serve()
    t1 = time.perf_counter()
    _lm_reduced()
    t2 = time.perf_counter()
    k.reset_launches()
    launches, widths = _lm_colrel()
    t3 = time.perf_counter()
    times = _lm_kernel_times(widths)
    print(f"lm phase: serve {t1 - t0:.1f} s, reduced archs {t2 - t1:.1f} s, colrel "
          f"{t3 - t2:.1f} s, kernel times {time.perf_counter() - t3:.1f} s")
    return {"launches": launches, "times": times}


def main() -> int:
    phase_device()
    t0 = time.perf_counter()
    phase_build()
    kern = phase_kernels()
    runs = phase_main()
    t_fig = time.perf_counter()
    fig_launches = phase_figures()
    t_channel = time.perf_counter()
    channel_launches = phase_channel_figures()
    t_claims = time.perf_counter()
    claims_launches = phase_claims()
    t_engines = time.perf_counter()
    engine_launches = phase_engines()
    bench_launches = phase_bench()
    t_suite = time.perf_counter()
    suite = phase_suite()
    t_sparse = time.perf_counter()
    sparse_launches = phase_sparse()
    t_async = time.perf_counter()
    async_launches = phase_async()
    t_service = time.perf_counter()
    service_launches = phase_service()
    t_dist = time.perf_counter()
    dist_launches = phase_distributed()
    t_lm = time.perf_counter()
    lm = phase_lm()
    print(f"phases: figures {t_channel - t_fig:.1f} s, channel_figures "
          f"{t_claims - t_channel:.1f} s, claims {t_engines - t_claims:.1f} s, "
          f"suite {t_sparse - t_suite:.1f} s, "
          f"sparse {t_async - t_sparse:.1f} s, async {t_service - t_async:.1f} s, "
          f"service {t_dist - t_service:.1f} s, distributed {t_lm - t_dist:.1f} s, "
          f"lm {time.perf_counter() - t_lm:.1f} s")
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
            # phase's 5 rounds, the figures phase's runs (10 rounds each on
            # the kernel's backend), the channel figures' runs (10 rounds each
            # on the kernel's backend), the claims phase's 10 quadratic runs of
            # 150 rounds, the engines phase's four runs of 12, the
            # bench phase's kernel checks (cold and warm passes), the sample
            # sweeps' engines (cold and warm, the segment reduce), the
            # async engine's and its loops' rounds on the kernel backends,
            # the service phase's trainer rounds and the distributed phase's
            # steps, sharded engine and mesh_corr_500 kernel check; the
            # suite's kernel rows: the wrapper's calls in both dtypes at three
            # sizes (each timing graph's warm-up and captured calls; its
            # replays are not counted)
            "launches_by_path": {
                "main": launches[name],
                "figures": fig_launches[name],
                "channel_figures": channel_launches[name],
                "claims": claims_launches[name],
                "engines": engine_launches[name],
                "bench": bench_launches[name],
                "suite": suite["launches"][name],
                "sparse": sparse_launches[name],
                "async": async_launches[name],
                "service": service_launches[name],
                "distributed": dist_launches[name],
                "lm": lm["launches"][name],
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
            "plan": main_t["plan"],
            "large": {key: large_t[key] for key in
                      ("shape", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "plan")},
            "mesh": {**{key: kern["timing"][name]["mesh"][key] for key in
                        ("shape", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                         "plan")},
                     "max_abs_err": kern["mesh_err"][e]},
            "mlp": {**{key: kern["timing"][name]["mlp"][key] for key in
                       ("shape", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                        "plan")},
                    "max_abs_err": kern["mlp_err"][e]},
            **{key: kern["timing"][name][key] for key in ("sparse", "wide")
               if key in kern["timing"][name]},
            "lm": lm["times"][name],
            "suite": suite["rows"][name],
        })
    print(f"total {time.perf_counter() - t0:.1f} s after the device check")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
