"""Timing harness: one scenario, every engine, cold + warm runs.

The PyTorch counterpart of the JAX package's ``bench/harness.py`` (its sim
path).  Per engine the harness runs the scenario twice on one simulator
instance: the **cold** run pays the one-time costs, the **warm** run is
steady-state throughput.  Reported quantities:

  wall_s          warm-run wall clock for all ``spec.rounds`` rounds
  compile_s       cold wall minus warm wall.  The name is the JAX schema's;
                  the port compiles nothing, so here it is the one-time
                  cost of the first pass: loading the CUDA kernels (building
                  them with nvcc when no build of these sources exists),
                  cuDNN's and cuBLAS's first calls at these shapes,
                  ``torch.func``'s first trace of the loss, and the caching
                  allocator's first allocations
  rounds_per_sec  spec.rounds / wall_s — the headline engine throughput
  trace_count     ``None``: the port runs eagerly and has no compiled
                  program to count (a chunk captured as a CUDA graph is
                  ROADMAP step 9a)
  dispatches      the JAX formula — one per round for the loop, one per
                  chunk (⌈len/chunk⌉ per epoch) for the scan engines.  The
                  port runs a remainder chunk at its real length, so no
                  chunk is padded: ``fig5_chunk125``'s 25-round epochs run
                  25 rounds, not 125
  kernel_launches the CUDA kernels launched over the cold and warm passes
                  (``kernels.relay_mix.LAUNCHES``; zeros on the CPU, where
                  the wrappers run their plain versions)

A timed window starts after ``torch.cuda.synchronize()`` and ends with one,
where the JAX harness calls ``block_until_ready``.

The ``pipelined`` engine additionally reports its host/device overlap
(warm run): ``host_prep_s``, ``host_wait_s`` and ``overlap_fraction = 1 -
wait/prep`` (see :class:`repro_torch.channels.PrefetchStats`).

Fairness: the per-round batch stream is pre-generated once (host numpy) and
replayed identically to every run of every engine, each run builds a fresh
schedule / policy / loader from the same seeds and a fresh τ generator
seeded ``spec.seed + 1`` — so all engines consume bit-identical data, τ
randomness and relay matrices, and the harness asserts their final
parameters match bit for bit.  On the card that needs deterministic
kernels: the relay kernels are, and cuDNN must be set so
(``torch.backends.cudnn.deterministic = True``; the CLI sets it).

The ``async`` engine (:class:`repro_torch.fl.async_engine.AsyncRoundEngine`)
replays the scenario's delay stream from a fresh process each pass; a
delayed run is held to the **async parity gate** instead of the bitwise one
(see :func:`run_scenario`).

Not here yet: the mesh and sharded steps (ROADMAP step 14).
"""
from __future__ import annotations

import dataclasses
import pathlib
import time

import numpy as np
import torch

from repro_torch.bench.scenarios import ScenarioBundle, ScenarioSpec, build, get_scenario
from repro_torch.fl.async_engine import AsyncRoundEngine
from repro_torch.fl.engine import EpochScanEngine, PipelinedScanEngine, run_rounds_loop
from repro_torch.kernels import relay_mix
from repro_torch.obs import NULL_TRACER, Tracer, phase_attribution, write_chrome_trace, write_jsonl
from repro_torch.utils import tree_flatten, tree_map, tree_size

# tolerance of the mandatory kernel parity check (run_scenario): the kernel
# backend re-runs the scan engine and its final params must match the einsum
# reference to f32 accumulation accuracy over the scenario horizon
KERNEL_CHECK_RTOL = 1e-5
KERNEL_CHECK_ATOL = 1e-5


@dataclasses.dataclass
class EngineRun:
    """One engine's measurements on one scenario (see the module docstring).

    The ``host_*`` / ``overlap_fraction`` fields are the pipelined engine's
    prefetcher measurements (warm run); ``None`` for engines without a
    prefetcher.
    """

    engine: str
    wall_s: float
    compile_s: float
    rounds_per_sec: float
    trace_count: int | None
    dispatches: int
    final_loss: float
    overlap_fraction: float | None = None
    steady_overlap_fraction: float | None = None
    host_prep_s: float | None = None
    host_wait_s: float | None = None
    chunks_staged: int | None = None
    kernel_launches: dict | None = None
    # traced-pass artifacts (``trace_dir`` runs only): the Chrome trace on
    # disk and the per-phase attribution summary.  The traced pass is a
    # *third* run — its fences serialize the pipeline (observer effect), so
    # the perf numbers above always come from the untraced warm run.
    trace_path: str | None = None
    telemetry: dict | None = None
    # the warm run's per-round loss trajectory (host floats) — consumed by
    # the time-to-accuracy block (run_scenario), not serialized per engine
    losses: list | None = None

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        # the telemetry block is aggregated once at the report's top level
        # (make_report); the loss trajectory is distilled into the ttac block
        d.pop("telemetry")
        d.pop("losses")
        return d


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _pregenerate_batches(bundle: ScenarioBundle) -> list:
    """Materialize the full per-round batch stream once (numpy), replayed
    identically to every engine run."""
    spec = bundle.spec
    loader = bundle.make_loader()
    return [
        loader.round_batch(spec.local_steps, spec.local_batch)
        for _ in range(spec.rounds)
    ]


def _run_once(bundle: ScenarioBundle, engine, batches: list, tracer=None):
    """One full pass over the scenario; returns (wall_s, metrics, params).
    ``tracer`` threads telemetry through every layer of the pass (schedule
    instants, policy solve spans, engine dispatch/fence spans)."""
    spec = bundle.spec
    schedule = bundle.make_schedule()
    policy = bundle.make_policy(tracer=tracer)
    if tracer is not None:
        schedule.tracer = tracer
    params = bundle.init_fn(spec.seed)
    fused = isinstance(engine, (EpochScanEngine, PipelinedScanEngine, AsyncRoundEngine))
    sim = engine.sim if fused else engine
    server_state = sim.init_server_state(params)
    generator = torch.Generator(device=sim.device).manual_seed(spec.seed + 1)
    stream = iter(batches)
    kw = dict(
        schedule=schedule,
        rounds=spec.rounds,
        next_batch=lambda: next(stream),
        lr=spec.lr,
        policy=policy,
    )
    _sync(sim.device)
    t0 = time.perf_counter()
    if fused:
        params, server_state, metrics, _ = engine.run_schedule(
            generator, params, server_state, **kw
        )
    else:
        params, server_state, metrics, _ = run_rounds_loop(
            engine, generator, params, server_state, tracer=tracer, **kw
        )
    if tracer is not None:
        # the trailing drain belongs to the device phase too
        with tracer.span("run.finalize", cat="device", track="device"):
            _sync(sim.device)
    else:
        _sync(sim.device)
    return time.perf_counter() - t0, metrics, params


def _finish_trace(tracer: Tracer, trace_dir, scenario: str, engine: str):
    """Export a traced pass (Chrome trace + JSONL) and distill its telemetry
    block: per-phase attribution plus counters.  ``attributed_fraction`` is
    the share of the trace's wall span covered by phase spans — the rest is
    untraced host glue."""
    trace_dir = pathlib.Path(trace_dir)
    path = trace_dir / f"TRACE_{scenario}_{engine}.json"
    write_chrome_trace(tracer, path)
    write_jsonl(tracer, path.with_suffix(".jsonl"))
    phases = phase_attribution(tracer.events)
    wall = tracer.wall_seconds()
    telemetry = {
        "wall_s": wall,
        "phases": phases,
        "attributed_fraction": sum(phases.values()) / wall if wall > 0 else 0.0,
        "counters": dict(tracer.counters),
        "events": len(tracer.events),
        "dropped": tracer.dropped,
    }
    return str(path), telemetry


def run_engine(bundle: ScenarioBundle, name: str, batches: list, trace_dir=None):
    """Cold + warm pass of one engine; returns (EngineRun, final params on
    the host).

    ``trace_dir`` adds a third, *traced* pass and writes
    ``TRACE_<scenario>_<engine>.json`` (+ ``.jsonl``) there.  The traced
    pass fences the device per chunk, so its wall time is not the warm
    measurement — the ``wall_s``/``overlap_fraction`` numbers always come
    from the untraced warm run."""
    spec = bundle.spec
    if spec.step != "sim":
        raise NotImplementedError(
            f"step={spec.step!r}: the distributed engines (ROADMAP step 14) "
            "are not ported to repro_torch yet"
        )
    sim = bundle.make_sim()
    if name in ("scan", "pipelined"):
        cls = EpochScanEngine if name == "scan" else PipelinedScanEngine
        engine = cls(sim, chunk=spec.chunk)
        dispatches = sum(
            -(-seg.n_rounds // spec.chunk)
            for seg in bundle.make_schedule().segments(spec.rounds)
        )
    elif name == "async":
        # each engine run replays the same delay stream (fresh process,
        # same seed); reset=True inside run_schedule makes cold and warm
        # passes identical.  Like the loop, one aggregation a round.
        engine = AsyncRoundEngine(
            sim,
            delays=bundle.make_delays(),
            staleness_decay=spec.staleness_decay,
            buffer_k=spec.buffer_k,
        )
        dispatches = spec.rounds
    elif name == "loop":
        engine = sim
        dispatches = spec.rounds
    else:
        raise ValueError(f"unknown engine: {name!r}")
    before = dict(relay_mix.LAUNCHES)
    cold_s, _, _ = _run_once(bundle, engine, batches)
    warm_s, metrics, params = _run_once(bundle, engine, batches)
    launches = {k: relay_mix.LAUNCHES[k] - before[k] for k in before}
    overlap = getattr(engine, "prefetch_stats", None)  # warm run's stats
    trace_path = telemetry = None
    if trace_dir is not None:
        tracer = Tracer()
        if name != "loop":
            engine.tracer = tracer
        try:
            _run_once(bundle, engine, batches, tracer=tracer)
        finally:
            if name != "loop":
                engine.tracer = NULL_TRACER
        trace_path, telemetry = _finish_trace(tracer, trace_dir, spec.name, name)
    losses = metrics["loss"].double().cpu().tolist()
    run = EngineRun(
        engine=name,
        wall_s=warm_s,
        compile_s=max(0.0, cold_s - warm_s),
        rounds_per_sec=spec.rounds / warm_s,
        trace_count=None,
        dispatches=dispatches,
        final_loss=losses[-1],
        losses=losses,
        overlap_fraction=None if overlap is None else overlap.overlap_fraction,
        steady_overlap_fraction=(
            None if overlap is None else overlap.steady_overlap_fraction
        ),
        host_prep_s=None if overlap is None else overlap.prep_s,
        host_wait_s=None if overlap is None else overlap.wait_s,
        chunks_staged=None if overlap is None else overlap.chunks_staged,
        kernel_launches=launches,
        trace_path=trace_path,
        telemetry=telemetry,
    )
    # finals go to the host: a relay_sweep_1e7 final is 40 MB, and the gates
    # compare them there
    return run, tree_map(lambda x: x.detach().cpu(), params)


def _host_leaves(params) -> list[np.ndarray]:
    return [x.numpy() for x in tree_flatten(params)[0]]


def _bitwise_equal(a, b) -> bool:
    la, lb = _host_leaves(a), _host_leaves(b)
    return len(la) == len(lb) and all(np.array_equal(x, y) for x, y in zip(la, lb))


def run_scenario(
    spec: ScenarioSpec | str,
    *,
    engines=None,
    check_bitwise: bool = True,
    trace_dir=None,
    device=None,
) -> dict:
    """Run ``spec`` under every engine (default: ``spec.engines``) on
    ``device`` (the GPU unless the caller passes ``device="cpu"``); returns
    ``{"runs": {name: EngineRun}, "speedup": float | None,
    "speedups": {name: float}, "bitwise_match": bool | None,
    "model_params": int, "kernel_check": dict | None,
    "shard_check": None, "async_check": dict | None, "ttac": dict | None,
    "device": torch.device}``.

    The ``async`` engine (``spec.engines`` includes it) joins the bitwise
    gate only at ``spec.delay == "none"`` — a delayed run diverges from the
    loop *by design*.  A delayed scenario instead gets the **async parity
    gate** (``async_check``): the async engine re-runs with the delay (and
    the freshest-k cap) stripped and its final parameters must be
    bitwise-identical to the loop's (the staleness-weighting unbiasedness
    regression; the re-run is recorded in ``runs`` as ``async_delay0``).  A
    mismatch raises.

    ``speedups[name]`` is that engine's rounds/sec over the loop's (absent
    unless the loop ran); ``speedup`` is the scan/loop headline.
    ``bitwise_match`` asserts every engine's final parameters are
    bit-identical to the per-round loop's — a benchmark whose fast path
    diverges from the reference is measuring the wrong thing, so a mismatch
    raises.

    ``spec.check_backend != "none"`` adds the **mandatory kernel parity
    check**: the scan engine re-runs on that relay backend (same batches,
    same randomness) and its final parameters must be allclose (rtol = atol
    = 1e-5, compared in float64 on the host) to the reference engines' — a
    mismatch raises.  The kernel pass is recorded in ``runs`` as
    ``scan_<backend>`` but stays out of the bitwise gate.

    ``spec.ttac_target_loss > 0`` adds the ``ttac`` block: per engine, the
    first round (and derived wall-clock second) at which the warm run's
    training loss reaches the target.
    """
    if isinstance(spec, str):
        spec = get_scenario(spec)
    if engines is None:
        engines = spec.engines
    bundle = build(spec, device=device)
    model_params = tree_size(bundle.init_fn(spec.seed))
    batches = _pregenerate_batches(bundle)
    runs: dict[str, EngineRun] = {}
    finals = {}
    for name in engines:
        runs[name], finals[name] = run_engine(bundle, name, batches, trace_dir)
    kernel_check = None
    if spec.check_backend != "none" and finals:
        kspec = dataclasses.replace(
            spec, relay_backend=spec.check_backend, check_backend="none"
        )
        kname = f"scan_{spec.check_backend}"
        krun, kfinal = run_engine(build(kspec, device=bundle.device), "scan", batches)
        ref_name = "loop" if "loop" in finals else sorted(finals)[0]
        leaves_r = [x.astype(np.float64) for x in _host_leaves(finals[ref_name])]
        leaves_k = [x.astype(np.float64) for x in _host_leaves(kfinal)]
        max_abs_diff = max(
            (float(np.max(np.abs(a - b), initial=0.0)) for a, b in zip(leaves_r, leaves_k)),
            default=0.0,
        )
        ok = len(leaves_r) == len(leaves_k) and all(
            np.allclose(a, b, rtol=KERNEL_CHECK_RTOL, atol=KERNEL_CHECK_ATOL)
            for a, b in zip(leaves_r, leaves_k)
        )
        if not ok:
            raise AssertionError(
                f"{spec.name}: {spec.check_backend} backend diverged from "
                f"the {spec.relay_backend} reference "
                f"(max |Δ| = {max_abs_diff:.3e} > "
                f"atol {KERNEL_CHECK_ATOL:g} / rtol {KERNEL_CHECK_RTOL:g})"
            )
        runs[kname] = dataclasses.replace(krun, engine=kname)
        kernel_check = {
            "backend": spec.check_backend,
            "reference_backend": spec.relay_backend,
            "engine": "scan",
            "allclose": True,
            "rtol": KERNEL_CHECK_RTOL,
            "atol": KERNEL_CHECK_ATOL,
            "max_abs_diff": max_abs_diff,
            "rounds_per_sec": krun.rounds_per_sec,
        }
    async_check = None
    if "async" in finals and spec.delay != "none" and "loop" in finals:
        # the mandatory async parity gate: strip the delay (and the buffer
        # cap — freshest-k at k < n drops clients even when all arrive
        # fresh) and the engine must reproduce the loop bit for bit (same
        # batches, same τ stream) — proof the staleness weighting degrades
        # to OPT-α exactly in the synchronous limit
        dspec = dataclasses.replace(spec, delay="none", buffer_k=0)
        arun, afinal = run_engine(build(dspec, device=bundle.device), "async", batches)
        if not _bitwise_equal(finals["loop"], afinal):
            raise AssertionError(
                f"{spec.name}: the async engine at delay=0 diverged bitwise "
                "from the per-round loop — the staleness weighting broke "
                "the synchronous-limit contract"
            )
        runs["async_delay0"] = dataclasses.replace(arun, engine="async_delay0")
        async_check = {
            "reference": "loop",
            "bitwise": True,
            "recorded_delay": spec.delay,
            "rounds_per_sec": arun.rounds_per_sec,
        }
    ttac = None
    if spec.ttac_target_loss > 0:
        ttac = {"target_loss": spec.ttac_target_loss, "engines": {}}
        for name, run in runs.items():
            arr = np.asarray(run.losses)
            hit = np.nonzero(arr <= spec.ttac_target_loss)[0]
            reached = bool(hit.size)
            rounds_to = int(hit[0]) + 1 if reached else None
            ttac["engines"][name] = {
                "reached": reached,
                "rounds_to_target": rounds_to,
                "seconds_to_target": (
                    rounds_to / run.rounds_per_sec if reached else None
                ),
            }
    speedups = {}
    if "loop" in runs:
        speedups = {
            name: runs[name].rounds_per_sec / runs["loop"].rounds_per_sec
            for name in runs
            if name != "loop"
        }
    bitwise = None
    if check_bitwise and "loop" in finals and len(finals) > 1:
        for name, final in finals.items():
            if name == "loop":
                continue
            if name == "async" and spec.delay != "none":
                # a delayed async run diverges from the loop by design; its
                # gate is the delay-0 re-run above (async_check)
                continue
            bitwise = _bitwise_equal(finals["loop"], final)
            if not bitwise:
                raise AssertionError(
                    f"{spec.name}: {name} engine diverged bitwise from "
                    "the per-round reference"
                )
    return {
        "runs": runs,
        "speedup": speedups.get("scan"),
        "speedups": speedups,
        "bitwise_match": bitwise,
        "model_params": model_params,
        "kernel_check": kernel_check,
        "shard_check": None,
        "async_check": async_check,
        "ttac": ttac,
        "device": bundle.device,
    }
