"""Timing harness: one scenario, every engine, cold + warm runs.

The PyTorch counterpart of the JAX package's ``bench/harness.py`` (its sim
path).  Per engine the harness runs the scenario twice on one simulator
instance: the **cold** run pays the one-time costs, the **warm** run is
steady-state throughput.  Reported quantities:

  wall_s          warm-run wall clock for all ``spec.rounds`` rounds
  compile_s       cold wall minus warm wall.  The name is the JAX schema's;
                  here it is the one-time cost of the first pass: loading
                  the CUDA kernels (building them with nvcc when no build of
                  these sources exists), cuDNN's and cuBLAS's first calls
                  at these shapes, ``torch.func``'s first trace of the
                  loss, the caching allocator's first allocations and, on
                  the card, the engines' CUDA graph captures
  rounds_per_sec  spec.rounds / wall_s — the headline engine throughput
  trace_count     the engine's CUDA graph captures over both passes (the
                  counterpart of the JAX engines' compiles: one a full chunk
                  length and churn-mask presence, at most 2; 0 on the CPU
                  and on the ``segment`` backend, where chunks run eagerly);
                  ``None`` for the loop, the async engine and the mesh
                  steps, which capture nothing
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

``spec.step = "mesh"`` swaps the execution path under measurement: instead
of ``FLSimulator`` and its engines, the engines are the mesh round steps of
:mod:`repro_torch.fl.distributed` — per-round :func:`build_round_step`
("loop"), one :func:`build_scan_round_step` call per channel epoch
("scan"), or one τ-in-step :func:`build_fused_scan_round_step` call per
epoch with the host side prefetched ("pipelined").  Same fairness contract,
same bitwise assertion.

``spec.step = "shard"`` measures the **multi-rank** path: "loop" stays the
one-rank per-round reference, while "scan" / "pipelined" run the sharded
step (:func:`build_sharded_scan_round_step`) through
:class:`~repro_torch.fl.engine.ShardedScanEngine` over a mesh of
``spec.devices`` ranks — serial vs prefetched staging.  Every rank calls
:func:`run_scenario` (the bench CLI starts the ranks); in a process with
fewer ranks the mesh raises.  The bitwise assertion becomes the *shard
gate*: sharded engines bitwise equal to each other, allclose (1e-5) to the
loop — the measured max |Δ| lands in the report's ``shard_check`` block.
"""
from __future__ import annotations

import dataclasses
import pathlib
import time

import numpy as np
import torch

from repro_torch.bench.scenarios import ScenarioBundle, ScenarioSpec, build, get_scenario
from repro_torch.channels.scheduler import SegmentPrefetcher, _stack_host, _to_device
from repro_torch.core.aggregation import ServerOpt
from repro_torch.fl.async_engine import AsyncRoundEngine
from repro_torch.fl.distributed import (
    build_fused_scan_round_step,
    build_round_step,
    build_scan_round_step,
    build_sharded_scan_round_step,
)
from repro_torch.fl.engine import (
    EpochScanEngine,
    PipelinedScanEngine,
    ShardedScanEngine,
    _event_after,
    _segment_value,
    run_rounds_loop,
)
from repro_torch.kernels import relay_mix
from repro_torch.launch.mesh import make_client_mesh
from repro_torch.obs import NULL_TRACER, Tracer, phase_attribution, write_chrome_trace, write_jsonl
from repro_torch.obs.summary import BESIDE_HOST
from repro_torch.optim.sgd import ClientOpt
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
    # *third* run — the mesh path's traced per-segment syncs serialize its
    # pipeline, so the perf numbers above always come from the untraced
    # warm run.
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


def _finalize(tracer, device):
    if tracer is not None and tracer.enabled:
        # the host waits out the trailing drain
        with tracer.span("run.finalize", cat="wait"):
            _sync(device)
    else:
        _sync(device)


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
    instants, policy solve spans, engine dispatch and device spans)."""
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
    _finalize(tracer, sim.device)
    return time.perf_counter() - t0, metrics, params


def _finish_trace(tracer: Tracer, trace_dir, scenario: str, engine: str):
    """Export a traced pass (Chrome trace + JSONL) and distill its telemetry
    block: per-phase attribution plus counters.  ``attributed_fraction`` is
    the share of the trace's wall span covered by the host's phase spans —
    the rest is untraced host glue; the device's execution (``device``)
    runs beside the host and is not in it."""
    trace_dir = pathlib.Path(trace_dir)
    path = trace_dir / f"TRACE_{scenario}_{engine}.json"
    write_chrome_trace(tracer, path)
    write_jsonl(tracer, path.with_suffix(".jsonl"))
    phases = phase_attribution(tracer.events)
    wall = tracer.wall_seconds()
    telemetry = {
        "wall_s": wall,
        "phases": phases,
        "attributed_fraction": (sum(t for c, t in phases.items() if c not in BESIDE_HOST)
                                / wall if wall > 0 else 0.0),
        "counters": dict(tracer.counters),
        "events": len(tracer.events),
        "dropped": tracer.dropped,
    }
    return str(path), telemetry


def _step_kw(spec: ScenarioSpec) -> dict:
    return dict(
        n_clients=spec.n_clients,
        local_steps=spec.local_steps,
        relay_mode="fused",
        relay_backend=spec.relay_backend,
        client_opt=ClientOpt(kind="sgd", weight_decay=1e-4),
        server_opt=ServerOpt(),
    )


class _MeshStep:
    """The mesh round steps of :mod:`repro_torch.fl.distributed` for one
    scenario (nothing is compiled, so there is no trace count)."""

    def __init__(self, bundle: ScenarioBundle):
        kw = _step_kw(bundle.spec)
        self.round = build_round_step(bundle.loss_fn, **kw)
        self.scan = build_scan_round_step(bundle.loss_fn, **kw)
        self.fused = build_fused_scan_round_step(bundle.loss_fn, **kw)


def _run_mesh_once(bundle: ScenarioBundle, step: _MeshStep, name: str, batches: list,
                   tracer=None):
    """One full mesh-path pass; returns (wall_s, losses, params, n_segments,
    prefetch_stats).  Walks ``schedule.segments()`` exactly like
    ``EpochScanEngine.run_schedule``: one OPT-α solve and one τ block per
    epoch, τ drawn from the generator once a round in round order, so every
    engine consumes identical randomness.  The ``pipelined`` engine stages
    whole segments through a :class:`SegmentPrefetcher` and calls the
    τ-in-step epoch scan, which draws the same τ from the same generator.
    ``tracer`` adds the same span set as the sim path."""
    spec, dev = bundle.spec, bundle.device
    schedule = bundle.make_schedule()
    policy = bundle.make_policy(tracer=tracer)
    tr = NULL_TRACER if tracer is None else tracer
    if tracer is not None:
        schedule.tracer = tracer
    if policy is None:
        raise ValueError("the mesh round step needs a relay policy")
    params = bundle.init_fn(spec.seed)
    server_state = None
    generator = torch.Generator(device=dev).manual_seed(spec.seed + 1)
    stream = iter(batches)
    losses = []
    n_segments = 0
    prefetch_stats = None
    _sync(dev)
    t0 = time.perf_counter()
    if name == "pipelined":
        # chunk=spec.rounds ⇒ one staged item per segment: the mesh scan
        # path runs whole epochs, so the pipelined variant must too for the
        # dispatch counts to be comparable
        prefetcher = SegmentPrefetcher(
            schedule, spec.rounds, chunk=spec.rounds, next_batch=lambda: next(stream),
            policy=policy, tracer=tracer, device=dev,
        )
        try:
            for item in prefetcher:
                seg = item.segment
                if seg.active is not None:
                    raise ValueError("mesh bench path does not drive churn masks")
                n_segments += 1
                A, p = _segment_value(item.A, dev), _segment_value(seg.p, dev)
                with tr.span("mesh.fused", cat="dispatch", epoch=seg.epoch_id):
                    generator, params, server_state, seg_losses = step.fused(
                        generator, params, server_state, item.batches, p, spec.lr, A)
                prefetcher.note_inflight(_event_after(dev))
                if tr.enabled:
                    with tr.span("mesh.device", cat="wait", epoch=seg.epoch_id):
                        _sync(dev)
                losses.append(seg_losses)
        finally:
            prefetcher.close()
        prefetch_stats = prefetcher.stats
    else:
        for seg in schedule.segments(spec.rounds):
            if seg.active is not None:
                raise ValueError("mesh bench path does not drive churn masks")
            n_segments += 1
            A = _segment_value(policy.relay_matrix(seg.state), dev)
            p = _segment_value(seg.p, dev)
            taus = [torch.bernoulli(p, generator=generator) for _ in range(seg.n_rounds)]
            seg_batches = [next(stream) for _ in range(seg.n_rounds)]
            if name == "loop":
                for r in range(seg.n_rounds):
                    with tr.span("mesh.stage", cat="stage", epoch=seg.epoch_id):
                        batch = _to_device(seg_batches[r], device=dev)
                    with tr.span("mesh.round", cat="dispatch", epoch=seg.epoch_id):
                        params, server_state, loss = step.round(
                            params, server_state, batch, taus[r], spec.lr, A)
                    # the per-round host sync every loop driver models
                    with tr.span("mesh.sync", cat="wait"):
                        losses.append(float(loss))
            else:
                with tr.span("mesh.stage", cat="stage", epoch=seg.epoch_id):
                    stacked = _to_device(_stack_host(seg_batches, 0), device=dev)
                with tr.span("mesh.scan", cat="dispatch", epoch=seg.epoch_id):
                    params, server_state, seg_losses = step.scan(
                        params, server_state, stacked, torch.stack(taus), spec.lr, A)
                if tr.enabled:
                    with tr.span("mesh.device", cat="wait"):
                        _sync(dev)
                losses.append(seg_losses)
    _finalize(tracer, dev)
    wall = time.perf_counter() - t0
    losses = torch.tensor(losses) if name == "loop" else torch.cat([x.cpu() for x in losses])
    return wall, losses, params, n_segments, prefetch_stats


def _shard_mesh(spec: ScenarioSpec):
    """The mesh a shard scenario runs on: ``spec.devices`` ranks on one
    axis — the client axis in clients mode, the model axis in D mode.
    Raises when the world holds fewer ranks."""
    axis = "clients" if spec.shard == "clients" else "model"
    return make_client_mesh(spec.devices, axis=axis)


def _run_shard_once(bundle: ScenarioBundle, ex, name: str, batches: list, tracer=None):
    """One full shard-path pass; returns (wall_s, losses, params, dispatches,
    prefetch_stats).  ``ex`` is the engine, or for ``loop`` the one-rank
    round step the sharded engines are gated against (it threads the churn
    mask, so it is the reference for churned epochs too).  The loop draws τ
    from the generator with
    exactly the sharded step's calls (one Bernoulli(p) a round, in round
    order), so every engine consumes identical randomness; churn masks flow
    from the schedule segments on both sides."""
    spec, dev = bundle.spec, bundle.device
    schedule = bundle.make_schedule()
    policy = bundle.make_policy(tracer=tracer)
    tr = NULL_TRACER if tracer is None else tracer
    if tracer is not None:
        schedule.tracer = tracer
    if policy is None:
        raise ValueError("the sharded round step needs a relay policy")
    params = bundle.init_fn(spec.seed)
    server_state = None
    generator = torch.Generator(device=dev).manual_seed(spec.seed + 1)
    stream = iter(batches)
    _sync(dev)
    t0 = time.perf_counter()
    if name == "loop":
        losses = []
        for seg in schedule.segments(spec.rounds):
            A = _segment_value(policy.relay_matrix(seg.state), dev)
            p, active = _segment_value(seg.p, dev), _segment_value(seg.active, dev)
            for _ in range(seg.n_rounds):
                tau = torch.bernoulli(p, generator=generator)
                with tr.span("shard.stage", cat="stage", epoch=seg.epoch_id):
                    batch = _to_device(next(stream), device=dev)
                with tr.span("shard.round", cat="dispatch", epoch=seg.epoch_id):
                    params, server_state, loss = ex(
                        params, server_state, batch, tau, spec.lr, A, active)
                # the per-round host sync every loop driver models
                with tr.span("shard.sync", cat="wait"):
                    losses.append(float(loss))
        losses = torch.tensor(losses)
        dispatches = spec.rounds
        prefetch_stats = None
    else:
        prev = ex.tracer
        if tracer is not None:
            ex.tracer = tracer
        try:
            params, server_state, metrics, generator = ex.run_schedule(
                generator, params, server_state, schedule=schedule, rounds=spec.rounds,
                next_batch=lambda: next(stream), lr=spec.lr, policy=policy,
            )
        finally:
            ex.tracer = prev
        losses = metrics["loss"].cpu()
        dispatches = ex.dispatches
        prefetch_stats = ex.prefetch_stats
    _finalize(tracer, dev)
    wall = time.perf_counter() - t0
    return wall, losses, params, dispatches, prefetch_stats


def _distributed_engine(bundle: ScenarioBundle, name: str, batches: list, trace_dir=None):
    """Cold + warm pass of one engine of the mesh or shard path; mirrors
    :func:`run_engine`.  On the shard path ``loop`` is the one-rank
    reference and ``scan`` / ``pipelined`` run the sharded step through
    :class:`ShardedScanEngine` (serial vs prefetched staging)."""
    spec = bundle.spec
    if name not in ("loop", "scan", "pipelined"):
        raise ValueError(f"unknown engine: {name!r}")
    if spec.step == "mesh":
        ex, once = _MeshStep(bundle), _run_mesh_once
    elif name == "loop":
        ex, once = build_round_step(bundle.loss_fn, **_step_kw(spec)), _run_shard_once
    else:
        mesh = _shard_mesh(spec)
        step_fn = build_sharded_scan_round_step(
            bundle.loss_fn, mesh=mesh, shard=spec.shard, exchange=spec.exchange,
            **_step_kw(spec),
        )
        ex = ShardedScanEngine(step_fn, mesh=mesh, shard=spec.shard,
                               prefetch="serial" if name == "scan" else "inline",
                               device=bundle.device)
        once = _run_shard_once
    before = dict(relay_mix.LAUNCHES)
    cold_s = once(bundle, ex, name, batches)[0]
    warm_s, losses, params, count, overlap = once(bundle, ex, name, batches)
    launches = {k: relay_mix.LAUNCHES[k] - before[k] for k in before}
    trace_path = telemetry = None
    if trace_dir is not None:
        tracer = Tracer()
        once(bundle, ex, name, batches, tracer=tracer)
        trace_path, telemetry = _finish_trace(tracer, trace_dir, spec.name, name)
    losses = losses.double().tolist()
    run = EngineRun(
        engine=name,
        wall_s=warm_s,
        compile_s=max(0.0, cold_s - warm_s),
        rounds_per_sec=spec.rounds / warm_s,
        trace_count=getattr(ex, "trace_count", None),
        # mesh: one call a round (loop) or a segment; shard: the engine's
        dispatches=spec.rounds if (spec.step == "mesh" and name == "loop") else count,
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
    return run, tree_map(lambda x: x.detach().cpu(), params)


def run_engine(bundle: ScenarioBundle, name: str, batches: list, trace_dir=None):
    """Cold + warm pass of one engine; returns (EngineRun, final params on
    the host).

    ``trace_dir`` adds a third, *traced* pass and writes
    ``TRACE_<scenario>_<engine>.json`` (+ ``.jsonl``) there.  The traced
    pass is not the warm measurement — the ``wall_s``/``overlap_fraction``
    numbers always come from the untraced warm run."""
    spec = bundle.spec
    if spec.step in ("mesh", "shard"):
        return _distributed_engine(bundle, name, batches, trace_dir)
    if spec.step != "sim":
        raise ValueError(f"unknown step: {spec.step!r}")
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
        trace_count=getattr(engine, "trace_count", None),
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


def _max_abs_diff(a, b) -> float:
    return max((float(np.max(np.abs(x.astype(np.float64) - y.astype(np.float64)),
                              initial=0.0))
                for x, y in zip(_host_leaves(a), _host_leaves(b))), default=0.0)


def _shard_gate(spec: ScenarioSpec, finals: dict) -> dict:
    """The shard gate: the sharded engines bitwise equal to *each other*
    (same program, same collectives); against the one-rank loop the bar is
    the kernel-check tolerance — the ring reassociates the relay
    accumulation, and a local step over m clients need not round as the
    n-client one does.  Either violation raises."""
    sharded = sorted(k for k in finals if k != "loop")
    ref = finals[sharded[0]]
    for name in sharded[1:]:
        if not _bitwise_equal(ref, finals[name]):
            raise AssertionError(
                f"{spec.name}: sharded engines {sharded[0]} and {name} diverged "
                "bitwise from each other"
            )
    leaves_l = [x.astype(np.float64) for x in _host_leaves(finals["loop"])]
    leaves_s = [x.astype(np.float64) for x in _host_leaves(ref)]
    max_abs_diff = _max_abs_diff(finals["loop"], ref)
    ok = len(leaves_l) == len(leaves_s) and all(
        np.allclose(a, b, rtol=KERNEL_CHECK_RTOL, atol=KERNEL_CHECK_ATOL)
        for a, b in zip(leaves_l, leaves_s)
    )
    if not ok:
        raise AssertionError(
            f"{spec.name}: sharded engines diverged from the single-device loop "
            f"(max |Δ| = {max_abs_diff:.3e} > atol {KERNEL_CHECK_ATOL:g} / "
            f"rtol {KERNEL_CHECK_RTOL:g})"
        )
    return {
        "shard": spec.shard,
        "exchange": spec.exchange,
        "devices": spec.devices,
        "reference": "loop",
        "allclose": True,
        "bitwise_among_sharded": len(sharded) > 1,
        "rtol": KERNEL_CHECK_RTOL,
        "atol": KERNEL_CHECK_ATOL,
        "max_abs_diff": max_abs_diff,
    }


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
    "shard_check": dict | None, "async_check": dict | None, "ttac": dict | None,
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

    On the shard path (``spec.step == "shard"``, called by every rank of a
    world of ``spec.devices`` ranks) the bitwise gate is replaced by the
    **shard gate** (``shard_check``): the sharded engines must be bitwise
    equal to *each other*, and allclose to the one-rank loop at the
    kernel-check tolerance (the measured ``max_abs_diff`` is recorded).
    Either violation raises.
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
        max_abs_diff = _max_abs_diff(finals[ref_name], kfinal)
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
    shard_check = None
    if check_bitwise and "loop" in finals and len(finals) > 1 and spec.step == "shard":
        shard_check = _shard_gate(spec, finals)
    elif check_bitwise and "loop" in finals and len(finals) > 1:
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
        "shard_check": shard_check,
        "async_check": async_check,
        "ttac": ttac,
        "device": bundle.device,
    }
