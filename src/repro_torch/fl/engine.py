"""Epoch round engines: the per-round loop, the epoch engine and the
pipelined engine.

The PyTorch counterpart of the JAX package's ``fl/engine.py``.  Within a
channel epoch the tuple ``(A, p, active)`` is *constant* — only τ and the
data change — so the engines walk ``ChannelSchedule.segments()``, resolve
the relay matrix and move ``(A, p, active)`` to the device once per epoch,
and run the epoch's rounds in chunks of at most ``chunk`` rounds:

    carry = (server params, server opt state)
    per round: (batch_r, τ_r)                 # staged per chunk
    A, lr, active                             # loop-invariant per epoch

Every round is the simulator's own ``FLSimulator.round_math``, so the
engines are bit-identical to the per-round loop by construction (and by
test: ``tests/test_torch_engine.py``): same params, server state, per-round
metrics, and generator state after the run.

Chunks are Python loops
-----------------------
JAX fuses a chunk into one compiled ``lax.scan`` and pads a remainder chunk
to the chunk length (a scan's length is static, and a new length would
recompile).  PyTorch runs eagerly: a chunk is a Python loop over
``round_math``, a remainder chunk runs at its real length, and no dead round
is ever computed — so nothing is padded, nothing is trimmed, and the JAX
engines' ``trace_count`` has no counterpart.  (A chunk captured as a CUDA
graph, the counterpart of one compiled dispatch, is later work.)  The chunk
stays the unit of staging, of tracing spans and of ``dispatches``.

The consumer loop never waits on the device
-------------------------------------------
Kernel launches return before the device has run them.  The engines keep
it that way: no ``.item()``, ``float()`` or ``.tolist()`` between rounds,
per-round metrics stay device tensors and are stacked at segment and run
ends, and every host→device copy goes from pinned memory with
``non_blocking=True`` (a copy from pageable memory would wait for the
stream).  So staging chunk k+1 overlaps the device's chunk k.  Only the
per-round loop reads each round's loss on the host, as the JAX package's
per-round loop does: that is the dispatch-bound regime the engines remove.

Pipelined path
--------------
:class:`PipelinedScanEngine` stages through a
:class:`repro_torch.channels.scheduler.SegmentPrefetcher` (inline, or on a
worker thread) and draws its τ inside the chunk, one ``(n,)`` Bernoulli per
real round in round order from the simulator's generator — the same calls,
so the same bits, as the loop's per-round ``sample_tau``.

``ShardedScanEngine`` comes with the distributed slice of the port.
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from repro_torch.channels.scheduler import SegmentPrefetcher, _stack_host, _to_device
from repro_torch.core import relay as relay_lib
from repro_torch.fl.simulator import FLSimulator
from repro_torch.obs import NULL_TRACER
from repro_torch.utils import tree_map


def _stack_rounds(batches: list, device: torch.device) -> Any:
    """Stack a list of per-round batch pytrees into one (R, ...) pytree:
    host-side ``np.stack`` per leaf, then a single device transfer each —
    one H2D per chunk instead of one per round."""
    return _to_device(_stack_host(batches, 0), device=device)


def _segment_value(x, device: torch.device):
    """One of a segment's (A, p, active) on ``device``, copied without
    waiting for the stream's in-flight rounds: f32, except that an
    :class:`~repro_torch.core.relay.EdgeRelay` keeps its leaves' dtypes
    (int32 indices, f32 values)."""
    if x is None:
        return None
    if isinstance(x, relay_lib.EdgeRelay):
        if isinstance(x.vals, torch.Tensor):
            return x
        return _to_device(x, device=device)
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return _to_device(np.array(x, dtype=np.float32), device=device)


def _segment_operands(sim: FLSimulator, A, active):
    """The segment's relay operand and churn mask on the simulator's device
    (the construction-time A when the policy gives none)."""
    A_seg = (
        sim.A
        if A is None
        else relay_lib.as_relay_operand(
            _segment_value(A, sim.device), n=sim.n, backend=sim.relay_backend,
            device=sim.device,
        )
    )
    if A_seg is None and sim.strategy in ("colrel", "colrel_fused"):
        raise ValueError("colrel strategies need a relay matrix A")
    return A_seg, _segment_value(active, sim.device)


def _run_rounds(sim: FLSimulator, params, server_state, batches, taus, lr, A, active):
    """``len(taus)`` rounds of ``round_math``; round r takes ``batches``'
    r-th slice (leaves (R, n, T, b, ...)).  Returns the per-round metrics as
    a list."""
    metrics = []
    for r, tau in enumerate(taus):
        batch = tree_map(lambda x, r=r: x[r], batches)
        params, server_state, m = sim.round_math(
            params, server_state, batch, tau, A, lr, active
        )
        metrics.append(m)
    return params, server_state, metrics


def _stack_metrics(per_round: list) -> Any:
    """Per-round metric dicts → one dict of (R, ...) tensors."""
    return tree_map(lambda *ms: torch.stack(ms), *per_round)


def _concat_metrics(parts: list) -> Any:
    """Concatenate per-segment metric pytrees along the round axis."""
    if len(parts) == 1:
        return parts[0]
    return tree_map(lambda *ms: torch.cat(ms), *parts)


def _event_after(device: torch.device) -> torch.cuda.Event | None:
    """An event recorded on the current stream behind the work enqueued so
    far; None on the CPU, where every op has finished when it returns."""
    if device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record()
    return event


def _fence(device: torch.device) -> None:
    """Wait until the device has run everything enqueued so far (a traced
    run's explicit blocked-on-device span; untraced runs never wait)."""
    event = _event_after(device)
    if event is not None:
        event.synchronize()


class EpochScanEngine:
    """Epoch-at-a-time execution for an :class:`FLSimulator`.

    The engine never re-implements round math: each round is
    ``sim.round_math``, and a segment runs as ``ceil(R / chunk)`` chunks,
    the last one at its real length.
    """

    def __init__(self, sim: FLSimulator, *, chunk: int = 32, tracer=None):
        """``chunk`` is the number of rounds staged (batches stacked and
        moved to the device) at a time.

        ``tracer`` (a :class:`repro_torch.obs.Tracer`) records per-chunk
        dispatch spans plus explicit blocked-on-device fences; the fences
        remove the host/device overlap (observer effect), so they — like
        every other traced extra — run only when ``tracer.enabled``.  Also
        settable after construction via the ``tracer`` attribute.
        """
        if chunk < 1:
            raise ValueError("chunk must be >= 1")
        self.sim = sim
        self.chunk = int(chunk)
        self.tracer = NULL_TRACER if tracer is None else tracer

    def sample_taus(self, generator: torch.Generator, p, n_rounds: int):
        """A segment's τ stream: ``n_rounds`` sequential ``sim.sample_tau``
        draws from ``generator``, exactly the loop's per-round calls.
        Returns ``(generator, (n_rounds, n) taus)``."""
        p = _segment_value(p, self.sim.device)
        if self.tracer.enabled:
            with self.tracer.span("scan.taus", cat="dispatch", rounds=n_rounds):
                taus = [self.sim.sample_tau(generator, p) for _ in range(n_rounds)]
        else:
            taus = [self.sim.sample_tau(generator, p) for _ in range(n_rounds)]
        return generator, torch.stack(taus)

    def run_segment(
        self, params, server_state, batches, taus, lr, *, A=None, active=None
    ):
        """Run one channel epoch: ``R`` rounds under a fixed (A, active).

        ``batches``: pytree with leaves (R, n, T, b, ...) — the epoch's data
        stream; ``taus``: (R, n) — the epoch's uplink masks (e.g. from
        :meth:`sample_taus`).  Returns ``(params, server_state, metrics)``
        with every metric stacked over the R rounds.
        """
        A_seg, active_seg = _segment_operands(self.sim, A, active)
        return self._run_segment(
            params, server_state, batches, taus, lr, A_seg, active_seg
        )

    def _run_segment(self, params, server_state, batches, taus, lr, A, active):
        dev = self.sim.device
        taus = torch.as_tensor(taus, dtype=torch.float32, device=dev)
        batches = tree_map(lambda x: torch.as_tensor(x, device=dev), batches)
        R, C = int(taus.shape[0]), self.chunk
        if R == 0:
            raise ValueError("empty segment")
        per_round = []
        for start in range(0, R, C):
            stop = min(start + C, R)
            chunk_batches = tree_map(lambda x: x[start:stop], batches)
            if self.tracer.enabled:
                with self.tracer.span("scan.chunk", cat="dispatch", rounds=stop - start):
                    params, server_state, ms = _run_rounds(
                        self.sim, params, server_state, chunk_batches,
                        taus[start:stop], lr, A, active,
                    )
                # explicit fence: bills the in-flight chunk to the device
                # phase (untraced runs never block here)
                with self.tracer.span("scan.device", cat="device", track="device"):
                    _fence(dev)
            else:
                params, server_state, ms = _run_rounds(
                    self.sim, params, server_state, chunk_batches,
                    taus[start:stop], lr, A, active,
                )
            per_round.extend(ms)
        return params, server_state, _stack_metrics(per_round)

    def run_schedule(
        self,
        generator: torch.Generator,
        params,
        server_state,
        *,
        schedule,
        rounds,
        next_batch: Callable[[], Any],
        lr,
        policy=None,
        on_segment: Callable | None = None,
    ):
        """Drive a :class:`ChannelSchedule` for ``rounds`` rounds, one
        segment per channel epoch.

        Mirrors the per-round loop exactly: τ is drawn once per round
        in round order (``sample_taus``), ``next_batch()`` is called once per
        round in round order, and ``policy.relay_matrix`` is evaluated once
        per segment — the same value the loop's per-round calls get from the
        policy's cache.  The trajectory is therefore bit-identical to calling
        ``run_round`` round by round.

        ``next_batch`` returns one round's stacked batch pytree
        (n, T, b, ...) of numpy arrays.  ``on_segment(segment, params,
        metrics)`` is an optional host callback per epoch (evaluation
        hooks).  Returns ``(params, server_state, metrics, generator)`` with
        metrics stacked over all rounds.
        """
        dev = self.sim.device
        all_metrics = []
        for seg in schedule.segments(rounds):
            A = policy.relay_matrix(seg.state) if policy is not None else None
            # channel values are loop-invariant within a segment: one device
            # conversion per epoch, not per chunk
            A_seg, active_seg = _segment_operands(self.sim, A, seg.active)
            p_seg = _segment_value(seg.p, dev)
            # materialize the segment chunk by chunk: never hold more than
            # one chunk of batches in memory
            seg_metrics = []
            for start in range(0, seg.n_rounds, self.chunk):
                window = min(self.chunk, seg.n_rounds - start)
                generator, taus = self.sample_taus(generator, p_seg, window)
                if self.tracer.enabled:
                    with self.tracer.span(
                        "scan.stage", cat="stage", epoch=seg.epoch_id, rounds=window
                    ):
                        stacked = _stack_rounds(
                            [next_batch() for _ in range(window)], dev
                        )
                else:
                    stacked = _stack_rounds([next_batch() for _ in range(window)], dev)
                params, server_state, metrics = self._run_segment(
                    params, server_state, stacked, taus, lr, A_seg, active_seg
                )
                seg_metrics.append(metrics)
            metrics = _concat_metrics(seg_metrics)
            all_metrics.append(metrics)
            if on_segment is not None:
                on_segment(seg, params, metrics)
        return params, server_state, _concat_metrics(all_metrics), generator


class PipelinedScanEngine:
    """Pipelined epoch execution: τ drawn in the chunk + host/device overlap.

    Two changes over :class:`EpochScanEngine`, one on each side of the
    launch boundary:

    * **Device** — the τ stream is drawn at the start of each chunk, one
      ``(n,)`` Bernoulli per real round in round order from the simulator's
      generator; there is no separate τ step.  ``dispatches`` counts the
      chunks.
    * **Host** — the schedule walk, the adaptive OPT-α re-solves and the
      per-chunk batch staging (stack + pinned H2D copy) run through a
      :class:`~repro_torch.channels.scheduler.SegmentPrefetcher`.  Because
      kernel launches return before the device runs them, staging epoch k+1
      overlaps the device's in-flight chunk of epoch k — double-buffered
      inline by default, or ``prefetch_depth`` chunks ahead on a worker
      thread (``prefetch="thread"``); measured as
      ``prefetch_stats.overlap_fraction``.  The consumer loop itself never
      waits on the device.

    The rounds are ``sim.round_math`` and the generator calls, batch order
    and policy call order are the serial loop's exactly, so the
    trajectory is bit-identical to the loop's.
    """

    def __init__(
        self,
        sim: FLSimulator,
        *,
        chunk: int = 32,
        prefetch: str = "inline",
        prefetch_depth: int = 2,
        tracer=None,
    ):
        """``prefetch`` picks the staging mode (see
        :class:`~repro_torch.channels.scheduler.SegmentPrefetcher`):
        ``"inline"`` (default) stages on the consumer thread behind the
        asynchronous launches; ``"thread"`` stages on a worker thread
        ``prefetch_depth`` chunks ahead.

        ``tracer`` flows to the prefetcher (stage/h2d spans on the
        ``prefetcher`` track) and adds per-chunk dispatch + device-fence
        spans on the consumer side.  The fences serialize the pipeline
        (observer effect): traced runs show *where* time goes, untraced
        runs measure how fast it is.  Also settable after construction via
        the ``tracer`` attribute."""
        if chunk < 1:
            raise ValueError("chunk must be >= 1")
        if prefetch not in ("inline", "thread"):
            raise ValueError(f"unknown prefetch mode: {prefetch!r}")
        self.sim = sim
        self.chunk = int(chunk)
        self.prefetch = prefetch
        self.prefetch_depth = int(prefetch_depth)
        self.tracer = NULL_TRACER if tracer is None else tracer
        # per-run counters (reset by run_schedule, like prefetch_stats):
        # chunks run — exactly one per staged chunk
        self.dispatches = 0
        self.prefetch_stats = None  # PrefetchStats of the latest run

    def _chunk(self, generator, params, server_state, batches, n_rounds, A, p, lr, active):
        # all the chunk's τ first, in round order: the generator serves
        # nothing else, so this is the loop's draw sequence exactly
        taus = [self.sim.sample_tau(generator, p) for _ in range(n_rounds)]
        return _run_rounds(self.sim, params, server_state, batches, taus, lr, A, active)

    def run_schedule(
        self,
        generator: torch.Generator,
        params,
        server_state,
        *,
        schedule,
        rounds,
        next_batch: Callable[[], Any],
        lr,
        policy=None,
        on_segment: Callable | None = None,
    ):
        """Drive a ``ChannelSchedule`` for ``rounds`` rounds — same contract
        and bit-identical trajectory as :meth:`EpochScanEngine.run_schedule`
        and the per-round loop, but with host staging prefetched.
        ``on_segment(segment, params, metrics)`` hands over the epoch's
        params; a callback that reads them waits for the device, so leave it
        unset on pure-throughput runs.  Returns
        ``(params, server_state, metrics, generator)``.
        """
        dev = self.sim.device
        self.dispatches = 0
        prefetcher = SegmentPrefetcher(
            schedule,
            rounds,
            chunk=self.chunk,
            next_batch=next_batch,
            policy=policy,
            depth=self.prefetch_depth,
            threaded=self.prefetch == "thread",
            tracer=self.tracer,
            device=dev,
        )
        all_metrics: list = []  # one stacked metrics dict per segment
        seg_parts: list = []  # the current segment's per-round metrics
        seg_id = A_seg = p_seg = active_seg = None
        try:
            for item in prefetcher:
                seg = item.segment
                if seg.epoch_id != seg_id:
                    # channel values are loop-invariant within a segment:
                    # one device conversion per epoch, not per chunk
                    seg_id = seg.epoch_id
                    A_seg, active_seg = _segment_operands(self.sim, item.A, seg.active)
                    p_seg = _segment_value(seg.p, dev)
                if self.tracer.enabled:
                    with self.tracer.span(
                        "pipelined.chunk",
                        cat="dispatch",
                        epoch=seg.epoch_id,
                        rounds=item.n_rounds,
                    ):
                        params, server_state, ms = self._chunk(
                            generator, params, server_state, item.batches,
                            item.n_rounds, A_seg, p_seg, lr, active_seg,
                        )
                else:
                    params, server_state, ms = self._chunk(
                        generator, params, server_state, item.batches,
                        item.n_rounds, A_seg, p_seg, lr, active_seg,
                    )
                self.dispatches += 1
                prefetcher.note_inflight(_event_after(dev))
                if self.tracer.enabled:
                    # explicit fence: serializes the pipeline (observer
                    # effect), but makes blocked-on-device time a
                    # first-class phase on its own track
                    with self.tracer.span(
                        "pipelined.device",
                        cat="device",
                        track="device",
                        epoch=seg.epoch_id,
                    ):
                        _fence(dev)
                seg_parts.extend(ms)
                if item.last_in_segment:
                    seg_metrics = _stack_metrics(seg_parts)
                    seg_parts = []
                    all_metrics.append(seg_metrics)
                    if on_segment is not None:
                        on_segment(seg, params, seg_metrics)
        finally:
            prefetcher.close()
            self.prefetch_stats = prefetcher.stats
        if self.tracer.enabled:
            self.tracer.count("pipelined.dispatches", self.dispatches)
        return params, server_state, _concat_metrics(all_metrics), generator


def run_rounds_loop(
    sim: FLSimulator,
    generator: torch.Generator,
    params,
    server_state,
    *,
    schedule,
    rounds,
    next_batch: Callable[[], Any],
    lr,
    policy=None,
    on_round: Callable | None = None,
    tracer=None,
):
    """The per-round reference loop: one ``run_round`` per round and, like
    the JAX package's per-round loop, a host read of the round's loss
    (``float(...)``, a device sync per round).  Factored out so engine
    comparisons share one definition.  ``tracer`` records per-round
    stage/dispatch/sync spans (the loop already syncs per round, so tracing
    adds no extra fence here).
    Returns ``(params, server_state, per_round_metrics, generator)``."""
    tracer = NULL_TRACER if tracer is None else tracer
    all_metrics = []
    for state in schedule.rounds(rounds):
        A = policy.relay_matrix(state) if policy is not None else None
        if tracer.enabled:
            with tracer.span("loop.stage", cat="stage", round=state.round):
                batch = sim._to_device(next_batch())
            with tracer.span("loop.round", cat="dispatch", round=state.round):
                params, server_state, m = sim.run_round(
                    generator,
                    params,
                    server_state,
                    batch,
                    lr,
                    A=A,
                    p=state.p,
                    active=state.active,
                )
            with tracer.span(
                "loop.sync", cat="device", track="device", round=state.round
            ):
                float(m["loss"])  # the per-round loop's host sync
        else:
            batch = sim._to_device(next_batch())
            params, server_state, m = sim.run_round(
                generator,
                params,
                server_state,
                batch,
                lr,
                A=A,
                p=state.p,
                active=state.active,
            )
            float(m["loss"])  # the per-round host sync of the reference loop
        all_metrics.append(m)
        if on_round is not None:
            on_round(state.round, params)
    return params, server_state, _stack_metrics(all_metrics), generator
