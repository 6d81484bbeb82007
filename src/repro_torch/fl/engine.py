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

A full chunk is one CUDA graph
------------------------------
JAX fuses a chunk into one compiled ``lax.scan`` and pads a remainder chunk
to the chunk length (a scan's length is static, and a new length would
recompile).  The port's counterpart of that compiled chunk is the chunk
captured once as a CUDA graph (:class:`_ChunkGraph`) and replayed: one
launch from the host for the thousands of kernels a ResNet round makes.
Only **full-length** chunks are captured, one graph per (chunk length,
churn mask present or not) and engine, so ``trace_count`` (the number of
captures) stays at most 2 across epochs of any length, as the reference's
compile count does.  The rest run eagerly, as a Python loop over
``round_math``, and are counted in ``eager_chunks``:

* a remainder chunk, at its real length (padding it to the chunk length
  would compute dead rounds: a capture costs about one eager chunk);
* every chunk on the ``segment`` backend, whose ``EdgeRelay`` changes its
  edge count from epoch to epoch;
* every chunk on the CPU (and on gloo ranks), where there is no graph;
* every chunk of an engine built with ``capture=False``.

A capture that fails on the card raises; no chunk falls back to eager.
The chunk stays the unit of staging, of tracing spans and of
``dispatches``; ``replays`` counts the chunks run through a graph.

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
so the same bits, as the loop's per-round ``sample_tau``.  A captured chunk
draws them inside its graph (:class:`_ChunkGraph` says how the generator
keeps the loop's state).

Sharded path
------------
:class:`ShardedScanEngine` drives the multi-rank step of
:func:`repro_torch.fl.distributed.build_sharded_scan_round_step` one whole
channel epoch a call, every rank running the same host walk; each rank
stages only its own clients' rows of every epoch.  On the card it captures
each epoch length once, collectives included.
"""
from __future__ import annotations

import functools
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.channels.scheduler import SegmentPrefetcher, _stack_host, _to_device
from repro_torch.core import relay as relay_lib
from repro_torch.fl.simulator import FLSimulator
from repro_torch.kernels import relay_mix as _kernels
from repro_torch.obs import NULL_TRACER
from repro_torch.sharding import rules as sharding_rules
from repro_torch.utils import resolve_device, tree_flatten, tree_map


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


class _ChunkGraph:
    """One chunk captured as a CUDA graph: the counterpart of the JAX
    engines' compiled chunk, as ``launch/serve.py``'s ``_DecodeGraph`` is of
    the compiled decode step.

    ``fn(generator, *inputs)`` is the chunk; ``inputs`` a tuple of pytrees
    of tensors (``None`` allowed), the learning rate among them as a 0-d
    device tensor (a Python float would be baked into the graph).  The
    graph reads its inputs from static buffers cloned from the first call's:
    a call copies the chunk's inputs in, replays, and returns clones of the
    outputs (the next replay overwrites the graph's own).

    Before the capture the chunk runs once on a side stream, on clones,
    which warms up cuBLAS, cuDNN, ``torch.func`` and the kernels' library.
    A chunk that draws from a generator (τ in the pipelined and sharded
    engines) draws in the graph from a private generator registered with
    it (``CUDAGraph.register_generator_state``): the warm-up draws from it
    too, so the caller's generator is left as it was, and a call hands it
    the caller's state and hands the advanced state back.  A full chunk
    always makes the same draws, so each replay advances the state as the
    eager chunk does.  The relay kernels launched during the capture count
    once a replay (:func:`repro_torch.kernels.relay_mix.count_launches`);
    the warm-up and the capture count nothing.

    Capture runs in ``thread_local`` error mode, so the threaded
    prefetcher's pinned copies on another thread may go on meanwhile.  A
    capture that fails raises."""

    def __init__(self, fn, inputs: tuple, *, generator: torch.Generator | None = None):
        saved = dict(_kernels.LAUNCHES)
        self.static = tree_map(torch.clone, inputs)
        self._gen = None
        if generator is not None:
            self._gen = torch.Generator(device=generator.device)
            self._gen.set_state(generator.get_state())
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn(self._gen, *tree_map(torch.clone, self.static))
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        if self._gen is not None:
            self.graph.register_generator_state(self._gen)
        before = dict(_kernels.LAUNCHES)
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            self.out = fn(self._gen, *self.static)
        self.launches = {k: _kernels.LAUNCHES[k] - before[k] for k in before}
        _kernels.LAUNCHES.update(saved)

    def __call__(self, generator, *inputs):
        tree_map(lambda dst, src: dst.copy_(src), self.static, inputs)
        if self._gen is not None:
            self._gen.set_state(generator.get_state())
        self.graph.replay()
        if self._gen is not None:
            generator.set_state(self._gen.get_state())
        _kernels.count_launches(self.launches)
        return tree_map(torch.clone, self.out)


def _signature(inputs: tuple) -> tuple:
    """The structure, shapes and dtypes of a chunk's inputs, the key of its
    graph: the chunk length is the batches' leading dim, and a churn mask
    present or not changes the structure."""
    leaves, treedef = tree_flatten(inputs)
    return treedef, tuple((tuple(x.shape), x.dtype) for x in leaves)


class _Chunks:
    """Runs one engine's chunks: a full chunk on the card through its
    captured graph (captured at first use, one per input signature), any
    other chunk eagerly.  Counts the captures (``trace_count``), the
    replays and the eager chunks."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.graphs: dict = {}
        self.replays = 0
        self.eager_chunks = 0

    def reset(self) -> None:
        """Zero the per-run counters; the captures stay cached."""
        self.replays = self.eager_chunks = 0

    def run(self, fn, generator, inputs: tuple, *, full: bool, lr):
        """``fn(generator, *inputs)`` with ``lr`` appended to ``inputs``:
        replayed if ``full`` and capture is on, else eager with ``lr`` as
        the caller gave it."""
        if not (self.enabled and full):
            self.eager_chunks += 1
            return fn(generator, *inputs, lr)
        dev = tree_flatten(inputs)[0][0].device
        lr = (lr.to(device=dev, dtype=torch.float32) if isinstance(lr, torch.Tensor)
              else torch.full((), lr, dtype=torch.float32, device=dev))  # a fill, no copy
        inputs = (*inputs, lr)
        sig = _signature(inputs)
        graph = self.graphs.get(sig)
        if graph is None:
            graph = self.graphs[sig] = _ChunkGraph(fn, inputs, generator=generator)
        self.replays += 1
        return graph(generator, *inputs)


def _captures(capture: bool, device: torch.device, backend: str | None = None) -> bool:
    """Whether an engine captures its full chunks: asked to, on a CUDA
    device, with a dense relay operand (every backend but ``segment``)."""
    return capture and device.type == "cuda" and backend != "segment"


class EpochScanEngine:
    """Epoch-at-a-time execution for an :class:`FLSimulator`.

    The engine never re-implements round math: each round is
    ``sim.round_math``, and a segment runs as ``ceil(R / chunk)`` chunks,
    the last one at its real length.  On the card a full chunk is captured
    once as a CUDA graph and replayed (the module docstring says which
    chunks run eagerly): ``trace_count`` counts the captures, as the JAX
    engine's counts its compiles; ``replays`` and ``eager_chunks`` count the
    chunks of the latest ``run_schedule`` each way.
    """

    def __init__(self, sim: FLSimulator, *, chunk: int = 32, tracer=None,
                 capture: bool = True):
        """``chunk`` is the number of rounds staged (batches stacked and
        moved to the device) at a time, and the length of a captured chunk.
        ``capture=False`` runs every chunk eagerly.

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
        self._chunks = _Chunks(_captures(capture, sim.device, sim.relay_backend))

    @property
    def trace_count(self) -> int:
        return len(self._chunks.graphs)

    @property
    def replays(self) -> int:
        return self._chunks.replays

    @property
    def eager_chunks(self) -> int:
        return self._chunks.eager_chunks

    def _chunk_fn(self, _generator, params, server_state, batches, taus, A, active, lr):
        return _run_rounds(self.sim, params, server_state, batches, taus, lr, A, active)

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
            inputs = (params, server_state, tree_map(lambda x: x[start:stop], batches),
                      taus[start:stop], A, active)
            with self.tracer.span("scan.chunk", cat="dispatch", rounds=stop - start):
                params, server_state, ms = self._chunks.run(
                    self._chunk_fn, None, inputs, full=stop - start == C, lr=lr)
            if self.tracer.enabled:
                # explicit fence: bills the in-flight chunk to the device
                # phase (untraced runs never block here)
                with self.tracer.span("scan.device", cat="device", track="device"):
                    _fence(dev)
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
        self._chunks.reset()
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

    On the card a full chunk, its τ draws included, is captured once as a
    CUDA graph and replayed, as in :class:`EpochScanEngine`:
    ``trace_count``, ``replays`` and ``eager_chunks`` count the same way.

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
        capture: bool = True,
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
        the ``tracer`` attribute.  ``capture=False`` runs every chunk
        eagerly."""
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
        self._chunks = _Chunks(_captures(capture, sim.device, sim.relay_backend))

    @property
    def trace_count(self) -> int:
        return len(self._chunks.graphs)

    @property
    def replays(self) -> int:
        return self._chunks.replays

    @property
    def eager_chunks(self) -> int:
        return self._chunks.eager_chunks

    def _chunk_fn(self, generator, params, server_state, batches, p, A, active, lr):
        # all the chunk's τ first, in round order: the generator serves
        # nothing else, so this is the loop's draw sequence exactly
        n_rounds = tree_flatten(batches)[0][0].shape[0]
        taus = [self.sim.sample_tau(generator, p) for _ in range(n_rounds)]
        return _run_rounds(self.sim, params, server_state, batches, taus, lr, A, active)

    def _chunk(self, generator, params, server_state, batches, n_rounds, A, p, lr, active):
        return self._chunks.run(
            self._chunk_fn, generator, (params, server_state, batches, p, A, active),
            full=n_rounds == self.chunk, lr=lr)

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
        self._chunks.reset()
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
                    if p_seg is None:
                        p_seg = self.sim.p
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


class ShardedScanEngine:
    """Schedule driver for the multi-rank sharded round step.

    Wraps a ``scan_rounds`` built by
    :func:`repro_torch.fl.distributed.build_sharded_scan_round_step` and
    drives a ``ChannelSchedule`` one **whole epoch a call** — the channel
    tuple (A, p, active) is constant within an epoch, so the epoch is the
    natural unit and nothing is padded.  Every rank of the mesh runs the
    same walk: the same segments, OPT-α solves and batch draws, in the
    serial driver's order, so A, p, the churn mask and the generator agree
    on every rank without a message.

    Staging differs from the single-device engines in one way: in
    ``shard="clients"`` mode each host-stacked epoch is cut to this rank's
    block of :func:`repro_torch.sharding.rules.round_batch_specs`'s layout
    (dim 1, the rank's clients) before the copy, so a rank moves only its
    clients' bytes to its device.  (In ``shard="d"`` mode every rank runs
    every client, so the whole epoch is copied.)

    ``prefetch`` picks the staging mode: ``"serial"`` stages each epoch
    inline before its call (the scan engine's way); ``"inline"`` /
    ``"thread"`` stage through a
    :class:`~repro_torch.channels.scheduler.SegmentPrefetcher` (its ``place``
    hook does the cut), overlapping epoch k+1's OPT-α re-solve, stacking and
    copy with epoch k on the device — measured in ``prefetch_stats``.

    The trajectory matches the one-rank fused step to the exchange's
    guarantee: bitwise for ``exchange="gather"``, f32-accumulation tolerance
    for ``exchange="ring"`` (see `repro_torch.fl.ring`).

    On the card each call, the epoch's collectives included, is captured
    once as a CUDA graph per (epoch length, churn mask present or not) and
    replayed, as the JAX engine compiles one epoch per length:
    ``trace_count`` counts the captures.  The communicator is warmed up by
    the capture's warm-up run.  Gloo ranks on the CPU run every epoch
    eagerly (``trace_count`` 0).
    """

    def __init__(
        self,
        step_fn: Callable,
        *,
        mesh,
        shard: str = "clients",
        prefetch: str = "inline",
        prefetch_depth: int = 2,
        tracer=None,
        device=None,
        capture: bool = True,
    ):
        """``step_fn`` is the ``scan_rounds(generator, params, server_state,
        batches, p, lr, A=..., active=...)`` callable from
        ``build_sharded_scan_round_step`` (built on the same ``mesh`` and
        ``shard`` mode).  ``tracer`` adds per-epoch dispatch + device-fence
        spans and the prefetcher's stage/h2d spans.  ``device`` is this
        rank's device: the GPU unless the caller passes ``device="cpu"``.
        ``capture=False`` runs every epoch eagerly."""
        if prefetch not in ("serial", "inline", "thread"):
            raise ValueError(f"unknown prefetch mode: {prefetch!r}")
        if shard not in ("clients", "d"):
            raise ValueError(f"unknown shard mode: {shard!r} (clients | d)")
        self.mesh = mesh
        self.shard = shard
        self.prefetch = prefetch
        self.prefetch_depth = int(prefetch_depth)
        self.tracer = NULL_TRACER if tracer is None else tracer
        self.device = resolve_device(device)
        self._step_fn = step_fn
        self.dispatches = 0
        self.prefetch_stats = None
        self._chunks = _Chunks(_captures(capture, self.device))

    @property
    def trace_count(self) -> int:
        return len(self._chunks.graphs)

    @property
    def replays(self) -> int:
        return self._chunks.replays

    @property
    def eager_chunks(self) -> int:
        return self._chunks.eager_chunks

    def _epoch_fn(self, generator, params, server_state, batches, p, A, active, lr):
        _, params, server_state, losses = self._step_fn(
            generator, params, server_state, batches, p, lr, A=A, active=active)
        return params, server_state, losses

    def _place(self, host, *, stream=None):
        """Staging-side placement: host-stacked epoch → this rank's block on
        its device (clients mode: dim 1 cut to the rank's clients)."""
        if self.shard == "clients":
            specs = sharding_rules.round_batch_specs(host, self.mesh)
            host = tree_map(np.ascontiguousarray,
                            sharding_rules.local_shard(host, specs, self.mesh))
        return _to_device(host, device=self.device, stream=stream)

    def _dispatch(self, generator, params, server_state, batches, seg, lr, A):
        dev = self.device
        A, p, active = (_segment_value(x, dev) for x in (A, seg.p, seg.active))
        with self.tracer.span("shard.epoch", cat="dispatch", epoch=seg.epoch_id,
                              rounds=seg.n_rounds):
            out = self._chunks.run(
                self._epoch_fn, generator, (params, server_state, batches, p, A, active),
                full=True, lr=lr)
        self.dispatches += 1
        return (generator, *out)

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
        """Drive a ``ChannelSchedule`` for ``rounds`` rounds across the
        mesh — same contract as :meth:`EpochScanEngine.run_schedule`, called
        by every rank.  A relay policy is required (the sharded step is
        colrel only).  Returns ``(params, server_state, metrics,
        generator)``; ``metrics`` is ``{"loss": (rounds,)}`` — the
        active-masked mean client loss per round, the same on every rank."""
        if policy is None:
            raise ValueError("the sharded engine needs a relay policy")
        dev = self.device
        self.dispatches = 0
        self.prefetch_stats = None
        self._chunks.reset()
        stream = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
        place = functools.partial(self._place, stream=stream)
        losses: list = []

        def finish(seg, out):
            nonlocal generator, params, server_state
            generator, params, server_state, seg_losses = out
            if self.tracer.enabled:
                with self.tracer.span(
                    "shard.device", cat="device", track="device", epoch=seg.epoch_id
                ):
                    _fence(dev)
            losses.append(seg_losses)
            if on_segment is not None:
                on_segment(seg, params, {"loss": seg_losses})

        if self.prefetch == "serial":
            for seg in schedule.segments(rounds):
                A = policy.relay_matrix(seg.state)
                with self.tracer.span("shard.stage", cat="stage", epoch=seg.epoch_id):
                    stacked = place(_stack_host([next_batch() for _ in range(seg.n_rounds)], 0))
                finish(seg, self._dispatch(generator, params, server_state, stacked,
                                           seg, lr, A))
        else:
            # chunk = the full horizon ⇒ exactly one staged item per segment
            # (a segment never exceeds the horizon): the sharded step runs
            # whole epochs, so staging must hand it whole epochs
            prefetcher = SegmentPrefetcher(
                schedule,
                rounds,
                chunk=rounds,
                next_batch=next_batch,
                policy=policy,
                depth=self.prefetch_depth,
                threaded=self.prefetch == "thread",
                tracer=self.tracer,
                place=place,
            )
            try:
                for item in prefetcher:
                    out = self._dispatch(generator, params, server_state, item.batches,
                                         item.segment, lr, item.A)
                    prefetcher.note_inflight(_event_after(dev))
                    finish(item.segment, out)
            finally:
                prefetcher.close()
            self.prefetch_stats = prefetcher.stats
        if self.tracer.enabled:
            self.tracer.count("shard.dispatches", self.dispatches)
        return params, server_state, {"loss": torch.cat(losses)}, generator


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
    taus=None,
):
    """The per-round reference loop: one ``run_round`` per round and, like
    the JAX package's per-round loop, a host read of the round's loss
    (``float(...)``, a device sync per round).  Factored out so engine
    comparisons share one definition.  ``tracer`` records per-round
    stage/dispatch/sync spans (the loop already syncs per round, so tracing
    adds no extra fence here).  ``taus``: a (rounds, n) array whose row i is
    round i's uplink mask, used instead of drawing from ``generator`` (the
    cross-package tests hand over the JAX package's τ stream this way).
    Returns ``(params, server_state, per_round_metrics, generator)``."""
    tracer = NULL_TRACER if tracer is None else tracer
    all_metrics = []
    for i, state in enumerate(schedule.rounds(rounds)):
        A = policy.relay_matrix(state) if policy is not None else None
        tau = None if taus is None else taus[i]
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
                    tau=tau,
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
                tau=tau,
            )
            float(m["loss"])  # the per-round host sync of the reference loop
        all_metrics.append(m)
        if on_round is not None:
            on_round(state.round, params)
    return params, server_state, _stack_metrics(all_metrics), generator
