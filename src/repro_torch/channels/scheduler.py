"""Relay-matrix scheduling over a time-varying channel.

``AdaptiveOptAlpha`` is the subsystem's hot-path policy: it re-runs OPT-α
only when the channel *value* actually changes (LRU cache keyed on the
channel bytes) and, on a miss, warm-starts the Gauss–Seidel solve from the
previous epoch's optimum projected onto the new support
(:func:`repro_torch.core.opt_alpha.warm_start_weights`) — after a small
perturbation that converges in a few sweeps instead of from scratch.  The
joint OPT-α objective is convex, so warm- and cold-started solves reach the
same S(p, A) (tested).

``SparseOptAlpha`` is the same policy on the neighborhood-blocked solver
(:func:`repro_torch.core.opt_alpha.optimize_sparse`): it returns
:class:`~repro_torch.core.relay.EdgeRelay` operands for the ``segment``
relay backend and keeps every per-round cost and cache entry O(E) — the
policy to pair with per-round cohort sampling at n ≫ 10³.

``StaleOptAlpha`` is the ablation baseline: solve once on the first channel
and reuse that A forever.  Because a relay matrix is only physically
realizable on the *current* graph (a down link carries nothing), stale
matrices must be projected onto the live topology at use time —
:func:`project_to_support` — which is exactly where the staleness penalty
(lost mass ⇒ bias) comes from.

``SegmentPrefetcher`` is the host side of the pipelined execution path
(:class:`repro_torch.fl.engine.PipelinedScanEngine`): it walks
``ChannelSchedule.segments()``, solves the relay matrix per segment and
stages per-chunk batch stacks, so that all host work for epoch k+1 (OPT-α
re-solve, batch stacking, segment sampling) overlaps the device's
in-flight chunk of epoch k instead of serializing with it.  Staging runs
inline behind CUDA's asynchronous kernel launches by default (no extra
thread), or on a background worker thread feeding a small bounded queue
(``threaded=True``).

The PyTorch counterpart of the JAX package's ``channels/scheduler.py``: the
host numpy is kept line for line, so the same stream gives the same relay
matrices and the same staged items.
"""
from __future__ import annotations

import dataclasses
import functools
import queue
import sys
import threading
import time
import weakref
from collections import OrderedDict
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.channels.schedule import ChannelSegment, ChannelState
from repro_torch.core import opt_alpha, topology
from repro_torch.core import relay as relay_lib
from repro_torch.obs import NULL_TRACER
from repro_torch.utils import resolve_device, tree_map


def project_to_support(
    A: np.ndarray, adj: np.ndarray, active: np.ndarray | None = None
) -> np.ndarray:
    """Zero every relay weight that the current graph cannot carry
    (j ∉ N_i ∪ {i}).  Models using an outdated A on a changed topology.
    With a churn mask ``active``, weights touching a departed client are
    zeroed too (a slot that left the run carries nothing)."""
    m = topology.closed_mask(np.asarray(adj, dtype=bool).copy())
    if active is not None:
        a = np.asarray(active, dtype=bool)
        m = m & a[:, None] & a[None, :]
    return np.where(m, np.asarray(A, dtype=np.float64), 0.0)


@dataclasses.dataclass
class SchedulerStats:
    """Per-policy counters.  ``rounds == cache_hits + cache_misses`` always
    (every ``relay_matrix`` call is exactly one or the other), and
    ``cache_misses == solves`` (a miss is what triggers a solve);
    ``evictions`` counts entries the LRU bound pushed out."""

    rounds: int = 0
    cache_hits: int = 0
    cache_misses: int = 0
    solves: int = 0
    warm_solves: int = 0
    sweeps_total: int = 0
    evictions: int = 0

    @property
    def mean_sweeps(self) -> float:
        return self.sweeps_total / self.solves if self.solves else 0.0


class AdaptiveOptAlpha:
    """Per-round relay matrices for a :class:`ChannelSchedule` stream."""

    def __init__(
        self,
        *,
        sweeps: int = 40,
        warm_sweeps: int | None = None,
        tol: float = 1e-10,
        cache_size: int = 64,
        warm_start: bool = True,
        method: str = "bisect",
        tracer=None,
    ):
        if cache_size < 1:
            raise ValueError("cache_size must be >= 1")
        self.sweeps = sweeps
        self.warm_sweeps = sweeps if warm_sweeps is None else warm_sweeps
        self.tol = tol
        self.cache_size = cache_size
        self.warm_start = warm_start
        self.method = method
        self.stats = SchedulerStats()
        # telemetry (repro_torch.obs): cache hit/miss/eviction counters plus one
        # span per solve, keyed by the masked client count — the NULL_TRACER
        # default keeps the untraced path to a single attribute check
        self.tracer = NULL_TRACER if tracer is None else tracer
        self._cache: OrderedDict[tuple, np.ndarray] = OrderedDict()
        self._last_A: np.ndarray | None = None

    def relay_matrix(self, state: ChannelState) -> np.ndarray:
        self.stats.rounds += 1
        key = state.key()
        hit = self._cache.get(key)
        if hit is not None:
            self._cache.move_to_end(key)
            self.stats.cache_hits += 1
            if self.tracer.enabled:
                self.tracer.count("opt_alpha.cache_hits")
            self._last_A = hit
            return hit
        self.stats.cache_misses += 1
        if self.tracer.enabled:
            self.tracer.count("opt_alpha.cache_misses")
        A0 = None
        sweeps = self.sweeps
        masked = state.active is not None and not state.active.all()
        if masked:
            # churn: the solve lives on the active block — restrict the
            # channel first so the warm start and optimum never put mass on
            # a departed client
            a = np.asarray(state.active, dtype=bool)
            p_eff = np.where(a, state.p.astype(np.float64), 0.0)
            adj_eff = state.adj & a[:, None] & a[None, :]
        else:
            p_eff, adj_eff = state.p, state.adj
        if self.warm_start and self._last_A is not None:
            A0 = opt_alpha.warm_start_weights(p_eff, adj_eff, self._last_A)
            sweeps = self.warm_sweeps
            self.stats.warm_solves += 1
        def _solve():
            if masked:
                return opt_alpha.optimize_masked(
                    state.p,
                    state.adj,
                    state.active,
                    sweeps=sweeps,
                    tol=self.tol,
                    A0=A0,
                    method=self.method,
                )
            return opt_alpha.optimize(
                state.p,
                state.adj,
                sweeps=sweeps,
                tol=self.tol,
                A0=A0,
                method=self.method,
            )

        if self.tracer.enabled:
            with self.tracer.span(
                "opt_alpha.solve",
                cat="solve",
                epoch=state.epoch_id,
                n_active=state.n_active,
                warm=A0 is not None,
            ):
                res = _solve()
            self.tracer.count("opt_alpha.solves")
            self.tracer.count("opt_alpha.sweeps", res.sweeps)
        else:
            res = _solve()
        self.stats.solves += 1
        self.stats.sweeps_total += res.sweeps
        # the cache and the warm-start seed alias the returned array; freeze
        # it so a caller mutating A cannot silently corrupt later epochs
        res.A.setflags(write=False)
        self._cache[key] = res.A
        if len(self._cache) > self.cache_size:
            self._cache.popitem(last=False)
            self.stats.evictions += 1
            if self.tracer.enabled:
                self.tracer.count("opt_alpha.evictions")
        self._last_A = res.A
        return res.A


class SparseOptAlpha:
    """Neighborhood-blocked OPT-α policy: ``relay_matrix`` returns an
    :class:`~repro_torch.core.relay.EdgeRelay` instead of a dense matrix.

    The scale-path sibling of :class:`AdaptiveOptAlpha` for
    ``relay_backend="segment"``: nothing here is O(n²) or O(n²)-sized —
    the closed-neighborhood CSC structure is extracted once per distinct
    adjacency (memoized on the channel key's adjacency bytes, which the
    schedule interns for an unchanged graph, so the comparison is a pointer
    check) and every solve reuses it; the LRU cache stores (E,) value
    vectors, not (n, n) matrices, so per-round cohorts at n = 10⁴ don't
    hoard gigabytes; warm starts project the previous cohort's edge values
    (:func:`repro_torch.core.opt_alpha.warm_start_vals`).  Same counters and
    telemetry as the dense policy.

    Every returned EdgeRelay shares the graph's index arrays and segment
    layout (built once a graph: the fixed-order summation plan of
    :mod:`repro_torch.core.relay`) and spans the *full* closed structure
    with zeros on inactive entries — constant edge count, so a cohort
    change moves only the (E,) values.
    """

    def __init__(
        self,
        *,
        sweeps: int = 40,
        warm_sweeps: int | None = None,
        tol: float = 1e-10,
        cache_size: int = 64,
        warm_start: bool = True,
        method: str = "bisect",
        tracer=None,
    ):
        if cache_size < 1:
            raise ValueError("cache_size must be >= 1")
        self.sweeps = sweeps
        self.warm_sweeps = sweeps if warm_sweeps is None else warm_sweeps
        self.tol = tol
        self.cache_size = cache_size
        self.warm_start = warm_start
        self.method = method
        self.stats = SchedulerStats()
        self.tracer = NULL_TRACER if tracer is None else tracer
        self._cache: OrderedDict[tuple, relay_lib.EdgeRelay] = OrderedDict()
        self._graph: topology.ClosedGraph | None = None
        self._graph_bytes: bytes | None = None
        self._rows32: np.ndarray | None = None
        self._cols32: np.ndarray | None = None
        self._layout: relay_lib.SegmentLayout | None = None
        self._last_vals: np.ndarray | None = None

    def relay_matrix(self, state: ChannelState) -> relay_lib.EdgeRelay:
        self.stats.rounds += 1
        key = state.key()
        hit = self._cache.get(key)
        if hit is not None:
            self._cache.move_to_end(key)
            self.stats.cache_hits += 1
            if self.tracer.enabled:
                self.tracer.count("opt_alpha.cache_hits")
            self._last_vals = np.asarray(hit.vals, dtype=np.float64)
            return hit
        self.stats.cache_misses += 1
        if self.tracer.enabled:
            self.tracer.count("opt_alpha.cache_misses")
        adj_bytes = key[0]
        if self._graph is None or self._graph_bytes != adj_bytes:
            self._graph = topology.closed_csc(state.adj)
            self._graph_bytes = adj_bytes
            self._rows32 = self._graph.rows.astype(np.int32)
            self._cols32 = self._graph.cols.astype(np.int32)
            self._layout = relay_lib.segment_layout(
                self._rows32, self._cols32, self._graph.n
            )
            for x in (self._rows32, self._cols32, *self._layout):
                x.setflags(write=False)
            self._last_vals = None  # old vals index a different structure
        g = self._graph
        p = state.p.astype(np.float64)
        vals0 = None
        sweeps = self.sweeps
        if self.warm_start and self._last_vals is not None:
            vals0 = opt_alpha.warm_start_vals(p, g, self._last_vals, state.active)
            sweeps = self.warm_sweeps
            self.stats.warm_solves += 1

        def _solve():
            return opt_alpha.optimize_sparse(
                p,
                active=state.active,
                graph=g,
                sweeps=sweeps,
                tol=self.tol,
                vals0=vals0,
                method=self.method,
            )

        if self.tracer.enabled:
            with self.tracer.span(
                "opt_alpha.solve",
                cat="solve",
                epoch=state.epoch_id,
                n_active=state.n_active,
                warm=vals0 is not None,
                sparse=True,
            ):
                res = _solve()
            self.tracer.count("opt_alpha.solves")
            self.tracer.count("opt_alpha.sweeps", res.sweeps)
        else:
            res = _solve()
        self.stats.solves += 1
        self.stats.sweeps_total += res.sweeps
        vals32 = res.vals.astype(np.float32)
        vals32.setflags(write=False)
        er = relay_lib.EdgeRelay(
            rows=self._rows32, cols=self._cols32, vals=vals32, layout=self._layout
        )
        self._cache[key] = er
        if len(self._cache) > self.cache_size:
            self._cache.popitem(last=False)
            self.stats.evictions += 1
            if self.tracer.enabled:
                self.tracer.count("opt_alpha.evictions")
        self._last_vals = res.vals
        return er


@dataclasses.dataclass(frozen=True)
class StagedChunk:
    """One unit of prefetched work: at most ``chunk`` rounds of a single
    channel segment, with everything the device dispatch needs already
    materialized on the host.

    ``segment`` is the *snapshot* the schedule emitted — ``ChannelSchedule.
    _emit`` copies (adj, p, active), so a staged chunk can never observe a
    post-dated field state even though the worker thread has advanced the
    underlying channel processes several epochs past it (tested:
    ``test_prefetched_segments_never_use_postdated_state``).
    """

    segment: ChannelSegment
    # the segment's relay operator (None ⇒ no relaying): a dense matrix from
    # AdaptiveOptAlpha/StaleOptAlpha, or an EdgeRelay from SparseOptAlpha
    A: np.ndarray | relay_lib.EdgeRelay | None
    batches: Any  # pytree of tensors, leaves stacked (n_rounds, ...), on device
    start: int  # offset of this chunk within the segment
    n_rounds: int  # real rounds in this chunk (≤ chunk)
    last_in_segment: bool


@dataclasses.dataclass
class PrefetchStats:
    """Measured host/device overlap of one prefetched run.

    ``prep_s`` is the total staging time (OPT-α solves, ``next_batch``
    calls, stacking, the H2D transfer); ``wait_s`` is the part of it that
    stayed on the consumer's critical path — in threaded mode, how long the
    consumer actually blocked on the queue; in inline mode, staging time
    during which the device had no dispatch in flight to hide it behind.
    ``overlap_fraction = 1 - wait_s / prep_s`` (clamped to [0, 1]) is the
    fraction of host work the pipeline removed from the critical path.

    The first chunk can never overlap (pipeline fill: there is no dispatch
    in flight yet), so ``overlap_fraction`` is < 1 even at perfect
    steady-state overlap — and on short runs the fill chunk biases it badly
    low.  ``first_prep_s`` / ``first_wait_s`` isolate that chunk, and
    ``steady_overlap_fraction`` is the same ratio with it excluded — the
    number that actually answers "does the pipeline hide host work once
    running".  ``chunks`` counts chunks the consumer dequeued,
    ``chunks_staged`` chunks the staging side produced (equal after a full
    run; staged may lead consumed mid-run in threaded mode).
    """

    chunks: int = 0
    chunks_staged: int = 0
    segments: int = 0
    prep_s: float = 0.0
    wait_s: float = 0.0
    first_prep_s: float = 0.0
    first_wait_s: float = 0.0

    @property
    def overlap_fraction(self) -> float:
        if self.prep_s <= 0.0:
            return 0.0
        return min(1.0, max(0.0, 1.0 - self.wait_s / self.prep_s))

    @property
    def steady_overlap_fraction(self) -> float:
        """``overlap_fraction`` excluding the pipeline-fill chunk (0.0 when
        the run had no steady-state chunks to measure)."""
        prep = self.prep_s - self.first_prep_s
        wait = self.wait_s - self.first_wait_s
        if prep <= 0.0:
            return 0.0
        return min(1.0, max(0.0, 1.0 - wait / prep))


class _Failure:
    """Worker-thread exception, re-raised on the consumer side."""

    def __init__(self, exc: BaseException):
        self.exc = exc


_DONE = object()

# Process-global, refcounted guard around the GIL switch interval: while any
# threaded prefetcher is alive the interval is shortened once, and the saved
# value is restored only when the last one closes — overlapping prefetchers
# must not restore each other's setting mid-run or leave the shortened
# interval behind.
_fast_switch_lock = threading.Lock()
_fast_switch_depth = 0
_fast_switch_saved: float | None = None


def _acquire_fast_switch_interval() -> None:
    global _fast_switch_depth, _fast_switch_saved
    with _fast_switch_lock:
        if _fast_switch_depth == 0:
            _fast_switch_saved = sys.getswitchinterval()
            sys.setswitchinterval(min(_fast_switch_saved, 1e-3))
        _fast_switch_depth += 1


def _release_fast_switch_interval() -> None:
    global _fast_switch_depth, _fast_switch_saved
    with _fast_switch_lock:
        if _fast_switch_depth == 0:
            return
        _fast_switch_depth -= 1
        if _fast_switch_depth == 0 and _fast_switch_saved is not None:
            sys.setswitchinterval(_fast_switch_saved)
            _fast_switch_saved = None


def _shutdown_worker(stop: threading.Event, q: queue.Queue, thread) -> None:
    """Stop a threaded prefetcher's worker and restore the switch interval.

    Module-level so ``weakref.finalize`` can hold it without keeping the
    prefetcher alive: a threaded prefetcher that is abandoned un-iterated
    (e.g. its consumer raised before the loop) must not leave a polling
    daemon thread and a shortened GIL switch interval behind for the rest
    of the process.  (The worker itself holds no reference to the
    prefetcher either — see :func:`_worker_loop` — or the abandoned object
    could never be collected and this finalizer would never fire.)
    """
    stop.set()
    while True:  # unblock a worker stuck on a full queue
        try:
            q.get_nowait()
        except queue.Empty:
            break
    try:
        thread.join(timeout=5.0)
    finally:
        _release_fast_switch_interval()


def _worker_loop(gen, stats: PrefetchStats, q: queue.Queue, stop: threading.Event):
    """Threaded-mode staging loop (module-level: must not close over the
    prefetcher, only over its long-lived pieces)."""

    def put(item) -> bool:
        # blocking put that aborts promptly when the consumer closed
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    try:
        first = True
        while True:
            t0 = time.perf_counter()
            try:
                item = next(gen)
            except StopIteration:
                break
            dt = time.perf_counter() - t0
            stats.prep_s += dt
            if first:
                stats.first_prep_s += dt
                first = False
            if not put(item):
                return
        put(_DONE)
    except BaseException as exc:  # noqa: BLE001 — relayed to the consumer
        put(_Failure(exc))


def _staged_items(
    stats, schedule, rounds, chunk, next_batch, policy, pad_to_chunk, tracer, to_device
):
    """The staging stream both modes share (module-level: the generator's
    frame must not pin the prefetcher — see :func:`_worker_loop`).

    Telemetry: one ``stage`` span per chunk (batch draws + host stacking)
    and one ``h2d`` span per chunk (the device transfer), both on the
    logical ``prefetcher`` track — in threaded mode that is the worker
    thread's real timeline, in inline mode it is the staging work
    interleaved on the consumer, either way its own Perfetto row.  The
    policy's ``solve`` spans fire from inside ``relay_matrix``.
    ``to_device`` is :func:`_to_device` bound to the prefetcher's device and
    the consumer's stream, or the caller's ``place``.
    """
    for seg in schedule.segments(rounds):
        A = policy.relay_matrix(seg.state) if policy is not None else None
        stats.segments += 1
        for start in range(0, seg.n_rounds, chunk):
            window = min(chunk, seg.n_rounds - start)
            pad = chunk - window if pad_to_chunk else 0
            if tracer.enabled:
                with tracer.span(
                    "prefetch.stage",
                    cat="stage",
                    track="prefetcher",
                    epoch=seg.epoch_id,
                    rounds=window,
                ):
                    host = _stack_host([next_batch() for _ in range(window)], pad)
                with tracer.span(
                    "prefetch.h2d", cat="h2d", track="prefetcher", epoch=seg.epoch_id
                ):
                    staged = to_device(host)
            else:
                host = _stack_host([next_batch() for _ in range(window)], pad)
                staged = to_device(host)
            stats.chunks_staged += 1
            yield StagedChunk(
                segment=seg,
                A=A,
                batches=staged,
                start=start,
                n_rounds=window,
                last_in_segment=start + window >= seg.n_rounds,
            )


class SegmentPrefetcher:
    """Double-buffered staging of per-chunk work items, in one of two modes.

    Both modes walk ``schedule.segments(rounds)`` in order and, per segment,
    (1) resolve the relay matrix once via ``policy.relay_matrix`` (the
    adaptive OPT-α re-solve — the dominant host cost under fast-varying
    channels), then (2) split the segment into ``chunk``-round windows,
    drawing ``next_batch()`` once per round in round order, stacking the
    window (optionally zero-padded to ``chunk``) and transferring it to the
    device.  The staged stream (segments, relay matrices, warm-start chain,
    batch stream) follows the serial loop's exact order in either mode, so
    the training trajectory is bit-identical to inline execution.

    **Inline mode** (``threaded=False``, the default) stages on demand from
    the consuming thread: because CUDA kernel launches are asynchronous, the
    consumer enqueues chunk k and immediately resumes this iterator, which
    stages chunk k+1 *while the device executes chunk k* — software double
    buffering with no second thread, no GIL contention, no handoff latency.
    Overlap is measured directly: staging time during which the previous
    chunk was still in flight (``torch.cuda.Event.query`` on the event
    passed to :meth:`note_inflight`) was hidden; the rest is ``wait_s``.  On
    the CPU torch runs each op to its end before returning, so nothing is in
    flight and nothing is hidden.

    **Threaded mode** (``threaded=True``) runs staging on a worker thread
    feeding a bounded queue of ``depth`` items (the worker blocks when it is
    ``depth`` chunks ahead, bounding memory to ``depth + 1`` chunks).  This
    buys true host/host parallelism — worth it when staging is dominated by
    GIL-released native code and the backend is a real accelerator — at the
    price of GIL handoffs with the dispatch thread, which on few-core CPU
    hosts usually costs more than it hides.  The worker is the only thread
    touching schedule/policy/batches; the rounds (and every kernel launch,
    so ``kernels.relay_mix.LAUNCHES``) stay on the consumer thread.

    Host→device copies (both modes) go from pinned memory, asynchronously,
    on the stream that was current on the consumer thread when the
    prefetcher was made.  The worker enqueues its copy before it hands the
    chunk over, and the consumer enqueues the chunk's rounds after it takes
    it, so stream order alone puts every copy before its first use: no
    event, no ``record_stream`` (the tensors belong to the stream that uses
    them).  The price is that a copy cannot run beside the previous chunk's
    kernels on the device; a chunk's batches are a few ms of copy against
    hundreds of ms of rounds at the paper's model.

    Iterate to consume; call :meth:`close` (or exhaust the iterator) to shut
    down.  Staging exceptions re-raise on the consumer side in both modes.
    """

    def __init__(
        self,
        schedule,
        rounds: int,
        *,
        chunk: int,
        next_batch: Callable[[], Any],
        policy=None,
        depth: int = 2,
        pad_to_chunk: bool = False,
        threaded: bool = False,
        tracer=None,
        device=None,
        place: Callable[[Any], Any] | None = None,
    ):
        """``device`` is where staged batches go: the GPU unless the caller
        passes ``device="cpu"``.  ``place`` replaces the default transfer
        (each host-stacked chunk copied whole to ``device``) with the
        caller's placement of the chunk — the sharded engine keeps only its
        rank's clients of each chunk; ``device`` is then unused."""
        if chunk < 1:
            raise ValueError("chunk must be >= 1")
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self.stats = PrefetchStats()
        self.threaded = bool(threaded)
        self._inflight = None
        self._tracer = NULL_TRACER if tracer is None else tracer
        self._counters_folded = False
        if place is None:
            device = resolve_device(device)
            stream = torch.cuda.current_stream(device) if device.type == "cuda" else None
            place = functools.partial(_to_device, device=device, stream=stream)
        self._gen = _staged_items(
            self.stats,
            schedule,
            int(rounds),
            int(chunk),
            next_batch,
            policy,
            bool(pad_to_chunk),
            self._tracer,
            place,
        )
        self._thread = None
        self._finalizer = None
        if self.threaded:
            self._queue: queue.Queue = queue.Queue(maxsize=depth)
            self._stop = threading.Event()
            self._thread = threading.Thread(
                target=_worker_loop,
                args=(self._gen, self.stats, self._queue, self._stop),
                daemon=True,
            )
            self._thread.start()
            # While the worker is alive, shorten the interpreter's GIL
            # switch interval: staging runs long GIL-holding numpy/python
            # stretches, and at the default 5 ms the consumer thread can
            # stall that long before it gets to enqueue the next device
            # chunk.  1 ms bounds that dispatch latency; released by
            # _shutdown_worker via a process-global refcount (acquired only
            # after start() succeeded, so a failed __init__ cannot leak the
            # shortened interval; the finalizer covers a consumer that
            # abandons the prefetcher without closing it).
            _acquire_fast_switch_interval()
            self._finalizer = weakref.finalize(
                self, _shutdown_worker, self._stop, self._queue, self._thread
            )

    def note_inflight(self, handle) -> None:
        """Inline-mode overlap probe: the consumer passes a
        :class:`torch.cuda.Event` recorded after its latest chunk (None on
        the CPU); staging time that elapses while the event has not yet
        completed was hidden behind device execution."""
        self._inflight = handle

    # -------------------------------------------------- consumer thread side
    def __iter__(self):
        if self.threaded:
            try:
                while True:
                    t0 = time.perf_counter()
                    item = self._queue.get()
                    dt = time.perf_counter() - t0
                    self.stats.wait_s += dt
                    if self.stats.chunks == 0:
                        self.stats.first_wait_s += dt
                    if item is _DONE:
                        break
                    if isinstance(item, _Failure):
                        raise item.exc
                    self.stats.chunks += 1
                    yield item
            finally:
                self.close()
            return
        while True:
            t0 = time.perf_counter()
            try:
                item = next(self._gen)
            except StopIteration:
                break
            dt = time.perf_counter() - t0
            self.stats.prep_s += dt
            hidden = self._inflight is not None and not self._inflight.query()
            if not hidden:
                self.stats.wait_s += dt
            if self.stats.chunks == 0:
                # pipeline fill: the first chunk has nothing to hide behind,
                # so its prep/wait is excluded from steady_overlap_fraction
                self.stats.first_prep_s += dt
                if not hidden:
                    self.stats.first_wait_s += dt
            self.stats.chunks += 1
            yield item

    def close(self) -> None:
        """Stop the worker and release the queue (idempotent; no-op in
        inline mode).  Also runs via ``weakref.finalize`` if the prefetcher
        is garbage-collected without an explicit close.  When tracing, the
        final :class:`PrefetchStats` fold onto the tracer's counters here —
        once, whichever of close/exhaustion runs first."""
        if self._finalizer is not None:
            self._finalizer()  # runs _shutdown_worker at most once
            self._thread = None
        if self._tracer.enabled and not self._counters_folded:
            self._counters_folded = True
            self._tracer.count("prefetch.chunks", self.stats.chunks)
            self._tracer.count("prefetch.chunks_staged", self.stats.chunks_staged)
            self._tracer.count("prefetch.segments", self.stats.segments)
            self._tracer.count("prefetch.prep_s", self.stats.prep_s)
            self._tracer.count("prefetch.wait_s", self.stats.wait_s)


def _stack_host(batches: list, pad: int) -> Any:
    """Stack per-round batch pytrees along a new leading axis (zero-padding
    ``pad`` dead rounds when asked), entirely in numpy — the host half of
    staging, split from :func:`_to_device` so tracing can bill stacking as
    ``stage`` and the transfer as ``h2d`` without nesting the categories.
    Both halves run on the staging side (worker thread in threaded mode):
    the multi-MB memcpys happen in largely GIL-released numpy stretches."""

    def leaf(*xs):
        out = np.stack(xs)
        if pad:
            zeros = np.zeros((pad,) + out.shape[1:], out.dtype)
            out = np.concatenate([out, zeros])
        return out

    return tree_map(leaf, *batches)


def _to_device(host: Any, *, device: torch.device, stream=None) -> Any:
    """Move a host pytree of numpy arrays to ``device``, one tensor a leaf of
    the same dtype (an EdgeRelay's int32 indices stay int32).  To a GPU
    each leaf is copied into pinned memory and from there, with
    ``non_blocking=True``, on ``stream``: a copy from pageable memory would
    wait until the stream's in-flight chunk had finished, and stall staging
    for a full chunk's compute time.  A read-only leaf (the policies freeze
    theirs) is copied first, since torch does not wrap one."""

    def host_tensor(x):
        x = np.asarray(x)
        return torch.from_numpy(x if x.flags.writeable else x.copy())

    if device.type != "cuda":
        return tree_map(lambda x: host_tensor(x).to(device), host)
    with torch.cuda.stream(stream):
        return tree_map(
            lambda x: host_tensor(x).pin_memory().to(device, non_blocking=True),
            host,
        )


class StaleOptAlpha:
    """Solve OPT-α on the first channel only; every later round reuses that A
    projected onto the live topology (the channel-oblivious baseline)."""

    def __init__(
        self, *, sweeps: int = 40, tol: float = 1e-10, method: str = "bisect"
    ):
        self.sweeps = sweeps
        self.tol = tol
        self.method = method
        self._A: np.ndarray | None = None

    def relay_matrix(self, state: ChannelState) -> np.ndarray:
        if self._A is None:
            if state.active is not None and not state.active.all():
                self._A = opt_alpha.optimize_masked(
                    state.p,
                    state.adj,
                    state.active,
                    sweeps=self.sweeps,
                    tol=self.tol,
                    method=self.method,
                ).A
            else:
                self._A = opt_alpha.optimize(
                    state.p,
                    state.adj,
                    sweeps=self.sweeps,
                    tol=self.tol,
                    method=self.method,
                ).A
        return project_to_support(self._A, state.adj, state.active)
