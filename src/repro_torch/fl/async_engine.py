"""Asynchronous round engine: staleness-weighted aggregation of delayed
client arrivals.

The PyTorch counterpart of the JAX package's ``fl/async_engine.py``.  The
synchronous drivers (``run_rounds_loop`` and the epoch engines) assume every
client's round-r update is available at round r.  In production the uplink
is a queue: updates land after a sampled delay
(:mod:`repro_torch.channels.delay`), and the PS aggregates whatever has
*arrived* — the buffered-async norm, with FedDec (arXiv 2306.06715) as the
semi-decentralized precedent.  :class:`AsyncRoundEngine` models exactly that
while keeping every contract the synchronous stack established:

* **Per-round protocol order is unchanged.**  Each round draws the channel
  state, the policy's relay matrix, one batch and one τ (one
  ``sim.sample_tau`` from the generator) in the same order as
  ``run_rounds_loop``, and all n clients compute their local update from
  the *current* broadcast model.  Only the update's arrival at the PS is
  delayed.
* **Freshest-arrival buffer.**  The PS holds one slot per client: the most
  recent arrival's raveled delta row and its OPT-α coefficient (computed at
  the source round, against the source round's channel).  A newer arrival
  supersedes an older one; at aggregation time the K freshest eligible
  slots are selected (``buffer_k=0`` ⇒ all).
* **Staleness-discounted, renormalized weights.**  A slot whose update is
  s rounds old is discounted by ``decay**s`` and the weights renormalize to
  sum to one over the selected slots — so the aggregate stays a convex
  combination of per-source-round OPT-α unbiased increments, and at s=0 the
  weights are exactly the 1/n_active blind weight of the synchronous path.
* **delay=0 ⇒ bitwise-identical to the port's ``run_rounds_loop``**
  (params, metrics, generator state), under churn included — the discount
  is exactly 1.0 at s=0, the renormalizer reproduces
  ``aggregation.active_weight``'s float ops (``1.0 / x`` of the same
  integer-valued sum), the base coefficients are the same
  ``fused_coefficients`` call as the synchronous increment's, the metrics
  are ``FLSimulator.round_math``'s ops, and the buffered rows are the
  round's own delta rows unchanged.  Tested in
  ``tests/test_torch_async.py``; the bench harness re-asserts it as the
  mandatory ``async_check`` gate on every async scenario.

Strategy support: ``colrel_fused`` (the production path), ``fedavg_blind``
and ``no_dropout``.  ``colrel`` (unfused) is refused — its mix-then-reduce
association has no buffered form that stays bitwise at delay 0 — and
``fedavg_nonblind`` is refused because its per-round τ-count normalization
does not commute with the staleness renormalization.

The reduce goes through ``kernels.ops.reduce_flat`` with the synchronous
mapping: ``einsum`` reduces with the plain chain, and ``hopper``,
``hopper_fused`` and ``segment`` with the fused-aggregate CUDA kernel on the
card (one launch a round).

Like the loop driver, the engine reads the round's loss on the host once a
round (it must: arrival scheduling is host-side), so its rounds/sec sits
near the loop's — asynchrony is a *workload* axis, not a throughput one.
Nothing is compiled, so there is no ``trace_count``.  Buffers: the pending
map holds at most ``delays.max_delay`` in-flight (n, D) round buffers, each
its own tensor (the round's raveled deltas), plus the (n, D) held buffer,
which every merge replaces by a new tensor.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.channels.delay import DelayProcess, ZeroDelays
from repro_torch.core import relay as relay_lib
from repro_torch.kernels import ops as kernel_ops
from repro_torch.obs import NULL_TRACER
from repro_torch.utils import stacked_ravel, tree_map, tree_spec, tree_unravel

SUPPORTED_STRATEGIES = ("colrel_fused", "fedavg_blind", "no_dropout")


# --------------------------------------------------------------------------
# Pure staleness-weight math
# --------------------------------------------------------------------------


def staleness_discounts(staleness, *, decay: float) -> np.ndarray:
    """Per-slot discount ``decay**s`` as float32, with s=0 mapped to exactly
    1.0 (``where``, not ``power`` — pow(x, 0) is not guaranteed to return
    the literal 1.0 bit pattern on every backend, and the delay-0 bitwise
    contract needs the exact identity weight)."""
    s = np.asarray(staleness)
    d = np.float32(decay) ** s.astype(np.float32)
    return np.where(s == 0, np.float32(1.0), d).astype(np.float32)


def select_freshest(staleness, eligible, k: int) -> np.ndarray:
    """Boolean mask of the ≤k freshest eligible slots (smallest staleness,
    ties broken by client index — deterministic).  ``k=0`` selects every
    eligible slot."""
    stale = np.asarray(staleness)
    elig = np.asarray(eligible, bool)
    if k <= 0 or int(elig.sum()) <= k:
        return elig.copy()
    order = np.lexsort((np.arange(stale.shape[0]), stale))
    sel = np.zeros_like(elig)
    chosen = [j for j in order if elig[j]][:k]
    sel[chosen] = True
    return sel


def staleness_weights(m) -> torch.Tensor:
    """Renormalized weight vector from the discount-mask vector ``m``
    (discount × selected × active, zeros elsewhere): ``m / Σm`` computed
    reciprocal-then-multiply, with the all-zero vector mapping to zeros.
    The weights sum to one whenever any slot is selected.  At delay 0 the
    live entries of ``m`` are exactly 1.0, so Σm is the integer-valued
    active count and each live weight is bit-equal to the synchronous
    ``aggregation.active_weight`` 1/n_active (``where`` passes Σm through
    unchanged, exactly as ``clamp(Σ, min=1)`` does for Σ ≥ 1)."""
    m = torch.as_tensor(m, dtype=torch.float32)
    s = m.sum()
    return m * (1.0 / torch.where(s > 0, s, 1.0))


def async_coefficients(A, tau, m, *, n: int, active=None,
                       backend: str = "einsum") -> torch.Tensor:
    """The full async coefficient vector: staleness weights ⊙ the per-slot
    OPT-α base coefficients (``fused_coefficients`` under the same A/τ
    masking as :func:`repro_torch.core.aggregation.colrel_increment_flat`),
    on the device of ``m``.

    At ``m == active`` (all fresh, all selected) this equals the
    synchronous ``w · τᵀA`` coefficients bitwise; a zero entry of ``m``
    (departed or never-arrived client) forces an exactly-zero coefficient.
    """
    kernel_ops.validate_backend(backend)
    if backend == "segment" and not isinstance(A, relay_lib.EdgeRelay):
        raise ValueError("backend='segment' needs an EdgeRelay operand")
    m = torch.as_tensor(m, dtype=torch.float32)
    dev = m.device
    A = relay_lib.as_relay_operand(A, n=n, backend=backend, device=dev)
    tau = torch.as_tensor(tau, dtype=torch.float32, device=dev)
    if active is not None:
        a = torch.as_tensor(active, dtype=torch.float32, device=dev)
        A = relay_lib.mask_relay_matrix(A, a)
        tau = tau * a
    base = relay_lib.fused_coefficients(A, tau)
    return staleness_weights(m) * base


def async_increment_flat(A, tau, m, buf, *, n: int, active=None,
                         backend: str = "einsum") -> torch.Tensor:
    """Staleness-weighted ColRel increment over the (n, D) buffer → (D,),
    dispatched through the same backend mapping as the synchronous
    aggregation (einsum → the plain reduce; hopper, hopper_fused and
    segment → the fused-aggregate kernel)."""
    m = torch.as_tensor(m, dtype=torch.float32, device=buf.device)
    coeffs = async_coefficients(A, tau, m, n=n, active=active, backend=backend)
    reduce_backend = "einsum" if backend == "einsum" else "hopper_fused"
    return kernel_ops.reduce_flat(coeffs, buf, backend=reduce_backend)


# --------------------------------------------------------------------------
# The engine
# --------------------------------------------------------------------------


class AsyncRoundEngine:
    """Asynchronous per-round driver over an
    :class:`~repro_torch.fl.simulator.FLSimulator`.

    ``delays`` is a :class:`repro_torch.channels.delay.DelayProcess` (None ⇒
    :class:`ZeroDelays`, the synchronous reduction).  ``staleness_decay``
    is the per-round discount γ of a buffered update's weight;
    ``buffer_k`` caps aggregation to the K freshest eligible arrivals
    (0 ⇒ no cap).

    State (held buffer, pending arrivals, round index) persists across
    :meth:`run_schedule` calls when ``reset=False`` — a continuous trainer
    streams indefinitely in checkpoint-sized bursts through one engine.
    Memory: the pending map holds at most ``delays.max_delay`` in-flight
    (n, D) buffers plus the (n, D) held buffer.

    ``tracer`` (a :class:`repro_torch.obs.Tracer`) records one
    ``async.round`` span a round, an ``async.buffer`` instant with the
    buffer's depth, selection and maximum staleness, and the counters
    ``async.rounds``, ``async.arrivals``, ``async.selected`` and
    ``async.superseded``.
    """

    def __init__(self, sim, *, delays: DelayProcess | None = None,
                 staleness_decay: float = 0.8, buffer_k: int = 0, tracer=None):
        if sim.strategy not in SUPPORTED_STRATEGIES:
            raise ValueError(
                f"AsyncRoundEngine supports strategies {SUPPORTED_STRATEGIES}"
                f", got {sim.strategy!r} ('colrel' reassociates the reduce "
                "and 'fedavg_nonblind' renormalizes per round — neither "
                "composes with staleness weighting)"
            )
        if not (0.0 < staleness_decay <= 1.0):
            raise ValueError(f"staleness_decay must be in (0, 1], got "
                             f"{staleness_decay}")
        if buffer_k < 0:
            raise ValueError(f"buffer_k must be >= 0, got {buffer_k}")
        self.sim = sim
        self.delays = delays if delays is not None else ZeroDelays(sim.n)
        if self.delays.n != sim.n:
            raise ValueError(
                f"delay process is over n={self.delays.n} clients, "
                f"simulator over n={sim.n}"
            )
        self.staleness_decay = staleness_decay
        self.buffer_k = buffer_k
        self.tracer = NULL_TRACER if tracer is None else tracer
        self._reduce_backend = (
            "einsum" if sim.relay_backend == "einsum" else "hopper_fused"
        )
        self._spec = None
        self.reset()

    # ---------------------------------------------------------- host state

    def reset(self) -> None:
        """Clear the arrival buffers and rewind the delay stream (cold
        start; the bench harness replays cold/warm passes this way)."""
        n = self.sim.n
        self.delays.reset()
        self._round_index = 0
        self._pending: dict[int, list] = {}
        self._held_round = np.full(n, -1, np.int64)
        self._held_buf = None
        self._held_coeffs = None

    # --------------------------------------------------------- device math

    def _compute(self, params, batch, tau, A, lr, active):
        """Round-r client compute: local updates (all n slots, fixed
        shapes), the raveled delta buffer, the per-slot base OPT-α
        coefficients against round r's channel, and the round metrics,
        op for op as ``FLSimulator.round_math`` computes them."""
        sim = self.sim
        deltas, losses = sim._client_updates(params, batch, lr)
        buf, _ = stacked_ravel(deltas)
        tau_m = tau
        if sim.strategy == "colrel_fused":
            backend = sim.relay_backend
            if backend == "segment" and not isinstance(A, relay_lib.EdgeRelay):
                raise ValueError(
                    "relay_backend='segment' needs an EdgeRelay operand"
                )
            A = relay_lib.as_relay_operand(A, n=sim.n, backend=backend,
                                           device=buf.device)
            if active is not None:
                A = relay_lib.mask_relay_matrix(A, active)
                tau_m = tau_m * active
            coeffs = relay_lib.fused_coefficients(A, tau_m)
        elif sim.strategy == "fedavg_blind":
            if active is not None:
                tau_m = tau_m * active
            coeffs = tau_m
        else:  # no_dropout (τ forced to ones by sample_tau)
            coeffs = torch.ones_like(tau_m) if active is None else active
        # round metrics, op for op as in FLSimulator.round_math: they
        # describe round r's local work, not the buffered arrivals
        per_client_dn = (buf * buf).sum(dim=1)
        if active is None:
            mean_loss, dn = losses.mean(), per_client_dn.mean()
            tau_out = tau
        else:
            denom = torch.clamp(active.sum(), min=1.0)
            mean_loss = (losses * active).sum() / denom
            dn = (per_client_dn * active).sum() / denom
            tau_out = tau * active
        metrics = {"loss": mean_loss, "tau": tau_out, "delta_norm": torch.sqrt(dn)}
        return buf, coeffs, metrics

    @staticmethod
    def _merge(mask, src_buf, src_coeffs, held_buf, held_coeffs):
        """Accept the masked rows of an arriving source round into the held
        buffer (``where`` row select: accepted rows pass through bit-exact,
        into new tensors — the source round's buffer is never written)."""
        keep = mask > 0
        return (
            torch.where(keep[:, None], src_buf, held_buf),
            torch.where(keep, src_coeffs, held_coeffs),
        )

    def _step(self, params, server_state, coeffs, held_buf):
        """Reduce the held buffer under ``coeffs`` and take the server step."""
        flat_inc = kernel_ops.reduce_flat(
            coeffs, held_buf, backend=self._reduce_backend
        )
        increment = tree_unravel(self._spec, flat_inc, cast=False)
        return self.sim.server_opt.apply(params, server_state, increment)

    def _agg(self, params, server_state, m, held_coeffs, held_buf):
        """Staleness-weighted aggregate + server step: the weights
        renormalize over the discount-mask vector m (see
        :func:`staleness_weights`, inlined)."""
        s = m.sum()
        w = 1.0 / torch.where(s > 0, s, 1.0)
        return self._step(params, server_state, (m * w) * held_coeffs, held_buf)

    def _agg_full(self, params, server_state, held_coeffs, held_buf):
        """The full-membership synchronous fast path (every slot arrived
        this round, no churn mask, nothing truncated): the weight is the
        *python* 1/n — the same constant the synchronous active=None path
        multiplies by, keeping delay=0 bitwise there too."""
        w = 1.0 / self.sim.n
        return self._step(params, server_state, w * held_coeffs, held_buf)

    # ------------------------------------------------------- host plumbing

    def _schedule_arrivals(self, t: int, d: np.ndarray, buf, coeffs) -> None:
        for delay in np.unique(d):
            idx = np.nonzero(d == delay)[0]
            self._pending.setdefault(t + int(delay), []).append(
                (idx, buf, coeffs, t)
            )

    def _deliver(self, t: int) -> tuple[int, int]:
        """Merge every arrival due at round t into the held buffer; newest
        source round wins.  Returns (accepted, superseded)."""
        entries = self._pending.pop(t, [])
        entries.sort(key=lambda e: e[3])  # oldest source first
        accepted = superseded = 0
        for idx, buf, coeffs, src in entries:
            take = idx[self._held_round[idx] < src]
            superseded += idx.size - take.size
            if take.size == 0:
                continue
            mask = np.zeros(self.sim.n, np.float32)
            mask[take] = 1.0
            self._held_buf, self._held_coeffs = self._merge(
                torch.from_numpy(mask).to(buf.device), buf, coeffs,
                self._held_buf, self._held_coeffs,
            )
            self._held_round[take] = src
            accepted += int(take.size)
        return accepted, superseded

    def _staleness_mask(self, t: int, active):
        """Host-side per-round weighting inputs: the discount-mask vector m
        (discount × selected × active, zero for never-arrived slots), the
        buffer depth, and whether the round is exactly synchronous (the
        static-weight fast path)."""
        n = self.sim.n
        arrived = self._held_round >= 0
        stale = t - self._held_round
        act = (
            np.ones(n, bool) if active is None
            else np.asarray(active).astype(bool)
        )
        elig = arrived & act
        sel = select_freshest(stale, elig, self.buffer_k)
        disc = staleness_discounts(stale, decay=self.staleness_decay)
        m = np.where(sel, disc, np.float32(0.0)).astype(np.float32)
        full_sync = bool(
            active is None and elig.all() and (stale == 0).all() and sel.all()
        )
        stats = {
            "depth": int(elig.sum()),
            "selected": int(sel.sum()),
            "max_staleness": int(stale[sel].max()) if sel.any() else 0,
        }
        return m, full_sync, stats

    # ------------------------------------------------------------- driving

    def run_schedule(self, generator: torch.Generator, params, server_state, *,
                     schedule, rounds, next_batch, lr, policy=None,
                     on_round=None, reset: bool = True):
        """Drive a :class:`ChannelSchedule` for ``rounds`` asynchronous
        rounds.  Same signature and return contract as ``run_rounds_loop``
        (``(params, server_state, metrics, generator)``; ``on_round(round,
        params)`` per round); τ is one ``sim.sample_tau`` from
        ``generator`` a round, in round order, as the loop draws it.
        ``reset=False`` continues the arrival stream from the previous call
        (continuous-training bursts)."""
        sim = self.sim
        dev = sim.device
        if reset:
            self.reset()
        if self._spec is None:
            self._spec = tree_spec(params)
        if self._held_buf is None:
            n, D = sim.n, self._spec.total
            self._held_buf = torch.zeros((n, D), dtype=torch.float32, device=dev)
            self._held_coeffs = torch.zeros((n,), dtype=torch.float32, device=dev)
        all_metrics = []
        for state in schedule.rounds(rounds):
            t = self._round_index
            A = policy.relay_matrix(state) if policy is not None else None
            A_round = (
                sim.A if A is None
                else relay_lib.as_relay_operand(
                    A, n=sim.n, backend=sim.relay_backend, device=dev
                )
            )
            batch = sim._to_device(next_batch())
            tau = sim.sample_tau(generator, state.p)
            active = (
                None if state.active is None
                else torch.as_tensor(state.active, dtype=torch.float32, device=dev)
            )
            if self.tracer.enabled:
                with self.tracer.span("async.round", cat="dispatch", round=t):
                    out, stats = self._round_step(
                        t, state, params, server_state, batch, tau,
                        A_round, lr, active,
                    )
                    params, server_state, metrics = out
                self.tracer.instant(
                    "async.buffer", cat="stage", round=t, **stats
                )
                self.tracer.count("async.rounds")
                self.tracer.count("async.arrivals", stats["arrivals"])
                self.tracer.count("async.selected", stats["selected"])
                if stats["superseded"]:
                    self.tracer.count("async.superseded", stats["superseded"])
            else:
                out, stats = self._round_step(
                    t, state, params, server_state, batch, tau,
                    A_round, lr, active,
                )
                params, server_state, metrics = out
            float(metrics["loss"])  # per-round host sync, like the loop
            all_metrics.append(metrics)
            if on_round is not None:
                on_round(state.round, params)
            self._round_index += 1
        metrics = tree_map(lambda *ms: torch.stack(ms), *all_metrics)
        return params, server_state, metrics, generator

    def _round_step(self, t, state, params, server_state, batch, tau,
                    A_round, lr, active):
        """One asynchronous round on given τ and relay operand: compute,
        schedule this round's arrivals, deliver the ones due now, then
        aggregate.  ``active`` is the round's churn mask as an f32 tensor
        (``state.active`` its host copy)."""
        dev = self.sim.device
        tau = torch.as_tensor(tau, dtype=torch.float32, device=dev)
        buf, coeffs, metrics = self._compute(
            params, batch, tau, A_round, lr, active
        )
        d = self.delays.sample()
        self._schedule_arrivals(t, d, buf, coeffs)
        arrivals, superseded = self._deliver(t)
        m, full_sync, stats = self._staleness_mask(t, state.active)
        stats["arrivals"] = arrivals
        stats["superseded"] = superseded
        if full_sync:
            params, server_state = self._agg_full(
                params, server_state, self._held_coeffs, self._held_buf
            )
        else:
            params, server_state = self._agg(
                params, server_state, torch.from_numpy(m).to(dev),
                self._held_coeffs, self._held_buf,
            )
        return (params, server_state, metrics), stats
