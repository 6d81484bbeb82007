"""Time-varying channel subsystem: what the network does between rounds.

The PyTorch counterpart of the JAX package's ``channels``.  Everything in
this package is **host-side numpy**, kept line for line with the JAX
package, so the same seeds emit the same channel stream; the round only
ever sees the resulting ``(A, p, τ, active)`` values as per-round inputs.
The subsystem is four layers, consumed in order every round:

1. **Processes** — stateful generators advancing one aspect of the channel:

   * link state (`link_state`): Markov / Gilbert–Elliott per-edge fading on a
     base D2D graph; (`mobility`): random-waypoint trajectories with
     radio-range geometric adjacency.
   * uplink drift (`drift`): the p-vector going stale — piecewise-constant
     jumps (blockage) or a reflected random walk (pathloss drift).
   * correlated fading (`correlated`): one latent per-node log-shadowing
     field (:class:`ShadowingField`: AR(1) in time, Gaussian-process over
     node positions in space) drives node blockage on the D2D graph
     (:class:`ShadowedLinkProcess` — edges sharing a blocked node fail
     together) and, optionally, the uplink marginals
     (:class:`CoupledUplinkDrift` — p_i co-moves with i's local D2D state).
     :class:`CorrelatedChannel` is the one-call schedule.
   * membership (`churn`): clients joining/leaving over a *padded* client
     dimension ``n_max`` — per-client Markov on/off chains
     (:class:`MarkovChurn`), deterministic shift rotation
     (:class:`RotatingCohorts`), or a fixed mask
     (:class:`StaticMembership`).
   * cohort sampling (`sampling`): :class:`CohortSampler`, a membership
     process emitting ``membership ∧ sampled`` — per-round client cohorts
     (uniform / fixed-k / expander-stride draws), optionally wrapping any
     of the processes above as the eligibility base.  The n ≫ 10³ scale
     regime: per-round cost follows the cohort and its live edges.
   * arrival delays (`delay`): :class:`DelayProcess` streams — Poisson
     (:class:`PoissonDelays`), geometric (:class:`GeometricDelays`) or the
     synchronous :class:`ZeroDelays` — deciding *when* each client's
     computed update reaches the PS.  Consumed by the asynchronous engine
     (:class:`repro_torch.fl.async_engine.AsyncRoundEngine`), not by the
     schedules: delays compose on top of churn/sampling rather than
     replacing them.

2. **Schedules** (`schedule`, `churn`) — compose processes into one stream of
   :class:`ChannelState` per federated round: the realized adjacency, the
   uplink marginals p, the churn mask ``active`` (``None`` for the fixed-
   membership schedules) and an ``epoch_id`` that increments exactly when the
   channel *value* ``(adj, p, active)`` changes.  :class:`StaticChannel` is
   the seed setting, :class:`TimeVaryingChannel` composes fading × drift,
   :class:`ChurnSchedule` additionally streams membership.
   ``ChannelSchedule.segments()`` regroups the stream into maximal
   constant-channel :class:`ChannelSegment` runs — the unit of the epoch
   engines (:class:`repro_torch.fl.engine.EpochScanEngine`).

3. **Scheduler policies** (`scheduler`) — turn a state stream into per-round
   relay matrices.  :class:`AdaptiveOptAlpha` re-solves OPT-α only on epoch
   changes: an LRU cache keyed on the channel bytes (churn mask included)
   plus Gauss–Seidel warm starts from the previous optimum; under churn it
   solves the masked problem, so departed clients carry exactly zero weight.
   :class:`SparseOptAlpha` is the same policy on the neighborhood-blocked
   solver: it emits sparse :class:`~repro_torch.core.relay.EdgeRelay`
   operands for ``relay_backend="segment"`` and keeps solves, cache entries
   and relay cost O(edges).  :class:`StaleOptAlpha` is the channel-oblivious ablation (round-0 A
   forever, projected onto the live topology and membership).

4. **Prefetching** (`scheduler`) — the host half of the pipelined engine.
   :class:`SegmentPrefetcher` walks ``segments()``, resolves the relay
   matrix once per segment and stages per-chunk batch stacks on the device
   (:class:`StagedChunk` items), inline behind the device's in-flight chunk
   or on a worker thread; :class:`PrefetchStats` reports the measured
   host/device overlap.

Lifecycle per round::

    state = schedule.next_round()            # (adj, p, active, epoch_id)
    A     = policy.relay_matrix(state)       # cached within an epoch
    sim.run_round(generator, ..., A=A, p=state.p, active=state.active)
"""
from repro_torch.channels.churn import (
    ChurnSchedule,
    MarkovChurn,
    RotatingCohorts,
    StaticMembership,
)
from repro_torch.channels.correlated import (
    CorrelatedChannel,
    CoupledUplinkDrift,
    ShadowedLinkProcess,
    ShadowingField,
    circle_positions,
    spatial_covariance,
)
from repro_torch.channels.delay import (
    DelayProcess,
    GeometricDelays,
    PoissonDelays,
    ZeroDelays,
    make_delays,
)
from repro_torch.channels.drift import (
    PiecewiseConstantDrift,
    RandomWalkDrift,
    StaticP,
)
from repro_torch.channels.link_state import MarkovLinkProcess, gilbert_elliott
from repro_torch.channels.mobility import RandomWaypointMobility, geometric_adjacency
from repro_torch.channels.sampling import CohortSampler
from repro_torch.channels.schedule import (
    ChannelSchedule,
    ChannelSegment,
    ChannelState,
    StaticChannel,
    TimeVaryingChannel,
)
from repro_torch.channels.scheduler import (
    AdaptiveOptAlpha,
    PrefetchStats,
    SchedulerStats,
    SegmentPrefetcher,
    SparseOptAlpha,
    StagedChunk,
    StaleOptAlpha,
    project_to_support,
)

__all__ = [
    "AdaptiveOptAlpha",
    "ChannelSchedule",
    "ChannelSegment",
    "ChannelState",
    "ChurnSchedule",
    "CohortSampler",
    "CorrelatedChannel",
    "CoupledUplinkDrift",
    "DelayProcess",
    "GeometricDelays",
    "MarkovChurn",
    "MarkovLinkProcess",
    "PiecewiseConstantDrift",
    "PoissonDelays",
    "PrefetchStats",
    "RandomWalkDrift",
    "RandomWaypointMobility",
    "RotatingCohorts",
    "SchedulerStats",
    "SegmentPrefetcher",
    "ShadowedLinkProcess",
    "ShadowingField",
    "SparseOptAlpha",
    "StagedChunk",
    "StaleOptAlpha",
    "StaticChannel",
    "StaticMembership",
    "StaticP",
    "TimeVaryingChannel",
    "ZeroDelays",
    "circle_positions",
    "geometric_adjacency",
    "gilbert_elliott",
    "make_delays",
    "project_to_support",
    "spatial_covariance",
]
