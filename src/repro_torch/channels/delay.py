"""Arrival-delay processes: when each client's round-r update reaches the PS.

The asynchronous engine (:class:`repro_torch.fl.async_engine.AsyncRoundEngine`)
relaxes the lockstep round: client j's update from round r arrives at round
``r + d`` where ``d`` is drawn per (round, client) from one of the processes
below.  Like every other channel process, delays are **host-side numpy** —
deterministic streams from ``np.random.default_rng(seed)``, advanced exactly
once per round in round order, so a run (and its resume) replays the same
arrival pattern bit-for-bit.  The sampled delay only schedules *when* the
already-computed update is merged into the PS buffer; it never enters the
round's device math.

Delays compose freely with churn and cohort sampling
(:class:`~repro_torch.channels.churn.ChurnSchedule` /
:class:`~repro_torch.channels.sampling.CohortSampler`): the schedule decides who
*computes* and who is *eligible at aggregation time*; the delay process
decides when each computed update lands.  A client that departs before its
update arrives contributes exactly zero (the engine gates eligibility on the
aggregation round's active mask).

``max_delay`` clips every draw: it bounds the engine's pending-arrival
buffer (at most ``max_delay`` in-flight rounds are held) and guarantees every
update eventually lands or is superseded.

The PyTorch counterpart of the JAX package's ``channels/delay.py``, host
numpy line for line: the same seeds give the same delay streams.
"""
from __future__ import annotations

import numpy as np


class DelayProcess:
    """Base class: a deterministic per-round stream of (n,) integer delays.

    Subclasses implement ``_draw(rng) -> (n,) ints``; ``sample()`` clips to
    ``[0, max_delay]`` and advances the stream.  ``reset()`` rewinds to the
    seed state — the bench harness replays cold/warm passes through the same
    engine, so the arrival pattern must be reproducible on demand.
    """

    def __init__(self, n: int, *, max_delay: int = 8, seed: int = 0):
        if n < 1:
            raise ValueError(f"need n >= 1 clients, got {n}")
        if max_delay < 0:
            raise ValueError(f"max_delay must be >= 0, got {max_delay}")
        self.n = n
        self.max_delay = max_delay
        self.seed = seed
        self.reset()

    def reset(self) -> None:
        self._rng = np.random.default_rng(self.seed)
        self.round = 0

    def sample(self) -> np.ndarray:
        """One round's (n,) delays, clipped to ``[0, max_delay]``."""
        d = np.clip(self._draw(self._rng), 0, self.max_delay)
        self.round += 1
        return d.astype(np.int64)

    def _draw(self, rng: np.random.Generator) -> np.ndarray:
        raise NotImplementedError


class ZeroDelays(DelayProcess):
    """Every update arrives in its own round — the synchronous reduction.

    This is the delay process under which the async engine is bitwise-
    identical to ``run_rounds_loop`` (tested), and the control arm of the
    time-to-accuracy comparison.
    """

    def __init__(self, n: int, *, seed: int = 0):
        super().__init__(n, max_delay=0, seed=seed)

    def _draw(self, rng):
        return np.zeros(self.n, np.int64)


class PoissonDelays(DelayProcess):
    """I.i.d. Poisson(rate) delays per (round, client) — the classic arrival
    model for stragglers: most updates land within a round or two, a thin
    tail arrives late.  ``rate`` is the mean delay in rounds."""

    def __init__(self, n: int, *, rate: float = 1.0, max_delay: int = 8,
                 seed: int = 0):
        if rate < 0:
            raise ValueError(f"rate must be >= 0, got {rate}")
        self.rate = rate
        super().__init__(n, max_delay=max_delay, seed=seed)

    def _draw(self, rng):
        return rng.poisson(self.rate, self.n)


class GeometricDelays(DelayProcess):
    """I.i.d. geometric delays on support {0, 1, 2, ...} with mean ``mean``
    rounds — a heavier tail than Poisson at the same mean (memoryless
    per-round "did it land yet" retries)."""

    def __init__(self, n: int, *, mean: float = 1.0, max_delay: int = 8,
                 seed: int = 0):
        if mean < 0:
            raise ValueError(f"mean must be >= 0, got {mean}")
        self.mean = mean
        super().__init__(n, max_delay=max_delay, seed=seed)

    def _draw(self, rng):
        if self.mean == 0:
            return np.zeros(self.n, np.int64)
        # numpy's geometric is on {1, 2, ...}: shift to include 0 so that
        # mean-0 limits to the synchronous setting
        p = 1.0 / (1.0 + self.mean)
        return rng.geometric(p, self.n) - 1


def make_delays(kind: str, n: int, *, rate: float = 1.0, max_delay: int = 8,
                seed: int = 0) -> DelayProcess:
    """Factory used by the bench registry: ``kind`` ∈ none|poisson|geometric
    (``rate`` is the mean delay in rounds for both distributions)."""
    if kind == "none":
        return ZeroDelays(n, seed=seed)
    if kind == "poisson":
        return PoissonDelays(n, rate=rate, max_delay=max_delay, seed=seed)
    if kind == "geometric":
        return GeometricDelays(n, mean=rate, max_delay=max_delay, seed=seed)
    raise ValueError(f"unknown delay process: {kind!r}")
