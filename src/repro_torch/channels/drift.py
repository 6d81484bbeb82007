"""Drift processes for the uplink success probabilities p(r).

The paper estimates p from pilots once; these processes model the estimate
going stale: either the environment jumps between quasi-static states
(piecewise-constant, e.g. blockage appearing/clearing) or it wanders slowly
(reflected random walk, e.g. pathloss drift under mobility).  All emitted
vectors stay inside [low, high] ⊂ [0, 1].
"""
from __future__ import annotations

import numpy as np


def _check_bounds(p0, low, high):
    p0 = np.asarray(p0, dtype=np.float64).copy()
    if p0.ndim != 1:
        raise ValueError("p0 must be a vector")
    if not (0.0 <= low < high <= 1.0):
        raise ValueError("need 0 <= low < high <= 1")
    return np.clip(p0, low, high), float(low), float(high)


class StaticP:
    """Degenerate drift: p(r) = p0 forever (static-channel composition)."""

    def __init__(self, p0):
        self.p = np.asarray(p0, dtype=np.float64).copy()

    def value(self) -> np.ndarray:
        return self.p

    def step(self) -> np.ndarray:
        return self.p


class PiecewiseConstantDrift:
    """Hold p for ``hold`` rounds, then resample uniformly in [low, high]."""

    def __init__(
        self, p0, *, hold: int, low: float = 0.05, high: float = 0.95, seed: int = 0
    ):
        if hold < 1:
            raise ValueError("hold must be >= 1")
        self.p, self.low, self.high = _check_bounds(p0, low, high)
        self.hold = int(hold)
        self._rng = np.random.default_rng(seed)
        self._age = 0  # rounds the current block has been held

    def value(self) -> np.ndarray:
        return self.p

    def step(self) -> np.ndarray:
        self._age += 1
        if self._age >= self.hold:
            self.p = self._rng.uniform(self.low, self.high, size=self.p.shape)
            self._age = 0
        return self.p


def _reflect(x: np.ndarray, low: float, high: float) -> np.ndarray:
    """Fold x into [low, high] by mirror reflection at both walls."""
    width = high - low
    y = np.mod(x - low, 2.0 * width)
    y = np.where(y > width, 2.0 * width - y, y)
    return low + y


class RandomWalkDrift:
    """p(r+1) = reflect(p(r) + N(0, σ²)) — slow per-client drift."""

    def __init__(
        self, p0, *, sigma: float, low: float = 0.05, high: float = 0.95, seed: int = 0
    ):
        if sigma < 0:
            raise ValueError("sigma must be nonnegative")
        self.p, self.low, self.high = _check_bounds(p0, low, high)
        self.sigma = float(sigma)
        self._rng = np.random.default_rng(seed)

    def value(self) -> np.ndarray:
        return self.p

    def step(self) -> np.ndarray:
        self.p = _reflect(
            self.p + self._rng.normal(0.0, self.sigma, size=self.p.shape),
            self.low,
            self.high,
        )
        return self.p
