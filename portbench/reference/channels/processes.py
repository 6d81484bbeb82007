"""Frozen copies of the JAX package's numpy channel processes at commit
c3a27a4: ``src/repro/channels/link_state.py::MarkovLinkProcess`` (started
from its stationary law) and ``src/repro/channels/drift.py::
PiecewiseConstantDrift``, the same draws from the same seeds."""
from __future__ import annotations

import numpy as np


class MarkovLinks:
    """Each base edge flips down with ``q_ud`` and up with ``q_du`` a step."""

    def __init__(self, base: np.ndarray, q_ud: float, q_du: float, seed: int):
        self.n = base.shape[0]
        self.q_ud, self.q_du = float(q_ud), float(q_du)
        self.edges = np.argwhere(np.triu(base, 1))
        self.rng = np.random.default_rng(seed)
        self.up = self.rng.random(len(self.edges)) < self.q_du / (self.q_ud + self.q_du)

    def adjacency(self) -> np.ndarray:
        adj = np.zeros((self.n, self.n), dtype=bool)
        up = self.edges[self.up]
        adj[up[:, 0], up[:, 1]] = True
        return adj | adj.T

    def step(self) -> np.ndarray:
        u = self.rng.random(len(self.edges))
        flip_down = self.up & (u < self.q_ud)
        flip_up = (~self.up) & (u < self.q_du)
        self.up = (self.up & ~flip_down) | flip_up
        return self.adjacency()


class PiecewiseConstant:
    """p held ``hold`` steps, then redrawn uniform in [low, high]."""

    def __init__(self, p0, hold: int, low: float, high: float, seed: int):
        self.p = np.clip(np.asarray(p0, dtype=np.float64), low, high)
        self.hold, self.low, self.high = int(hold), float(low), float(high)
        self.rng = np.random.default_rng(seed)
        self.age = 0

    def step(self) -> None:
        self.age += 1
        if self.age >= self.hold:
            self.p = self.rng.uniform(self.low, self.high, size=self.p.shape)
            self.age = 0
