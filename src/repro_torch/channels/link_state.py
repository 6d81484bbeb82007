"""Markov on/off (Gilbert–Elliott) processes for the D2D links.

Each undirected edge of a *base* topology carries an independent two-state
Markov chain: state 1 = link up, state 0 = link down (deep fade).  The chain
is parameterized by the transition probabilities

    q_ud = P[up → down]      q_du = P[down → up]

whose stationary up-probability is π = q_du / (q_ud + q_du).  Edges outside
the base topology never exist — the base graph is the radio-range envelope,
the chain models fading within it.  Every emitted adjacency is symmetric with
a zero diagonal (states live on the upper triangle and are mirrored).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import topology


class MarkovLinkProcess:
    """Independent Gilbert–Elliott chains on the edges of ``base_adj``."""

    def __init__(
        self,
        base_adj: np.ndarray,
        *,
        p_up_to_down: float,
        p_down_to_up: float,
        init: str = "stationary",
        seed: int = 0,
    ):
        base = topology._validate(np.asarray(base_adj, dtype=bool).copy())
        if not (0.0 <= p_up_to_down <= 1.0 and 0.0 <= p_down_to_up <= 1.0):
            raise ValueError("transition probabilities must lie in [0, 1]")
        if p_up_to_down + p_down_to_up == 0.0:
            raise ValueError(
                "q_ud = q_du = 0 freezes every link; use a StaticChannel instead"
            )
        self.base = base
        self.n = base.shape[0]
        self.q_ud = float(p_up_to_down)
        self.q_du = float(p_down_to_up)
        self._edges = np.argwhere(np.triu(base, 1))  # (E, 2) upper-tri edges
        self._rng = np.random.default_rng(seed)
        if init == "stationary":
            self._up = self._rng.random(len(self._edges)) < self.stationary_up_prob
        elif init == "up":
            self._up = np.ones(len(self._edges), dtype=bool)
        elif init == "down":
            self._up = np.zeros(len(self._edges), dtype=bool)
        else:
            raise ValueError(f"unknown init {init!r}")

    @property
    def stationary_up_prob(self) -> float:
        """π = q_du / (q_ud + q_du) of the per-edge chain."""
        return self.q_du / (self.q_ud + self.q_du)

    def transition_matrix(self) -> np.ndarray:
        """Row-stochastic P over states (down, up): P[s, s'] = P[s → s']."""
        return np.array(
            [[1.0 - self.q_du, self.q_du], [self.q_ud, 1.0 - self.q_ud]],
            dtype=np.float64,
        )

    def adjacency(self) -> np.ndarray:
        """Current realized D2D graph (symmetric, zero diagonal)."""
        adj = np.zeros((self.n, self.n), dtype=bool)
        up = self._edges[self._up]
        adj[up[:, 0], up[:, 1]] = True
        adj = adj | adj.T
        return topology._validate(adj)

    def step(self) -> np.ndarray:
        """Advance every edge chain one round; returns the new adjacency."""
        u = self._rng.random(len(self._edges))
        flip_down = self._up & (u < self.q_ud)
        flip_up = (~self._up) & (u < self.q_du)
        self._up = (self._up & ~flip_down) | flip_up
        return self.adjacency()


def gilbert_elliott(
    base_adj: np.ndarray,
    *,
    stay_up: float,
    stay_down: float,
    init: str = "stationary",
    seed: int = 0,
) -> MarkovLinkProcess:
    """Gilbert–Elliott parameterization by self-transition (burstiness)
    probabilities: stay_up = P[up → up], stay_down = P[down → down]."""
    return MarkovLinkProcess(
        base_adj,
        p_up_to_down=1.0 - stay_up,
        p_down_to_up=1.0 - stay_down,
        init=init,
        seed=seed,
    )
