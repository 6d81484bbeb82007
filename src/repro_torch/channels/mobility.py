"""Random-waypoint mobility over a 2-D geometric graph.

Clients move in the square [0, area]² toward independently drawn waypoints at
a fixed per-round speed; whenever a client reaches its waypoint it draws a new
one uniformly.  The D2D graph at any round is the unit-disk (geometric) graph:
clients within ``radius`` of each other are neighbors.  Adjacencies are
emitted through ``topology._validate`` so the symmetric / zero-diagonal
invariants of the ColRel algebra hold by construction.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import topology


def geometric_adjacency(positions: np.ndarray, radius: float) -> np.ndarray:
    """Unit-disk graph of ``positions`` (n, 2): edge iff pairwise dist ≤ radius."""
    pos = np.asarray(positions, dtype=np.float64)
    if pos.ndim != 2 or pos.shape[1] != 2:
        raise ValueError(f"positions must be (n, 2), got {pos.shape}")
    diff = pos[:, None, :] - pos[None, :, :]
    d2 = np.sum(diff * diff, axis=-1)
    adj = d2 <= float(radius) ** 2
    np.fill_diagonal(adj, False)
    return topology._validate(adj)


class RandomWaypointMobility:
    """n clients on random-waypoint trajectories; ``step()`` advances one
    round of motion and returns the new geometric adjacency."""

    def __init__(
        self,
        n: int,
        *,
        radius: float,
        speed: float = 0.05,
        area: float = 1.0,
        seed: int = 0,
    ):
        if radius <= 0 or speed < 0 or area <= 0:
            raise ValueError("radius/area must be positive, speed nonnegative")
        self.n = int(n)
        self.radius = float(radius)
        self.speed = float(speed)
        self.area = float(area)
        self._rng = np.random.default_rng(seed)
        self.positions = self._rng.random((self.n, 2)) * self.area
        self._waypoints = self._rng.random((self.n, 2)) * self.area

    def adjacency(self) -> np.ndarray:
        return geometric_adjacency(self.positions, self.radius)

    def step(self) -> np.ndarray:
        to_wp = self._waypoints - self.positions
        dist = np.linalg.norm(to_wp, axis=1)
        arrived = dist <= self.speed
        moving = ~arrived & (dist > 0)
        self.positions[arrived] = self._waypoints[arrived]
        self.positions[moving] += self.speed * to_wp[moving] / dist[moving, None]
        n_new = int(arrived.sum())
        if n_new:
            self._waypoints[arrived] = self._rng.random((n_new, 2)) * self.area
        return self.adjacency()
