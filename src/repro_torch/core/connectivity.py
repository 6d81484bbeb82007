"""Intermittent client→PS connectivity model (paper §II-B).

Connectivity of client i at round r is τ_i(r) ~ Bern(p_i), i.i.d. across
rounds.  The downlink (PS → clients) is assumed reliable, and no client or
the PS observes the realized τ before transmitting — only the marginals p_i
are known.

Draws come from an explicit :class:`torch.Generator` and land on the
generator's device.  They are not JAX's threefry draws: the same seed gives
other τ than the JAX package, so cross-package tests hand τ over as arrays.
"""
from __future__ import annotations

import numpy as np
import torch


class ConnectivityModel:
    """Bernoulli uplink model with per-client success probabilities."""

    def __init__(self, p):
        p = np.asarray(p, dtype=np.float32)
        if p.ndim != 1:
            raise ValueError("p must be a vector of per-client probabilities")
        if np.any(p < 0) or np.any(p > 1):
            raise ValueError("probabilities must lie in [0, 1]")
        self.p = p
        self.n = int(p.shape[0])

    def _p(self, generator: torch.Generator) -> torch.Tensor:
        return torch.as_tensor(self.p, device=generator.device)

    def sample(self, generator: torch.Generator) -> torch.Tensor:
        """One round of τ ∈ {0,1}^n."""
        return torch.bernoulli(self._p(generator), generator=generator)

    def sample_rounds(self, generator: torch.Generator, rounds: int) -> torch.Tensor:
        """(rounds, n) matrix of τ realizations."""
        p = self._p(generator).expand(rounds, self.n)
        return torch.bernoulli(p, generator=generator)


def homogeneous(n: int, p: float) -> ConnectivityModel:
    """Paper Fig. 2: p_i = p for all clients."""
    return ConnectivityModel(np.full((n,), p, dtype=np.float32))


def paper_heterogeneous() -> ConnectivityModel:
    """The exact p-vector of paper Figs. 3-4 (n = 10)."""
    return ConnectivityModel(
        np.array([0.1, 0.2, 0.3, 0.1, 0.1, 0.5, 0.8, 0.1, 0.2, 0.9], dtype=np.float32)
    )


def heterogeneous_profile(
    n: int, low: float = 0.1, high: float = 0.9, seed: int = 0
) -> ConnectivityModel:
    """A deliberately skewed profile in the paper's spirit: some clients with
    very low, some moderate, some very high connectivity."""
    rng = np.random.default_rng(seed)
    base = np.array([low, 0.2, 0.3, low, low, 0.5, 0.8, low, 0.2, high])
    if n <= base.size:
        p = base[:n]
    else:
        p = np.concatenate([base, rng.uniform(low, high, size=n - base.size)])
    return ConnectivityModel(p.astype(np.float32))
