"""Correlated connectivity: spatial shadowing + coupled uplink/D2D fading.

The earlier channel processes are *independent*: every D2D edge carries its
own Markov chain (`link_state`) and the uplink vector drifts on its own
(`drift`).  Real D2D meshes fail in correlated bursts — edges sharing a
blocked node or a common obstacle drop together, and a client behind that
obstacle loses its uplink at the same time.  This module models exactly that
regime (the journal version of the source paper, arXiv:2202.11850, and
Connectivity-Aware Semi-Decentralized FL over Time-Varying D2D Networks,
arXiv:2303.08988, both study it): one latent per-node log-shadowing field
drives the whole channel, so ``(adj, p)`` are *jointly* sampled.

The latent field
----------------
z(r) ∈ R^n is a Gauss–Markov process in time and a Gaussian process in
space over the node positions x_i::

    z(0) ~ N(0, Σ),    z(r+1) = ρ z(r) + sqrt(1 − ρ²) ε_r,   ε_r ~ N(0, Σ),
    Σ_ij = σ² exp(−‖x_i − x_j‖² / (2 ℓ²)).

ρ is the temporal coherence (the AR(1) pole), ℓ the spatial correlation
length.  ℓ = 0 recovers independent per-node fading; ℓ → ∞ makes every node
share one fade — a common obstacle that blocks the whole mesh at once.  The
marginal of each z_i is N(0, σ²) at every round, independent of ρ and ℓ, so
sweeping the correlation structure never changes the per-node fade statistics
— only how fades *co-occur*.

From the field, per coherence interval:

* **blockage** — node i is blocked when z_i < −threshold (deep shadow).
  Every edge incident to a blocked node is down: edges sharing a node fail
  together by construction (:class:`ShadowedLinkProcess`).
* **coupled uplink** — p_i = clip(sigmoid(logit(p_base_i) + γ z_i)): the
  same latent fade that kills i's D2D links degrades its uplink marginal
  (:class:`CoupledUplinkDrift`).  γ = 0 decouples; larger γ makes the uplink
  co-move harder with the local D2D state.

Both are layer-1 processes sharing one :class:`ShadowingField`, so the
existing layer-2 schedules compose them unchanged —
``TimeVaryingChannel(link_process=..., p_process=...)`` for the pure
channel, ``ChurnSchedule(membership=..., ...)`` to add client churn on top.
:class:`CorrelatedChannel` is the one-call convenience wrapper.  The field
advances exactly once per link step (the link process owns it); the uplink
process only *reads* the field and caches its value, so the ``adj_every`` /
``p_every`` throttles keep their meaning (``p_every > adj_every`` models
pilot estimates lagging the fade).
"""
from __future__ import annotations

import numpy as np

from repro_torch.channels.schedule import TimeVaryingChannel
from repro_torch.core import topology


def circle_positions(n: int, *, radius: float = 0.5) -> np.ndarray:
    """n points evenly spaced on a circle centred in the unit square — the
    canonical embedding for ``topology.ring`` graphs, where graph neighbors
    are also spatial neighbors (adjacent nodes sit ~2πr/n apart)."""
    theta = 2.0 * np.pi * np.arange(n) / n
    return 0.5 + radius * np.stack([np.cos(theta), np.sin(theta)], axis=1)


def spatial_covariance(
    positions: np.ndarray, *, corr_length: float, sigma: float = 1.0
) -> np.ndarray:
    """Squared-exponential GP covariance over node positions:
    Σ_ij = σ² exp(−‖x_i − x_j‖² / (2ℓ²)).  ℓ = 0 degenerates to σ²·I
    (independent nodes), ℓ = ∞ to the rank-one σ²·𝟙𝟙ᵀ (one shared fade)."""
    pos = np.asarray(positions, dtype=np.float64)
    if pos.ndim != 2 or pos.shape[1] != 2:
        raise ValueError(f"positions must be (n, 2), got {pos.shape}")
    if corr_length < 0 or sigma <= 0:
        raise ValueError("need corr_length >= 0 and sigma > 0")
    n = pos.shape[0]
    if corr_length == 0.0:
        return sigma**2 * np.eye(n)
    if np.isinf(corr_length):
        return np.full((n, n), sigma**2)
    diff = pos[:, None, :] - pos[None, :, :]
    d2 = np.sum(diff * diff, axis=-1)
    return sigma**2 * np.exp(-d2 / (2.0 * corr_length**2))


class ShadowingField:
    """The latent per-node log-shadowing field (see module docstring).

    ``step()`` advances one coherence interval; ``value()`` returns the
    current (n,) field.  ``set_positions`` re-fits the spatial covariance
    (mobility: nodes that move apart decorrelate) without resetting the
    temporal state.
    """

    def __init__(
        self,
        positions: np.ndarray,
        *,
        corr_length: float,
        rho: float = 0.9,
        sigma: float = 1.0,
        seed: int = 0,
    ):
        if not 0.0 <= rho < 1.0:
            raise ValueError("need 0 <= rho < 1 (rho = 1 never mixes)")
        self.corr_length = float(corr_length)
        self.rho = float(rho)
        self.sigma = float(sigma)
        self._rng = np.random.default_rng(seed)
        self._chol = None
        self.set_positions(positions)
        self.z = self._draw()  # stationary init: z(0) ~ N(0, Σ)

    def set_positions(self, positions: np.ndarray) -> None:
        cov = spatial_covariance(
            positions, corr_length=self.corr_length, sigma=self.sigma
        )
        # jitter keeps the Cholesky factorizable in the degenerate limits
        # (ℓ = ∞ is rank one; near-coincident mobile nodes are rank deficient)
        jitter = 1e-9 * self.sigma**2 * np.eye(cov.shape[0])
        self._chol = np.linalg.cholesky(cov + jitter)

    def _draw(self) -> np.ndarray:
        """One N(0, Σ) sample."""
        return self._chol @ self._rng.standard_normal(self._chol.shape[0])

    def value(self) -> np.ndarray:
        return self.z

    def step(self) -> np.ndarray:
        """AR(1) update z ← ρz + √(1−ρ²)·ε keeps the N(0, Σ) marginal."""
        self.z = self.rho * self.z + np.sqrt(1.0 - self.rho**2) * self._draw()
        return self.z


class ShadowedLinkProcess:
    """D2D adjacency from per-node blockage on a shared shadowing field.

    Node i is *blocked* when z_i < −``threshold``; the realized graph is the
    base envelope minus every edge incident to a blocked node.  The base is
    either a fixed ``base_adj`` or, with ``mobility``, the geometric graph of
    the current positions (which also re-fits the field's spatial covariance
    as nodes move).

    This process **owns** the shared field: ``step()`` advances it exactly
    once.  Uplink processes coupled to the same field only read it.
    """

    def __init__(
        self,
        base_adj: np.ndarray | None,
        field: ShadowingField,
        *,
        threshold: float = 1.0,
        mobility=None,
    ):
        if (base_adj is None) == (mobility is None):
            raise ValueError("pass exactly one of base_adj / mobility")
        if threshold < 0:
            raise ValueError("threshold must be nonnegative")
        self.field = field
        self.threshold = float(threshold)
        self._mobility = mobility
        self.base = (
            None
            if base_adj is None
            else topology._validate(np.asarray(base_adj, dtype=bool).copy())
        )

    @property
    def blocked(self) -> np.ndarray:
        """(n,) bool: nodes currently in deep shadow."""
        return self.field.value() < -self.threshold

    def _base_adjacency(self) -> np.ndarray:
        if self._mobility is not None:
            return self._mobility.adjacency()
        return self.base

    def adjacency(self) -> np.ndarray:
        """Current realized graph: base minus blocked-node edges."""
        up = ~self.blocked
        adj = self._base_adjacency() & up[:, None] & up[None, :]
        return topology._validate(adj.copy())

    def step(self) -> np.ndarray:
        if self._mobility is not None:
            self._mobility.step()
            self.field.set_positions(self._mobility.positions)
        self.field.step()
        return self.adjacency()


class CoupledUplinkDrift:
    """Uplink marginals driven by the *same* shadowing field as the D2D
    links:  p_i = clip(sigmoid(logit(p_base_i) + gain·z_i), low, high).

    A deep fade (z_i ≪ 0) that blocks i's D2D edges simultaneously drags its
    uplink toward ``low``; a strong line-of-sight round lifts it toward
    ``high``.  ``step()`` re-reads the field and caches the result —
    ``value()`` is stable between steps, so schedule throttling
    (``p_every``) behaves exactly like the independent drift processes.
    """

    def __init__(
        self,
        p_base: np.ndarray,
        field: ShadowingField,
        *,
        gain: float = 2.0,
        low: float = 0.05,
        high: float = 0.95,
    ):
        if gain < 0:
            raise ValueError("gain must be nonnegative")
        if not 0.0 < low < high < 1.0:
            raise ValueError("need 0 < low < high < 1")
        p0 = np.clip(np.asarray(p_base, dtype=np.float64), low, high)
        if p0.ndim != 1:
            raise ValueError("p_base must be a vector")
        self.field = field
        self.gain = float(gain)
        self.low = float(low)
        self.high = float(high)
        self._logit0 = np.log(p0) - np.log1p(-p0)
        self.p = self._from_field()

    def _from_field(self) -> np.ndarray:
        logit = self._logit0 + self.gain * self.field.value()
        return np.clip(1.0 / (1.0 + np.exp(-logit)), self.low, self.high)

    def value(self) -> np.ndarray:
        return self.p

    def step(self) -> np.ndarray:
        self.p = self._from_field()
        return self.p


class CorrelatedChannel(TimeVaryingChannel):
    """One-call jointly-sampled channel: shadowing-driven D2D blockage and
    (optionally) the coupled uplink, all from one latent field.

    Equivalent to composing :class:`ShadowedLinkProcess` /
    :class:`CoupledUplinkDrift` through :class:`TimeVaryingChannel` by hand
    — the pieces stay accessible as ``.field`` / ``.link`` for diagnostics.
    ``hold`` is the channel coherence time in rounds (both the blockage
    pattern and the coupled p refresh together every ``hold`` rounds, so
    epochs are chunked by the epoch engines).  With ``positions=None`` the
    nodes sit on a circle (:func:`circle_positions`), the natural embedding
    of the ring topologies; ``corr_length`` is then measured against a
    neighbor spacing of ~π/n in the unit square.
    """

    def __init__(
        self,
        base_adj: np.ndarray | None,
        p_base: np.ndarray,
        *,
        corr_length: float,
        positions: np.ndarray | None = None,
        mobility=None,
        rho: float = 0.9,
        sigma: float = 1.0,
        blockage_threshold: float = 1.0,
        couple_uplink: bool = True,
        uplink_gain: float = 2.0,
        p_low: float = 0.05,
        p_high: float = 0.95,
        hold: int = 1,
        seed: int = 0,
    ):
        if hold < 1:
            raise ValueError("hold must be >= 1")
        p_base = np.asarray(p_base, dtype=np.float64)
        if mobility is not None:
            positions = mobility.positions
        elif positions is None:
            positions = circle_positions(p_base.shape[0])
        self.field = ShadowingField(
            positions,
            corr_length=corr_length,
            rho=rho,
            sigma=sigma,
            seed=seed,
        )
        link = ShadowedLinkProcess(
            base_adj,
            self.field,
            threshold=blockage_threshold,
            mobility=mobility,
        )
        if couple_uplink:
            p_kw = {
                "p_process": CoupledUplinkDrift(
                    p_base, self.field, gain=uplink_gain, low=p_low, high=p_high
                )
            }
        else:
            p_kw = {"p": np.clip(p_base, p_low, p_high)}
        super().__init__(link_process=link, adj_every=hold, p_every=hold, **p_kw)

    @property
    def link(self) -> ShadowedLinkProcess:
        return self._link

    @property
    def blocked(self) -> np.ndarray:
        """(n,) bool: nodes currently blocked (diagnostic)."""
        return self._link.blocked
