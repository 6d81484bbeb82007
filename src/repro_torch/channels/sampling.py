"""Per-round cohort sampling over the padded client dimension.

Sampled-cohort federated rounds (the sampled-to-sampled regime of arXiv
2511.11560, and the participation model FedDec / arXiv 2306.06715 keeps D2D
relaying useful under): each round only a cohort of the eligible clients
trains and reports, so per-round cost scales with the cohort and the live
edge set, not with n_max.  :class:`CohortSampler` is a *membership process*
(the ``value()``/``step()`` protocol of ``repro_torch.channels.churn``), so it
plugs straight into :class:`~repro_torch.channels.churn.ChurnSchedule` — and it
optionally wraps another membership process as the eligibility base, making
the emitted mask

    active = membership ∧ sampled

with both factors stepping on the schedule's cadence.  Downstream nothing
changes: the cohort is just the round's ``active`` mask, a per-round input
of the round.

The PyTorch counterpart of the JAX package's ``channels/sampling.py``, host
numpy line for line: the same seeds emit the same cohorts.

Strategies
----------
  uniform    iid Bernoulli(rate) over the eligible members — the classic
             unbiased client-sampling model (random cohort size)
  fixed_k    uniform without replacement, exactly k of the members — fixed
             cohort size, inclusion probability k/m (unbiased, and the
             static-shape-friendly choice for benchmarking)
  expander   deterministic power-of-two strides over the padded ring (à la
             the exponential-offset collaborator schedules of gossip
             learning): round r takes k slots at stride 2^(r mod L) from a
             moving offset, cycling stride lengths so consecutive cohorts
             mix across the index space — reproducible, no RNG
"""
from __future__ import annotations

import numpy as np

STRATEGIES = ("uniform", "fixed_k", "expander")


class CohortSampler:
    """Membership process emitting ``base_membership ∧ sampled_cohort``.

    ``base`` is an optional inner membership process (StaticMembership /
    MarkovChurn / RotatingCohorts / another sampler); ``None`` means every
    padded slot is eligible.  ``resample_every`` redraws the cohort every
    that many steps (the base still steps every step); the default 1 is the
    per-round-cohort regime.  The sampled mask is never empty: if the draw
    misses every eligible member, one member is force-included.
    """

    def __init__(
        self,
        n_max: int,
        *,
        strategy: str = "uniform",
        k: int | None = None,
        rate: float | None = None,
        base=None,
        resample_every: int = 1,
        seed: int = 0,
    ):
        if strategy not in STRATEGIES:
            raise ValueError(
                f"unknown sampling strategy {strategy!r} (known: {STRATEGIES})"
            )
        if n_max < 1:
            raise ValueError("n_max must be >= 1")
        if resample_every < 1:
            raise ValueError("resample_every must be >= 1")
        if strategy == "uniform":
            if rate is None or not (0.0 < rate <= 1.0):
                raise ValueError("uniform sampling needs a rate in (0, 1]")
        else:
            if k is None or not (1 <= k <= n_max):
                raise ValueError(f"{strategy} sampling needs 1 <= k <= n_max")
        self.n_max = int(n_max)
        self.strategy = strategy
        self.k = None if k is None else int(k)
        self.rate = None if rate is None else float(rate)
        self._base = base
        self._resample_every = int(resample_every)
        self._rng = np.random.default_rng(seed)
        self._step_count = 0
        self._offset = 0
        # stride cycle length for the expander schedule: powers 2^0..2^(L-1)
        self._stride_cycle = max(1, int(np.floor(np.log2(max(2, n_max)))))
        self._a = self._compose(self._draw())

    def _members(self) -> np.ndarray:
        if self._base is None:
            return np.ones((self.n_max,), dtype=bool)
        m = np.asarray(self._base.value(), dtype=bool)
        if m.shape != (self.n_max,):
            raise ValueError(
                f"base membership shape {m.shape} != ({self.n_max},)"
            )
        return m

    def _draw(self) -> np.ndarray:
        """The sampled factor alone, over the padded index space."""
        sampled = np.zeros((self.n_max,), dtype=bool)
        if self.strategy == "uniform":
            sampled = self._rng.random(self.n_max) < self.rate
        elif self.strategy == "fixed_k":
            members = np.nonzero(self._members())[0]
            take = min(self.k, members.size)
            if take > 0:
                pick = self._rng.choice(members, size=take, replace=False)
                sampled[pick] = True
        else:  # expander: deterministic stride schedule, no RNG
            stride = 1 << (self._step_count % self._stride_cycle)
            idx = (self._offset + stride * np.arange(self.k)) % self.n_max
            sampled[np.unique(idx)] = True
            self._offset = (self._offset + self.k) % self.n_max
        return sampled

    def _compose(self, sampled: np.ndarray) -> np.ndarray:
        members = self._members()
        a = members & sampled
        if not a.any() and members.any():
            # keep the round non-degenerate: force one eligible member in
            pool = np.nonzero(members)[0]
            a = a.copy()
            a[self._rng.choice(pool)] = True
        return a

    def value(self) -> np.ndarray:
        return self._a

    def step(self) -> np.ndarray:
        if self._base is not None:
            self._base.step()
        self._step_count += 1
        if self._step_count % self._resample_every == 0:
            self._a = self._compose(self._draw())
        else:
            # base may have moved even between redraws: re-intersect
            self._a = self._compose(self._a_sampled_factor())
        return self._a

    def _a_sampled_factor(self) -> np.ndarray:
        # between redraws the sampled factor is whatever survived composition
        # plus nothing new; re-deriving it from the held mask keeps a slot
        # that left-and-rejoined the base out of the cohort until a redraw
        return self._a
