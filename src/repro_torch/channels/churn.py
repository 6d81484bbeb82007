"""Client churn: membership processes over a padded client dimension.

The simulator's client axis is padded to a fixed ``n_max``; churn is the
(n_max,) boolean *membership mask* changing between rounds.  A membership
process steps that mask (host-side numpy, like every other channel process),
and :class:`ChurnSchedule` composes it with the existing link-fading and
p-drift processes into one stream of ``(adj, p, active, epoch_id)`` states —
so a client joining or leaving is just a new value of a round input, never a
reshape.

Processes
---------
  StaticMembership   fixed mask (degenerate composition / warm-up phases)
  MarkovChurn        per-client on/off 2-state Markov chain (independent
                     arrivals/departures with geometric online-period lengths),
                     with a ``min_active`` floor so the run never empties
  RotatingCohorts    deterministic shift rotation: the padded slots are split
                     into k cohorts and one cohort is offline per shift —
                     reproducible churn for tests and benchmarks
"""
from __future__ import annotations

import numpy as np

from repro_torch.channels.schedule import TimeVaryingChannel


class StaticMembership:
    """Degenerate churn: the mask never changes."""

    def __init__(self, active):
        a = np.asarray(active, dtype=bool).copy()
        if a.ndim != 1:
            raise ValueError("active must be a vector")
        if not a.any():
            raise ValueError("at least one client must be active")
        self._a = a

    def value(self) -> np.ndarray:
        return self._a

    def step(self) -> np.ndarray:
        return self._a


class MarkovChurn:
    """Independent per-client membership chains: an active client departs
    with probability ``p_leave`` per step, an inactive one (re)joins with
    probability ``p_join`` — geometric online/absence lengths, the
    membership analogue of the Gilbert–Elliott link model.

    ``min_active`` guards the degenerate empty round: departures that would
    push the live count below the floor are resampled away (the kept clients
    are chosen uniformly among that step's survivors).
    """

    def __init__(
        self,
        n_max: int,
        *,
        p_leave: float,
        p_join: float,
        init_active=None,
        min_active: int = 1,
        seed: int = 0,
    ):
        if not (0.0 <= p_leave <= 1.0 and 0.0 <= p_join <= 1.0):
            raise ValueError("p_leave / p_join must be probabilities")
        if not (1 <= min_active <= n_max):
            raise ValueError("need 1 <= min_active <= n_max")
        self.n_max = int(n_max)
        self.p_leave = float(p_leave)
        self.p_join = float(p_join)
        self.min_active = int(min_active)
        self._rng = np.random.default_rng(seed)
        if init_active is None:
            self._a = np.ones((n_max,), dtype=bool)
        else:
            self._a = np.asarray(init_active, dtype=bool).copy()
            if self._a.shape != (n_max,):
                raise ValueError(f"init_active must have shape ({n_max},)")
        if self._a.sum() < min_active:
            raise ValueError("init_active starts below min_active")

    def value(self) -> np.ndarray:
        return self._a

    def step(self) -> np.ndarray:
        u = self._rng.random(self.n_max)
        nxt = np.where(self._a, u >= self.p_leave, u < self.p_join)
        deficit = self.min_active - int(nxt.sum())
        if deficit > 0:
            # revive `deficit` of this step's departures, uniformly
            departed = np.nonzero(self._a & ~nxt)[0]
            revive = self._rng.choice(departed, size=deficit, replace=False)
            nxt[revive] = True
        self._a = nxt
        return self._a


class RotatingCohorts:
    """Deterministic churn: n_max slots in ``n_cohorts`` contiguous cohorts;
    each shift of ``hold`` rounds takes exactly one cohort offline, rotating
    round-robin.  Every client periodically leaves and rejoins, with a
    perfectly reproducible trajectory."""

    def __init__(self, n_max: int, *, n_cohorts: int, hold: int = 1):
        if n_cohorts < 2 or n_cohorts > n_max:
            raise ValueError("need 2 <= n_cohorts <= n_max")
        if hold < 1:
            raise ValueError("hold must be >= 1")
        self.n_max = int(n_max)
        self.n_cohorts = int(n_cohorts)
        self.hold = int(hold)
        bounds = np.linspace(0, n_max, n_cohorts + 1).astype(int)
        self._cohorts = [np.arange(lo, hi) for lo, hi in zip(bounds[:-1], bounds[1:])]
        self._step = 0
        self._a = self._mask(0)

    def _mask(self, shift: int) -> np.ndarray:
        a = np.ones((self.n_max,), dtype=bool)
        a[self._cohorts[shift % self.n_cohorts]] = False
        return a

    def value(self) -> np.ndarray:
        return self._a

    def step(self) -> np.ndarray:
        self._step += 1
        self._a = self._mask(self._step // self.hold)
        return self._a


class ChurnSchedule(TimeVaryingChannel):
    """A :class:`TimeVaryingChannel` that additionally streams the churn
    mask: composes a membership process with a link-state process (or a fixed
    ``adj``) and a p-drift process (or a fixed ``p``), emitting one
    ``ChannelState(adj, p, active, epoch_id)`` per round.

    The emitted ``adj`` / ``p`` stay full-size (n_max); restriction to the
    active block is the consumer's job (``opt_alpha.optimize_masked`` host-
    side, ``relay.mask_relay_matrix`` in the round).  A membership
    change alone changes ``ChannelState.key()``, so it opens a new epoch and
    a new adaptive-scheduler cache entry.

    ``active_every`` throttles the membership process exactly like
    ``adj_every`` / ``p_every`` throttle the channel processes.
    """

    def __init__(self, *, membership, active_every: int = 1, **channel_kwargs):
        super().__init__(**channel_kwargs)
        if active_every < 1:
            raise ValueError("active_every must be >= 1")
        self._member = membership
        self._active_every = int(active_every)

    def _membership(self) -> np.ndarray:
        return self._member.value()

    def next_round(self):
        if self._round > 0 and self._round % self._active_every == 0:
            self._member.step()
        return super().next_round()
