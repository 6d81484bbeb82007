"""Markov link fading on the base graph (redrawn every ``adj_every``
rounds) and piecewise-constant uplink drift (held ``drift.hold`` rounds,
redrawn uniform in [``drift.low``, ``drift.high``]), each drawn from the
seed the mix gives it: the same channel in every run."""
from __future__ import annotations

import numpy as np


def schedule(spec: dict, adj: np.ndarray, seeds: dict):
    from repro_torch import channels

    link, drift = spec["link"], spec["drift"]
    return channels.TimeVaryingChannel(
        link_process=channels.MarkovLinkProcess(
            adj, p_up_to_down=link["p_up_to_down"], p_down_to_up=link["p_down_to_up"],
            seed=link["seed"]),
        p_process=channels.PiecewiseConstantDrift(
            np.asarray(spec["p0"], dtype=np.float32), hold=drift["hold"], low=drift["low"],
            high=drift["high"], seed=drift["seed"]),
        adj_every=spec["adj_every"])
