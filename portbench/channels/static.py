"""A channel held fixed: the base graph and ``p0`` every round."""
from __future__ import annotations

import numpy as np


def schedule(spec: dict, adj: np.ndarray, seeds: dict):
    from repro_torch import channels

    return channels.StaticChannel(adj, np.asarray(spec["p0"], dtype=np.float32))
