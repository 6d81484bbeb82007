"""The base graph and ``p0`` every round."""
from __future__ import annotations

import numpy as np


def rounds(spec: dict, adj: np.ndarray, seeds: dict, k: int) -> list:
    p = np.asarray(spec["p0"], dtype=np.float32)
    return [(adj, p, None)] * k
