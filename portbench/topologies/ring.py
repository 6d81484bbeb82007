"""Client i linked to (i ± d) mod n for d in 1..``k``."""
from __future__ import annotations

import numpy as np


def adjacency(spec: dict, n: int) -> np.ndarray:
    adj = np.zeros((n, n), dtype=bool)
    for d in range(1, spec["k"] + 1):
        for i in range(n):
            adj[i, (i + d) % n] = True
            adj[i, (i - d) % n] = True
    np.fill_diagonal(adj, False)
    return adj
