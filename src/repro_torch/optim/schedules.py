"""Learning-rate schedules.  ``paper_lr`` is Theorem 1's
η_r = 4 μ⁻¹ / (r·T + 1); the constant/cosine schedules serve the DNN runs
(the paper itself uses constant 0.1 for ResNet-20).  Plain Python and numpy:
a round's lr is a host float, as the engines take it."""
from __future__ import annotations

import numpy as np


def paper_lr(mu: float, T: int):
    def lr(r: int) -> float:
        return 4.0 / (mu * (r * T + 1.0))
    return lr


def constant(value: float):
    return lambda r: value


def cosine(base: float, total_rounds: int, *, final_frac: float = 0.1):
    def lr(r: int) -> float:
        c = 0.5 * (1 + np.cos(np.pi * min(r, total_rounds) / total_rounds))
        return base * (final_frac + (1 - final_frac) * c)
    return lr
