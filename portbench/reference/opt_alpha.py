"""OPT-α (paper Alg. 3) in host numpy, for the reference.

A frozen copy of the JAX package's dense solver, ``src/repro/core/
opt_alpha.py`` at commit c3a27a4 (``initial_weights``, the bisection
column solve and ``optimize``, all numpy; copied, not imported), with
``topology.closed_mask``.  The port's policies stop after a fixed number of
sweeps, so their A is not the optimum: the reference has to take the same
steps to arrive at the same A.  Each A it solves is also held to the
guarantees of the paper's Lemma 1 and eq. (4) on their own
(:func:`check_guarantees`), so a fault shared with the copied arithmetic
cannot pass unseen.

``A[j, i] = α_ji``: the weight relay j gives origin i's update.
"""
from __future__ import annotations

import numpy as np

# how far Σ_j p_j α_ji may miss 1 (the solver rescales each column to it)
UNBIASED_ATOL = 1e-9


def closed_mask(adj: np.ndarray) -> np.ndarray:
    """[j, i] = j ∈ N_i ∪ {i}."""
    adj = np.asarray(adj, dtype=bool).copy()
    np.fill_diagonal(adj, False)
    return adj | np.eye(adj.shape[0], dtype=bool)


def variance_proxy(p: np.ndarray, A: np.ndarray) -> float:
    p = np.asarray(p, dtype=np.float64)
    row_mass = A.sum(axis=1)
    return float(np.sum(p * (1.0 - p) * row_mass**2))


def initial_weights(p: np.ndarray, adj: np.ndarray) -> np.ndarray:
    p = np.asarray(p, dtype=np.float64)
    m = closed_mask(adj)
    sup = m & (p > 0)[:, None]
    denom = m.sum(axis=0)[None, :] * np.where(p > 0, p, 1.0)[:, None]
    A = np.where(sup, 1.0 / denom, 0.0)
    col = np.einsum("j,ji->i", p, A)
    fix = (col > 0) & ~np.isclose(col, 1.0)
    A *= np.where(fix, 1.0 / np.where(fix, col, 1.0), 1.0)[None, :]
    return A


def _solve_column(p_sup: np.ndarray, beta: np.ndarray, *, tol: float = 1e-12,
                  max_iters: int = 200) -> np.ndarray:
    one_minus = 1.0 - p_sup

    def alpha_of(lam: float) -> np.ndarray:
        return np.maximum(0.0, -beta + lam / (2.0 * one_minus))

    def g(lam: float) -> float:
        return float(p_sup @ alpha_of(lam))

    lo, hi = 0.0, 1.0
    iters = 0
    while g(hi) < 1.0:
        hi *= 2.0
        iters += 1
        if hi > 1e18:
            raise FloatingPointError("bisection bracket blew up (infeasible column?)")
    while hi - lo > tol * max(1.0, hi) and iters < max_iters:
        mid = 0.5 * (lo + hi)
        if g(mid) < 1.0:
            lo = mid
        else:
            hi = mid
        iters += 1
    alpha = alpha_of(hi)
    s = float(p_sup @ alpha)
    if s > 0:
        alpha = alpha / s
    return alpha


def solve_column(p: np.ndarray, closed_col: np.ndarray, beta_full: np.ndarray) -> np.ndarray:
    n = p.shape[0]
    col = np.zeros((n,), dtype=np.float64)
    ones = np.nonzero(closed_col & (p >= 1.0))[0]
    if ones.size > 0:
        col[ones] = 1.0 / ones.size
        return col
    sup = np.nonzero(closed_col & (p > 0.0))[0]
    if sup.size == 0:
        return col
    col[sup] = _solve_column(p[sup], beta_full[sup])
    return col


def optimize(p: np.ndarray, adj: np.ndarray, *, sweeps: int, tol: float = 1e-10) -> np.ndarray:
    """Gauss–Seidel sweeps until S(p, A) stalls or ``sweeps`` is hit."""
    p = np.asarray(p, dtype=np.float64)
    adj = np.asarray(adj, dtype=bool)
    n = p.shape[0]
    m = closed_mask(adj)
    A = initial_weights(p, adj)
    history = [variance_proxy(p, A)]
    for _ in range(sweeps):
        for i in range(n):
            row_mass = A.sum(axis=1)
            beta = row_mass - A[:, i]
            A[:, i] = solve_column(p, m[:, i], beta)
        history.append(variance_proxy(p, A))
        if abs(history[-2] - history[-1]) <= tol * max(1.0, history[-2]):
            break
    check_guarantees(p, adj, A, history[0])
    return A


def check_guarantees(p: np.ndarray, adj: np.ndarray, A: np.ndarray, s_start: float) -> None:
    """Raise unless A is a sound OPT-α answer, whatever arithmetic made it:
    no negative weight, none off the closed neighbourhoods, every origin
    that some relay can carry (a j ∈ N_i ∪ {i} with p_j > 0) received with
    Σ_j p_j α_ji = 1 (Lemma 1, unbiasedness), and the variance proxy S
    no higher than where the sweeps started."""
    m = closed_mask(adj)
    carried = (m & (p > 0)[:, None]).any(axis=0)
    residual = np.abs(p @ A - 1.0)[carried]
    faults = []
    if (A < 0).any():
        faults.append(f"negative weight {A.min()!r}")
    if (A[~m] != 0).any():
        faults.append("weight off the closed neighbourhoods")
    if residual.size and residual.max() > UNBIASED_ATOL:
        faults.append(f"unbiasedness residual {residual.max()!r}")
    if variance_proxy(p, A) > s_start * (1 + 1e-9):
        faults.append(f"S rose from {s_start!r} to {variance_proxy(p, A)!r}")
    if faults:
        raise ArithmeticError("OPT-alpha: " + "; ".join(faults))


def project_to_support(A: np.ndarray, adj: np.ndarray) -> np.ndarray:
    """Zero every weight the current graph cannot carry."""
    return np.where(closed_mask(adj), np.asarray(A, dtype=np.float64), 0.0)
