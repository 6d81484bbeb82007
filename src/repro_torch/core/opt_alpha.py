"""OPT-α (paper Alg. 3): optimize the relay weight matrix A.

Host numpy, the JAX package's ``core/opt_alpha.py`` line for line, so the
same inputs give the same A (dense) or the same edge values (the sparse
solver, ``optimize_sparse``), and ``optimize_distributed`` (paper Remark 2)
gives the centralized solve's A from 2-hop information only.

Conventions
-----------
``A[j, i] = α_ji`` is the weight **relay** client ``j`` assigns to **origin**
client ``i``'s update while forming its local consensus
``Δx̃_j = Σ_i α_ji Δx_i``.  The unbiasedness condition (Lemma 1) is then the
per-origin (column) constraint

    Σ_{j ∈ N_i ∪ {i}} p_j · α_ji = 1,      α_ji ≥ 0,
    α_ji = 0 whenever j ∉ N_i ∪ {i}.

The variance proxy being minimized (paper eq. 4) is

    S(p, A) = Σ_{i,l} Σ_{j ∈ N_il} p_j (1 − p_j) α_ji α_jl.

Because α is supported on the closed neighborhoods, the double sum collapses
to row sums:  S(p, A) = Σ_j p_j (1 − p_j) · (Σ_i α_ji)²  — the total mass a
relay forwards is what multiplies its own Bernoulli uplink noise.  We use the
collapsed form for O(n²) evaluation and keep the O(n³) literal form as a
cross-check in the tests.

The Gauss–Seidel sweep (paper eq. 7-9) updates one column at a time; each
column subproblem is solved in closed form through its Lagrange multiplier
λ_i, located by bisection (paper-faithful) or by an exact piecewise-linear
solve (equivalent, used as a fast path / cross-check).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import topology


@dataclasses.dataclass(frozen=True)
class OptAlphaResult:
    A: np.ndarray                 # (n, n) relay weight matrix, A[j, i] = α_ji
    S_history: np.ndarray         # S(p, A) after each Gauss-Seidel sweep
    feasible_columns: np.ndarray  # bool (n,): column constraint satisfiable
    sweeps: int
    bisection_iters_total: int


def variance_proxy(p: np.ndarray, A: np.ndarray) -> float:
    """S(p, A) via the collapsed row-sum form (see module docstring)."""
    p = np.asarray(p, dtype=np.float64)
    row_mass = A.sum(axis=1)
    return float(np.sum(p * (1.0 - p) * row_mass**2))


def variance_proxy_literal(p: np.ndarray, A: np.ndarray, adj: np.ndarray) -> float:
    """S(p, A) exactly as written in paper eq. (4) — O(n³), test oracle."""
    p = np.asarray(p, dtype=np.float64)
    m = topology.closed_mask(adj)  # m[j, i] = j ∈ N_i ∪ {i}
    n = p.shape[0]
    w = p * (1.0 - p)
    s = 0.0
    for i in range(n):
        for l in range(n):
            for j in range(n):
                if m[j, i] and m[j, l]:
                    s += w[j] * A[j, i] * A[j, l]
    return float(s)


def unbiasedness_residual(p: np.ndarray, A: np.ndarray) -> np.ndarray:
    """Per-column residual of Lemma 1: (p @ A) − 1.  Zero ⇒ unbiased."""
    return np.asarray(p, dtype=np.float64) @ A - 1.0


def initial_weights(p: np.ndarray, adj: np.ndarray) -> np.ndarray:
    """Paper Alg. 3 line 1:  α_ji^(0) = 1 / ((|N_i|+1) · p_j)  on the support.

    When some closed-neighborhood members have p_j = 0 the literal formula
    leaves the column constraint violated (those terms are dropped); we then
    renormalize the column so the unbiasedness constraint holds at init —
    a documented deviation that only triggers with hard-disconnected clients.
    """
    p = np.asarray(p, dtype=np.float64)
    m = topology.closed_mask(adj)  # [j, i]
    sup = m & (p > 0)[:, None]  # empty column ⇒ infeasible, left all-zero
    denom = m.sum(axis=0)[None, :] * np.where(p > 0, p, 1.0)[:, None]
    A = np.where(sup, 1.0 / denom, 0.0)
    col = np.einsum("j,ji->i", p, A)
    fix = (col > 0) & ~np.isclose(col, 1.0)
    A *= np.where(fix, 1.0 / np.where(fix, col, 1.0), 1.0)[None, :]
    return A


# Fallback threshold for warm starts: a carried column is reused only when
# its mass p @ col clears this *relative* fraction of the column's largest
# carried entry (plus the absolute 1e-12 floor).  An absolute-only cutoff let
# columns with tiny-but-positive mass — e.g. every surviving relay of origin
# i is a near-departed client with p_j ≈ ε — be rescaled by ~1/mass into
# enormous α entries, poisoning the Gauss–Seidel seed.
WARM_START_RTOL = 1e-6


def warm_start_weights(
    p: np.ndarray, adj: np.ndarray, A_prev: np.ndarray
) -> np.ndarray:
    """Project a previous epoch's relay matrix onto a new channel ``(p, adj)``.

    Used by the adaptive OPT-α scheduler (the channels layer): after
    a small channel perturbation the old optimum is a near-feasible point, so
    seeding Gauss–Seidel from it converges in a few sweeps instead of from
    scratch.  Per column i: keep only entries on the new closed neighborhood
    with p_j > 0, rescale so Lemma 1 (Σ_j p_j α_ji = 1) holds under the new p,
    and fall back to the Alg. 3 initial weights for any column whose carried
    mass (nearly) vanished — every old relay of i dropped out of N_i ∪ {i},
    or the survivors' uplinks are so weak that rescaling by 1/mass would blow
    the column up (see :data:`WARM_START_RTOL`).
    """
    p = np.asarray(p, dtype=np.float64)
    adj = np.asarray(adj, dtype=bool)
    m = topology.closed_mask(adj)
    A = np.where(m, np.asarray(A_prev, dtype=np.float64), 0.0)
    A_init = None
    for i in range(p.shape[0]):
        sup = m[:, i] & (p > 0)
        col = np.where(sup, A[:, i], 0.0)
        mass = float(p @ col)
        col_max = float(col.max(initial=0.0))
        if mass > max(1e-12, WARM_START_RTOL * col_max):
            A[:, i] = col / mass
        else:
            if A_init is None:
                A_init = initial_weights(p, adj)
            A[:, i] = A_init[:, i]
    return A


def _solve_column_waterfill(
    p_sup: np.ndarray,
    beta: np.ndarray,
    *,
    tol: float = 1e-12,
    max_iters: int = 200,
) -> tuple[np.ndarray, int]:
    """Solve  min Σ w_j (α_j + β_j)²  s.t.  Σ p_j α_j = 1, α ≥ 0  over the
    support (0 < p_j < 1), via eq. (9):

        α_j(λ) = ( −β_j + λ / (2 (1 − p_j)) )⁺ ,
        g(λ)   = Σ_j p_j α_j(λ)  is nondecreasing;  find g(λ) = 1 by bisection.

    Returns (α, bisection_iterations).
    """
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
    # Exactly satisfy the equality constraint by rescaling the active set
    # (removes the residual bisection tolerance; active set is unchanged).
    s = float(p_sup @ alpha)
    if s > 0:
        alpha = alpha / s
    return alpha, iters


def _solve_column_exact(
    p_sup: np.ndarray,
    beta: np.ndarray,
) -> tuple[np.ndarray, int]:
    """The same column subproblem solved exactly: g(λ) = Σ_j p_j α_j(λ) is
    piecewise linear and nondecreasing with breakpoints λ_j = 2(1−p_j)β_j
    (where α_j activates), so instead of bisecting we sort the breakpoints
    and solve g(λ*) = 1 in closed form on the one segment that brackets it.

    O(s log s) per column against O(s · iters) for the bisection — the
    scheduler hot path under a time-varying channel (one OPT-α re-solve per
    channel epoch) is ~10× faster end to end.  Agrees with the bisection to
    its tolerance (tested), but is not bit-identical to it; the paper-
    faithful bisection stays the default.
    """
    one_minus = 1.0 - p_sup
    slope = p_sup / (2.0 * one_minus)     # d(p_j α_j)/dλ once j is active
    lam_break = 2.0 * one_minus * beta    # λ at which α_j leaves zero
    order = np.argsort(lam_break)
    lam_sorted = lam_break[order]
    csum_slope = np.cumsum(slope[order])
    csum_pb = np.cumsum((p_sup * beta)[order])
    lam = None
    for k in range(order.size):
        # active set = the k+1 smallest breakpoints; on this segment
        # g(λ) = λ·Σ_act slope − Σ_act p_j β_j, solve g = 1
        cand = (1.0 + csum_pb[k]) / csum_slope[k]
        hi = lam_sorted[k + 1] if k + 1 < order.size else np.inf
        if lam_sorted[k] <= cand <= hi:
            lam = cand
            break
    if lam is None:  # numerical ties: the last segment always extends to ∞
        lam = (1.0 + csum_pb[-1]) / csum_slope[-1]
    alpha = np.maximum(0.0, -beta + lam / (2.0 * one_minus))
    s = float(p_sup @ alpha)
    if s > 0:
        alpha = alpha / s
    return alpha, 0


_COLUMN_SOLVERS = {
    "bisect": _solve_column_waterfill,
    "exact": _solve_column_exact,
}


def solve_column(
    p: np.ndarray,
    closed_col: np.ndarray,
    beta_full: np.ndarray,
    *,
    method: str = "bisect",
) -> tuple[np.ndarray, bool, int]:
    """Paper eq. (9) for one origin column i.

    p          : (n,) connectivity probabilities
    closed_col : (n,) bool, j ∈ N_i ∪ {i}
    beta_full  : (n,) β_ji = Σ_{l ∈ L_ji} α_jl  (row mass excluding column i)
    method     : ``bisect`` (paper-faithful λ search) or ``exact`` (the
                 closed-form piecewise-linear solve; ~10× faster, identical
                 up to the bisection tolerance)

    Returns (column, feasible, bisection_iters).
    """
    if method not in _COLUMN_SOLVERS:
        known = ", ".join(sorted(_COLUMN_SOLVERS))
        raise ValueError(f"unknown column solver {method!r} (known: {known})")
    n = p.shape[0]
    col = np.zeros((n,), dtype=np.float64)
    ones = np.nonzero(closed_col & (p >= 1.0))[0]
    if ones.size > 0:
        # Zero-variance relays exist: put all mass uniformly on them (eq. 9 case 2).
        col[ones] = 1.0 / ones.size
        return col, True, 0
    sup = np.nonzero(closed_col & (p > 0.0))[0]
    if sup.size == 0:
        return col, False, 0  # nobody in N_i ∪ {i} can ever reach the PS
    alpha, iters = _COLUMN_SOLVERS[method](p[sup], beta_full[sup])
    col[sup] = alpha
    return col, True, iters


def optimize(
    p: np.ndarray,
    adj: np.ndarray,
    *,
    sweeps: int = 50,
    tol: float = 1e-10,
    A0: np.ndarray | None = None,
    method: str = "bisect",
) -> OptAlphaResult:
    """Run OPT-α Gauss–Seidel sweeps until S(p, A) stalls or `sweeps` is hit.

    One sweep = n column updates (paper Alg. 3 runs L single-column
    iterations; `sweeps` here counts full passes, i.e. L = sweeps·n).
    ``method`` selects the column solver (see :func:`solve_column`).
    """
    p = np.asarray(p, dtype=np.float64)
    adj = np.asarray(adj, dtype=bool)
    n = p.shape[0]
    m = topology.closed_mask(adj)
    A = initial_weights(p, adj) if A0 is None else np.array(A0, dtype=np.float64)
    feasible = np.ones((n,), dtype=bool)
    history = [variance_proxy(p, A)]
    bis_total = 0
    for _ in range(sweeps):
        for i in range(n):
            row_mass = A.sum(axis=1)
            beta = row_mass - A[:, i]  # β_ji = Σ_{l≠i} α_jl  (support-collapsed)
            col, ok, iters = solve_column(p, m[:, i], beta, method=method)
            A[:, i] = col
            feasible[i] = ok
            bis_total += iters
        history.append(variance_proxy(p, A))
        if abs(history[-2] - history[-1]) <= tol * max(1.0, history[-2]):
            break
    return OptAlphaResult(
        A=A,
        S_history=np.asarray(history),
        feasible_columns=feasible,
        sweeps=len(history) - 1,
        bisection_iters_total=bis_total,
    )


def optimize_masked(
    p: np.ndarray,
    adj: np.ndarray,
    active: np.ndarray,
    *,
    sweeps: int = 50,
    tol: float = 1e-10,
    A0: np.ndarray | None = None,
    method: str = "bisect",
) -> OptAlphaResult:
    """OPT-α on the *active block* of a padded client dimension.

    ``active`` is an (n_max,) boolean membership mask (client churn: clients
    not currently in the run).  The returned matrix is full (n_max, n_max)
    with every inactive row and column exactly zero — an inactive client
    neither relays nor is relayed — and its active block equals the dense
    Gauss–Seidel solve of the subproblem restricted to the active clients
    (tested).  Unbiasedness (Lemma 1) holds column-wise over the active set.

    The sweep loop visits only active columns, so a mostly-empty mask costs
    O(n_active) column solves per sweep, not O(n_max).

    ``feasible_columns`` reports **False for every inactive column**: a
    padded/departed slot has no constraint to satisfy, and reporting it True
    (the historical behavior — the vector was initialized all-True and only
    updated for active columns) made ``feasible_columns.all()`` and any
    reduction over the padded dim read success off columns that were never
    solved.  Mask with ``active & feasible_columns`` for "live and solvable",
    ``active & ~feasible_columns`` for "live but cut off from the PS".
    """
    p = np.asarray(p, dtype=np.float64)
    adj = np.asarray(adj, dtype=bool)
    active = np.asarray(active, dtype=bool)
    n = p.shape[0]
    if active.shape != (n,):
        raise ValueError(f"active mask shape {active.shape} != ({n},)")
    # Channel restricted to the active block: a departed client's links carry
    # nothing and its uplink never fires.
    adj_m = adj & active[:, None] & active[None, :]
    p_m = np.where(active, p, 0.0)
    m = topology.closed_mask(adj_m)
    m &= active[:, None] & active[None, :]
    if A0 is None:
        A = initial_weights(p_m, adj_m)
    else:
        A = np.where(m, np.asarray(A0, dtype=np.float64), 0.0)
    A[:, ~active] = 0.0
    A[~active, :] = 0.0
    # Inactive columns are never solved — they must not read "feasible".
    feasible = np.zeros((n,), dtype=bool)
    history = [variance_proxy(p_m, A)]
    bis_total = 0
    act_idx = np.nonzero(active)[0]
    for _ in range(sweeps):
        for i in act_idx:
            row_mass = A.sum(axis=1)
            beta = row_mass - A[:, i]
            col, ok, iters = solve_column(p_m, m[:, i], beta, method=method)
            A[:, i] = col
            feasible[i] = ok
            bis_total += iters
        history.append(variance_proxy(p_m, A))
        if abs(history[-2] - history[-1]) <= tol * max(1.0, history[-2]):
            break
    return OptAlphaResult(
        A=A,
        S_history=np.asarray(history),
        feasible_columns=feasible,
        sweeps=len(history) - 1,
        bisection_iters_total=bis_total,
    )


# --------------------------------------------------------------------------
# Neighborhood-blocked (sparse) OPT-α: everything O(E), nothing O(n²)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SparseOptAlphaResult:
    """OPT-α solution on a :class:`~repro_torch.core.topology.ClosedGraph`.

    ``vals[k]`` is α at entry k of the (fixed) closed-neighborhood structure:
    ``A[graph.rows[k], graph.cols[k]] = vals[k]``.  The structure covers the
    *full* graph — entries whose row or column is inactive simply carry 0 —
    so consecutive solves under per-round cohorts share one static edge
    layout (no retraces downstream, no re-analysis of the graph).
    """

    graph: topology.ClosedGraph
    vals: np.ndarray              # (nnz,) float64 α on the structure
    S_history: np.ndarray
    feasible_columns: np.ndarray  # bool (n,): False for inactive columns too
    sweeps: int
    bisection_iters_total: int

    def todense(self) -> np.ndarray:
        """Materialize the dense (n, n) matrix — small-n checks only."""
        n = self.graph.n
        A = np.zeros((n, n), dtype=np.float64)
        A[self.graph.rows, self.graph.cols] = self.vals
        return A

    def edge_relay(self):
        """The :class:`repro_torch.core.relay.EdgeRelay` operand for the
        ``segment`` aggregation backend (host numpy, f32/i32, with its
        segment layout)."""
        from repro_torch.core import relay as relay_lib  # opt_alpha stays torch-free

        rows = self.graph.rows.astype(np.int32)
        cols = self.graph.cols.astype(np.int32)
        return relay_lib.EdgeRelay(
            rows=rows,
            cols=cols,
            vals=self.vals.astype(np.float32),
            layout=relay_lib.segment_layout(rows, cols, self.graph.n),
        )


def _initial_vals_sparse(
    p_m: np.ndarray, graph: topology.ClosedGraph, entry_on: np.ndarray
) -> np.ndarray:
    """Alg. 3 line 1 on the CSC structure: the exact sparse counterpart of
    ``initial_weights(p_m, adj_m)`` restricted to entries with both endpoints
    active (``entry_on``).  ``p_m`` is already zeroed on inactive slots."""
    rows, cols = graph.rows, graph.cols
    n = graph.n
    # |N_i ∪ {i}| in the masked graph = live entries per column
    deg = np.bincount(cols[entry_on], minlength=n).astype(np.float64)
    pj = p_m[rows]
    sup = entry_on & (pj > 0)
    vals = np.zeros(rows.size, dtype=np.float64)
    vals[sup] = 1.0 / (deg[cols[sup]] * pj[sup])
    mass = np.bincount(cols[sup], weights=pj[sup] * vals[sup], minlength=n)
    fix = (mass > 0) & ~np.isclose(mass, 1.0)
    scale = np.where(fix, 1.0 / np.where(fix, mass, 1.0), 1.0)
    vals *= scale[cols]
    return vals


def warm_start_vals(
    p: np.ndarray,
    graph: topology.ClosedGraph,
    vals_prev: np.ndarray,
    active: np.ndarray | None = None,
) -> np.ndarray:
    """:func:`warm_start_weights` on the CSC structure, vectorized over
    columns.  Projects a previous cohort's α onto the new ``(p, active)``:
    entries off the live support are dropped, surviving columns are rescaled
    to restore Lemma 1, and columns whose carried mass fails the
    :data:`WARM_START_RTOL` relative test fall back to the Alg. 3 initial
    values — per-round cohort sampling hits that fallback constantly, which
    is exactly the regime the relative cutoff protects.
    """
    p = np.asarray(p, dtype=np.float64)
    rows, cols = graph.rows, graph.cols
    n = graph.n
    if active is None:
        entry_on = np.ones(rows.size, dtype=bool)
        p_m = p
    else:
        active = np.asarray(active, dtype=bool)
        entry_on = active[rows] & active[cols]
        p_m = np.where(active, p, 0.0)
    pj = p_m[rows]
    keep = entry_on & (pj > 0)
    kept = np.where(keep, np.asarray(vals_prev, dtype=np.float64), 0.0)
    mass = np.bincount(cols, weights=pj * kept, minlength=n)
    col_max = np.zeros(n, dtype=np.float64)
    np.maximum.at(col_max, cols, kept)
    good = mass > np.maximum(1e-12, WARM_START_RTOL * col_max)
    init = _initial_vals_sparse(p_m, graph, entry_on)
    scale = np.where(good, 1.0 / np.where(good, mass, 1.0), 1.0)
    return np.where(good[cols], kept * scale[cols], init)


def optimize_sparse(
    p: np.ndarray,
    adj: np.ndarray | None = None,
    active: np.ndarray | None = None,
    *,
    graph: topology.ClosedGraph | None = None,
    sweeps: int = 50,
    tol: float = 1e-10,
    vals0: np.ndarray | None = None,
    method: str = "bisect",
) -> SparseOptAlphaResult:
    """Neighborhood-blocked OPT-α: Gauss–Seidel where each column solve
    touches only the closed neighborhood N_i ∪ {i}.

    Equivalent to :func:`optimize_masked` (same initial point, same column
    visit order, same solver, same stall test) but with per-sweep cost
    O(n_active · max_deg) instead of O(n_active · n²): β comes from an
    incrementally-maintained row-mass vector rather than a fresh
    ``A.sum(axis=1)`` per column.  The active block of ``todense()`` matches
    the dense solve to fp-accumulation noise (≪ 1e-8, tested).

    Pass ``graph`` (from :func:`topology.closed_csc`) to amortize structure
    extraction across solves on the same adjacency — the per-round path of
    cohort sampling; ``adj`` is then not needed.  ``vals0`` seeds the sweep
    (see :func:`warm_start_vals`).
    """
    if graph is None:
        if adj is None:
            raise ValueError("optimize_sparse needs either adj or graph")
        graph = topology.closed_csc(np.asarray(adj, dtype=bool))
    p = np.asarray(p, dtype=np.float64)
    n = graph.n
    if p.shape != (n,):
        raise ValueError(f"p shape {p.shape} != ({n},)")
    rows, cols, indptr = graph.rows, graph.cols, graph.indptr
    if active is None:
        active = np.ones(n, dtype=bool)
    else:
        active = np.asarray(active, dtype=bool)
        if active.shape != (n,):
            raise ValueError(f"active mask shape {active.shape} != ({n},)")
    entry_on = active[rows] & active[cols]
    p_m = np.where(active, p, 0.0)
    if vals0 is None:
        vals = _initial_vals_sparse(p_m, graph, entry_on)
    else:
        vals = np.where(entry_on, np.asarray(vals0, dtype=np.float64), 0.0)
    w_var = p_m * (1.0 - p_m)
    row_mass = np.bincount(rows, weights=vals, minlength=n)
    feasible = np.zeros((n,), dtype=bool)
    history = [float(np.sum(w_var * row_mass**2))]
    bis_total = 0
    act_idx = np.nonzero(active)[0]
    solver = _COLUMN_SOLVERS.get(method)
    if solver is None:
        known = ", ".join(sorted(_COLUMN_SOLVERS))
        raise ValueError(f"unknown column solver {method!r} (known: {known})")
    for _ in range(sweeps):
        for i in act_idx:
            lo, hi = indptr[i], indptr[i + 1]
            r = rows[lo:hi]
            on = entry_on[lo:hi]
            old = vals[lo:hi]
            pr = p_m[r]
            new = np.zeros(r.size, dtype=np.float64)
            ones = on & (pr >= 1.0)
            if ones.any():
                new[ones] = 1.0 / ones.sum()
                feasible[i] = True
            else:
                sup = on & (pr > 0.0)
                if not sup.any():
                    feasible[i] = False
                else:
                    beta = row_mass[r[sup]] - old[sup]
                    alpha, iters = solver(pr[sup], beta)
                    new[sup] = alpha
                    feasible[i] = True
                    bis_total += iters
            row_mass[r] += new - old
            vals[lo:hi] = new
        history.append(float(np.sum(w_var * row_mass**2)))
        if abs(history[-2] - history[-1]) <= tol * max(1.0, history[-2]):
            break
    return SparseOptAlphaResult(
        graph=graph,
        vals=vals,
        S_history=np.asarray(history),
        feasible_columns=feasible,
        sweeps=len(history) - 1,
        bisection_iters_total=bis_total,
    )


def optimize_distributed(
    p: np.ndarray,
    adj: np.ndarray,
    *,
    sweeps: int = 50,
    tol: float = 1e-10,
) -> OptAlphaResult:
    """Distributed OPT-α (paper Remark 2): every column update at client i
    uses only quantities observable within i's 2-hop neighborhood.

    β_ji = Σ_{l ∈ L_ji} α_jl involves exactly the clients l ≠ i that share
    relay j with i — i.e. 2-hop neighbors. Here each client i keeps its own
    column and, per sweep, reconstructs the β it needs from the columns of
    its 2-hop neighborhood only (enforced by masking); the result must match
    the centralized Gauss-Seidel solve column-for-column (tested).
    """
    p = np.asarray(p, dtype=np.float64)
    adj = np.asarray(adj, dtype=bool)
    n = p.shape[0]
    m = topology.closed_mask(adj)
    # two_hop[i, l] = l visible from i through some shared relay j
    two_hop = np.zeros((n, n), dtype=bool)
    for i in range(n):
        relays = np.nonzero(m[:, i])[0]
        two_hop[i] = m[relays].any(axis=0)
    A = initial_weights(p, adj)
    feasible = np.ones((n,), dtype=bool)
    history = [variance_proxy(p, A)]
    bis_total = 0
    for _ in range(sweeps):
        for i in range(n):
            # client i only reads columns of its 2-hop neighborhood
            visible = np.where(two_hop[i][None, :], A, 0.0)
            beta = visible.sum(axis=1) - visible[:, i]
            col, ok, iters = solve_column(p, m[:, i], beta)
            A[:, i] = col
            feasible[i] = ok
            bis_total += iters
        history.append(variance_proxy(p, A))
        if abs(history[-2] - history[-1]) <= tol * max(1.0, history[-2]):
            break
    return OptAlphaResult(
        A=A, S_history=np.asarray(history), feasible_columns=feasible,
        sweeps=len(history) - 1, bisection_iters_total=bis_total,
    )


def fedavg_weights(n: int) -> np.ndarray:
    """No collaboration: A = I (paper's 'standard FL' special case)."""
    return np.eye(n, dtype=np.float64)


def colrel_expected_coverage(p: np.ndarray, adj: np.ndarray) -> np.ndarray:
    """P[origin i's update reaches the PS through ≥1 relay] = 1 − Π_j (1 − p_j)
    over j ∈ N_i ∪ {i}.  Diagnostic used in EXPERIMENTS.md."""
    p = np.asarray(p, dtype=np.float64)
    m = topology.closed_mask(adj)
    cov = np.empty_like(p)
    for i in range(p.shape[0]):
        cov[i] = 1.0 - np.prod(1.0 - p[m[:, i]])
    return cov
