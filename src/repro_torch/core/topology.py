"""Client connectivity graphs G = (V, E) for the D2D relay network.

The graph is undirected and need not be connected (paper §II-B).  We represent
it by a dense boolean adjacency matrix with a zero diagonal; the neighborhood
closure ``N_i ∪ {i}`` used throughout the ColRel algebra is ``adj | I``.
"""
from __future__ import annotations

import numpy as np


def _validate(adj: np.ndarray) -> np.ndarray:
    adj = np.asarray(adj, dtype=bool)
    if adj.ndim != 2 or adj.shape[0] != adj.shape[1]:
        raise ValueError(f"adjacency must be square, got {adj.shape}")
    if not np.array_equal(adj, adj.T):
        raise ValueError("adjacency must be symmetric (graph is undirected)")
    np.fill_diagonal(adj, False)
    return adj


def fully_connected(n: int) -> np.ndarray:
    """FCT of paper Fig. 2: every client sees every other client."""
    adj = np.ones((n, n), dtype=bool)
    np.fill_diagonal(adj, False)
    return adj


def ring(n: int, k: int = 1) -> np.ndarray:
    """Ring topology of paper Fig. 3 (k=1) / Fig. 4 (k=2: 4 nearest neighbors).

    Client i is connected to clients (i ± d) mod n for d in 1..k.
    """
    if k < 0:
        raise ValueError("k must be >= 0")
    adj = np.zeros((n, n), dtype=bool)
    for d in range(1, k + 1):
        for i in range(n):
            adj[i, (i + d) % n] = True
            adj[i, (i - d) % n] = True
    np.fill_diagonal(adj, False)
    return adj


def disconnected(n: int) -> np.ndarray:
    """No D2D links: ColRel degenerates to plain FedAvg-with-dropout."""
    return np.zeros((n, n), dtype=bool)


def erdos_renyi(n: int, p: float, seed: int = 0) -> np.ndarray:
    """Random G(n, p) graph (symmetrized upper triangle)."""
    rng = np.random.default_rng(seed)
    upper = rng.random((n, n)) < p
    adj = np.triu(upper, 1)
    adj = adj | adj.T
    return _validate(adj)


def clusters(n: int, n_clusters: int) -> np.ndarray:
    """Disjoint fully-connected clusters (the paper allows disconnected G)."""
    if n_clusters < 1:
        raise ValueError("need at least one cluster")
    adj = np.zeros((n, n), dtype=bool)
    bounds = np.linspace(0, n, n_clusters + 1).astype(int)
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        adj[lo:hi, lo:hi] = True
    np.fill_diagonal(adj, False)
    return adj


def from_edges(n: int, edges) -> np.ndarray:
    adj = np.zeros((n, n), dtype=bool)
    for i, j in edges:
        if i == j:
            continue
        adj[i, j] = adj[j, i] = True
    return adj


def neighborhoods(adj: np.ndarray) -> list[np.ndarray]:
    """N_i for each client (indices, excluding self)."""
    adj = _validate(adj.copy())
    return [np.nonzero(adj[i])[0] for i in range(adj.shape[0])]


def closed_mask(adj: np.ndarray) -> np.ndarray:
    """Boolean mask of N_i ∪ {i}: entry [j, i] = can j's update reach relay i."""
    adj = _validate(adj.copy())
    return adj | np.eye(adj.shape[0], dtype=bool)


def common_neighborhood_sets(adj: np.ndarray) -> np.ndarray:
    """mask[j, i, l] = j ∈ N_il = (N_i ∪ {i}) ∩ (N_l ∪ {l}) (paper eq. 4)."""
    m = closed_mask(adj)  # [j, i]
    return m[:, :, None] & m[:, None, :]


class ClosedGraph:
    """CSC view of the closed neighborhoods N_i ∪ {i}.

    Column i of the closed mask is stored as the sorted row indices
    ``rows[indptr[i]:indptr[i+1]]`` — the only slots j with adj[j, i] or
    j == i.  Everything that is O(n²) on the dense mask (column supports,
    row masses, the relay contraction itself) becomes O(E) on this view,
    which is what lets OPT-α and the segment relay backend scale to
    n ≫ 10³ sparse graphs.
    """

    __slots__ = ("n", "indptr", "rows", "cols")

    def __init__(self, indptr: np.ndarray, rows: np.ndarray):
        self.indptr = np.asarray(indptr, dtype=np.int64)
        self.rows = np.asarray(rows, dtype=np.int64)
        self.n = self.indptr.size - 1
        # flat column index per stored entry: entry k lives in column cols[k]
        self.cols = np.repeat(
            np.arange(self.n, dtype=np.int64), np.diff(self.indptr)
        )

    @property
    def nnz(self) -> int:
        return int(self.rows.size)

    def column(self, i: int) -> np.ndarray:
        """Sorted row indices of closed column i (N_i ∪ {i})."""
        return self.rows[self.indptr[i] : self.indptr[i + 1]]

    def column_counts(self) -> np.ndarray:
        """|N_i| + 1 per column — the deg+1 normalizer of initial_weights."""
        return np.diff(self.indptr)

    def todense_mask(self) -> np.ndarray:
        m = np.zeros((self.n, self.n), dtype=bool)
        m[self.rows, self.cols] = True
        return m


def closed_csc(adj: np.ndarray) -> ClosedGraph:
    """Build the CSC closed-neighborhood structure from a dense adjacency.

    Row indices within each column come out sorted ascending (including the
    diagonal i itself), so per-column slices line up with the dense
    ``np.nonzero(closed_mask(adj)[:, i])`` ordering bit-for-bit.
    """
    m = closed_mask(adj)
    # nonzero on the transpose walks column-major: entries grouped by column
    cols, rows = np.nonzero(m.T)
    counts = np.bincount(cols, minlength=m.shape[0])
    indptr = np.concatenate(([0], np.cumsum(counts)))
    return ClosedGraph(indptr, rows)


def random_geometric(
    n: int, radius: float, *, seed: int = 0
) -> np.ndarray:
    """Random geometric graph on the unit square: clients at uniform
    positions, linked iff within ``radius``.

    Grid-binned neighbor search (cell size = radius) so construction is
    O(n · expected-degree), not O(n²) — the only graph family here that
    stays buildable at n = 10⁴⁺.  Expected degree ≈ n·π·radius², so pick
    ``radius = sqrt(deg / (π·n))`` for a target average degree.
    """
    if radius <= 0:
        raise ValueError("radius must be positive")
    rng = np.random.default_rng(seed)
    pos = rng.random((n, 2))
    ncell = max(1, int(np.floor(1.0 / radius)))
    cell = np.minimum((pos * ncell).astype(np.int64), ncell - 1)
    cell_id = cell[:, 0] * ncell + cell[:, 1]
    order = np.argsort(cell_id, kind="stable")
    sorted_ids = cell_id[order]
    # bucket boundaries in the sorted order, keyed by flat cell id
    starts = np.searchsorted(sorted_ids, np.arange(ncell * ncell))
    ends = np.searchsorted(sorted_ids, np.arange(ncell * ncell), side="right")
    r2 = radius * radius
    src: list[np.ndarray] = []
    dst: list[np.ndarray] = []
    for cx in range(ncell):
        for cy in range(ncell):
            mine = order[starts[cx * ncell + cy] : ends[cx * ncell + cy]]
            if mine.size == 0:
                continue
            for dx in (0, 1):
                for dy in (-1, 0, 1):
                    if dx == 0 and dy < 0:
                        continue  # each unordered cell pair visited once
                    nx, ny = cx + dx, cy + dy
                    if not (0 <= nx < ncell and 0 <= ny < ncell):
                        continue
                    theirs = order[starts[nx * ncell + ny] : ends[nx * ncell + ny]]
                    if theirs.size == 0:
                        continue
                    d = pos[mine, None, :] - pos[None, theirs, :]
                    hit = (d * d).sum(axis=-1) <= r2
                    if dx == 0 and dy == 0:
                        hit = np.triu(hit, 1)  # dedupe within-cell pairs
                    ii, jj = np.nonzero(hit)
                    if ii.size:
                        src.append(mine[ii])
                        dst.append(theirs[jj])
    adj = np.zeros((n, n), dtype=bool)
    if src:
        i = np.concatenate(src)
        j = np.concatenate(dst)
        adj[i, j] = True
        adj[j, i] = True
    np.fill_diagonal(adj, False)
    return adj
