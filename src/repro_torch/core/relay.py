"""Collaborative relaying of local updates (paper §II-C, Alg. 1 lines 6-9).

Every function operates on a *stacked* pytree of client updates: each leaf has
a leading client dimension of size n.  Two paths compute the same math:

  * ``relay`` — the paper-faithful local consensus  Δx̃ = A · Δx.
  * ``fused_coefficients`` / ``fused_aggregate`` — relay and PS aggregation
    fused:  w Σ_r τ_r Δx̃_r = w Σ_o c_o Δx_o  with  c = τᵀA.  One weighted
    reduce instead of an n-way mix.

The relay operator comes from the host (``core.opt_alpha``, numpy): a dense
(n, n) matrix, or the sparse :class:`EdgeRelay` edge list of the ``segment``
backend, whose relay∘aggregate cost scales with the edge count E, not n².

Segment sums are deterministic
------------------------------
The JAX package contracts an EdgeRelay with ``jax.ops.segment_sum``.  Its
torch counterparts (``index_add_``/``scatter_add_``) add with atomics on the
GPU, in an order that changes from run to run, and the engines' bitwise gates
need the same bits every run.  So the port sums each segment in a fixed
order instead: a :class:`SegmentLayout` lists, for every relay row and every
origin column, the indices of its edges in ascending edge order, padded to
the largest segment with the index E of a zero appended after the last edge.
A segment sum is then a gather of that (n, W) index matrix and a sum over W,
the same ops on the CPU and on the card.  The layout depends on the graph
alone, so ``SparseOptAlpha`` builds it once a graph and every EdgeRelay of
that graph carries it; :func:`as_relay_operand` builds it for one that
comes without.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.utils import tree_map


class SegmentLayout(NamedTuple):
    """An EdgeRelay's edges grouped by segment: ``by_row[j]`` lists the
    edges whose relay is j, ``by_col[i]`` those whose origin is i, each in
    ascending edge order and padded with E (one past the last edge).  Both
    (n, W) int32, W the largest segment (at least 1)."""

    by_row: Any
    by_col: Any


class EdgeRelay(NamedTuple):
    """Edge-list relay operator: entry k stands for A[rows[k], cols[k]] =
    vals[k], everything off the list identically zero.

    The sparse counterpart of the dense (n, n) relay matrix, produced by
    ``opt_alpha.SparseOptAlphaResult.edge_relay()`` and
    ``channels.SparseOptAlpha`` and consumed by the ``relay_backend="segment"``
    aggregation path.  The leaves are numpy arrays on the host and tensors
    on the device (:func:`as_relay_operand` moves them); a NamedTuple, so
    ``repro_torch.utils.tree_map`` keeps the type.  ``layout`` is the
    fixed-order summation plan (see the module docstring); None until one
    is built.

    Orientation matches the dense convention: ``rows`` indexes the relay j,
    ``cols`` the origin i whose update it forwards.
    """

    rows: Any  # (E,) int32 relay index j
    cols: Any  # (E,) int32 origin index i
    vals: Any  # (E,) float32 α_ji
    layout: SegmentLayout | None = None

    def todense(self, n: int) -> torch.Tensor:
        """Scatter into the dense (n, n) f32 matrix (small-n parity checks
        and the dense backends; never on the segment hot path)."""
        vals = torch.as_tensor(_host(self.vals)).float()
        rows = torch.as_tensor(_host(self.rows), device=vals.device).long()
        cols = torch.as_tensor(_host(self.cols), device=vals.device).long()
        A = torch.zeros((n, n), dtype=torch.float32, device=vals.device)
        return A.index_put_((rows, cols), vals, accumulate=True)


def _host(x):
    """A numpy leaf as a writable array torch can wrap without a warning (a
    copy only if it is read-only, as the policies' arrays are); a tensor as
    it is."""
    if isinstance(x, torch.Tensor):
        return x
    x = np.asarray(x)
    return x if x.flags.writeable else x.copy()


def segment_layout(rows, cols, n: int) -> SegmentLayout:
    """The :class:`SegmentLayout` of an edge list over n clients (host
    numpy; tensors are read back to the host)."""

    def as_index(x):
        x = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        return x.astype(np.int64)

    rows, cols = as_index(rows), as_index(cols)
    E = rows.size
    if rows.shape != (E,) or cols.shape != (E,):
        raise ValueError(f"edge list shapes {rows.shape}, {cols.shape} differ")
    if E and (min(rows.min(), cols.min()) < 0 or max(rows.max(), cols.max()) >= n):
        raise ValueError(f"edge index out of range for n = {n}")

    def group(seg):
        order = np.argsort(seg, kind="stable")
        counts = np.bincount(seg, minlength=n)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        slot = np.arange(E) - starts[seg[order]]
        out = np.full((n, max(int(counts.max(initial=0)), 1)), E, dtype=np.int32)
        out[seg[order], slot] = order
        return out

    return SegmentLayout(by_row=group(rows), by_col=group(cols))


def edge_relay_from_dense(A, *, tol: float = 0.0) -> EdgeRelay:
    """Host-side helper: build an EdgeRelay (with its layout) from a dense
    matrix, keeping entries with |A| > tol (tol=0 keeps explicit structural
    zeros out)."""
    A = np.asarray(A)
    if A.ndim != 2 or A.shape[0] != A.shape[1]:
        raise ValueError(f"relay matrix must be square, got {A.shape}")
    rows, cols = np.nonzero(np.abs(A) > tol)
    rows = np.asarray(rows, dtype=np.int32)
    cols = np.asarray(cols, dtype=np.int32)
    return EdgeRelay(
        rows=rows,
        cols=cols,
        vals=np.asarray(A[rows, cols], dtype=np.float32),
        layout=segment_layout(rows, cols, A.shape[0]),
    )


def _leaf_device(*xs) -> torch.device:
    """The device of the first tensor among ``xs`` (the CPU if none is)."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return torch.device("cpu")


def _edge_relay_on(A: EdgeRelay, n: int, device) -> EdgeRelay:
    """``A`` with int32 indices, f32 values and its layout, all on
    ``device`` (leaves already there and of that dtype are not copied)."""
    layout = A.layout if A.layout is not None else segment_layout(A.rows, A.cols, n)
    if layout.by_row.shape[0] != n or layout.by_col.shape[0] != n:
        raise ValueError(f"segment layout is for {layout.by_row.shape[0]} clients, not {n}")

    def to(x, dtype):
        return torch.as_tensor(_host(x)).to(device=device, dtype=dtype)

    return EdgeRelay(
        rows=to(A.rows, torch.int32),
        cols=to(A.cols, torch.int32),
        vals=to(A.vals, torch.float32),
        layout=tree_map(lambda x: to(x, torch.int32), layout),
    )


def as_relay_operand(A, *, n: int, backend: str = "einsum", device=None):
    """Normalize a relay operand for an aggregation backend, on ``device``.

    Dense inputs go to a float32 (n, n) tensor; an :class:`EdgeRelay` stays
    an EdgeRelay (int32/float32 leaves, with its layout) for
    ``backend="segment"`` and is densified otherwise — the dense backends
    have no sparse lowering, and the densify keeps small-n parity checks
    able to run any backend against a sparse policy's output.  The one
    refusal, dense matrix + segment backend, lives in the aggregation layer
    where the error can point at the policy knob.
    """
    if A is None:
        return None
    if isinstance(A, EdgeRelay):
        if backend == "segment":
            return _edge_relay_on(A, n, device)
        return A.todense(n).to(device)
    if isinstance(A, np.ndarray):
        # a copy: the relay policies hand out read-only matrices, which
        # torch would wrap with a warning
        A = np.array(A, dtype=np.float32)
    A = torch.as_tensor(A, dtype=torch.float32, device=device)
    if tuple(A.shape) != (n, n):
        raise ValueError(f"relay matrix shape {tuple(A.shape)} != ({n}, {n})")
    return A


def _check_square(A) -> torch.Tensor:
    A = torch.as_tensor(A)
    if A.dim() != 2 or A.shape[0] != A.shape[1]:
        raise ValueError(f"relay matrix must be square, got {tuple(A.shape)}")
    return A


def relay(A, stacked_updates):
    """Local consensus Δx̃_r = Σ_o A[r, o] Δx_o for every relay r.

    ``stacked_updates``: pytree whose leaves are (n, ...) tensors.
    Returns a pytree of identical structure/shape.
    """
    A = _check_square(A)

    def mix(leaf):
        if leaf.shape[0] != A.shape[0]:
            raise ValueError(
                f"leading client dim {leaf.shape[0]} != n = {A.shape[0]}"
            )
        A_l = A.to(device=leaf.device, dtype=torch.float32)
        out = (A_l @ leaf.float().reshape(leaf.shape[0], -1)).reshape(leaf.shape)
        return out.to(leaf.dtype)

    return tree_map(mix, stacked_updates)


def mask_relay_matrix(A, active):
    """Restrict A to the active block of a padded client dimension: zero
    every row and column of an inactive client (churn semantics — a departed
    client neither relays nor is relayed).  ``active`` is an (n,) 0/1
    vector, so membership can change per round.  On an :class:`EdgeRelay`
    (tensor leaves) the same mask folds into the edge values — any entry
    touching an inactive endpoint goes exactly to zero."""
    if isinstance(A, EdgeRelay):
        device = _leaf_device(A.vals, active)
        active = torch.as_tensor(active, dtype=torch.float32, device=device)
        A = _edge_relay_on(A, active.shape[0], device)
        vals = A.vals * active.index_select(0, A.rows) * active.index_select(0, A.cols)
        return A._replace(vals=vals)
    A = _check_square(A).float()
    active = torch.as_tensor(active, dtype=torch.float32, device=A.device)
    return active[:, None] * A * active[None, :]


def _segment_sum(contrib: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """Per-segment sums of the (E,) ``contrib`` under an (n, W) slot matrix
    of a :class:`SegmentLayout`: a gather (the pad index E reads an appended
    zero) and a sum over W, in the same order on every run."""
    padded = torch.cat([contrib, contrib.new_zeros(1)])
    gathered = padded.index_select(0, slots.reshape(-1)).reshape(slots.shape)
    return gathered.sum(dim=1)


def fused_coefficients(A, tau) -> torch.Tensor:
    """c_o = Σ_r τ_r α_ro — the per-origin coefficient of the fused
    relay+aggregate path (c = τᵀ A).  For an :class:`EdgeRelay` the
    contraction is a segment sum over edges grouped by origin column: O(E)
    instead of O(n²)."""
    if isinstance(A, EdgeRelay):
        device = _leaf_device(A.vals, tau)
        tau = torch.as_tensor(tau, dtype=torch.float32, device=device)
        A = _edge_relay_on(A, tau.shape[0], device)
        return _segment_sum(tau.index_select(0, A.rows) * A.vals, A.layout.by_col)
    A = _check_square(A).float()
    tau = torch.as_tensor(tau, dtype=torch.float32, device=A.device)
    return tau @ A


def segment_mix(A: EdgeRelay, buf: torch.Tensor) -> torch.Tensor:
    """Δ̃ = A·Δ on the flat (n, D) buffer: for each relay row, the sum of
    its edges' α·Δ[origin] in ascending edge order — the paper-faithful
    (unfused) consensus at O(E·D).  The sum runs over the layout's W slots,
    one (n, D) multiply-add a slot (a padded slot adds α = 0 times an
    appended zero row), so no (E, D) intermediate is held; the fused
    coefficient path stays the hot choice at scale."""
    if not isinstance(A, EdgeRelay):
        raise TypeError("segment_mix needs an EdgeRelay operand")
    buf = torch.as_tensor(buf).float()
    n, D = buf.shape
    A = _edge_relay_on(A, n, buf.device)
    by_row = A.layout.by_row
    vals = torch.cat([A.vals, buf.new_zeros(1)])
    cols = torch.cat([A.cols, A.cols.new_full((1,), n)])
    buf_pad = torch.cat([buf, buf.new_zeros(1, D)])
    out = buf.new_zeros(n, D)
    for w in range(by_row.shape[1]):
        k = by_row[:, w]
        out = out + vals.index_select(0, k)[:, None] * buf_pad.index_select(
            0, cols.index_select(0, k))
    return out


def fused_aggregate(A, tau, stacked_updates, *, w):
    """w · Σ_r τ_r Δx̃_r computed without materializing Δx̃.  Returns the PS
    model increment pytree (no client dim)."""
    c = w * fused_coefficients(A, tau)
    return tree_map(lambda leaf: torch.tensordot(c, leaf.float(), dims=([0], [0])),
                    stacked_updates)


def masked_aggregate(tau, stacked_relayed, *, w):
    """Paper-faithful PS reduction  w · Σ_r τ_r Δx̃_r  over already-relayed
    updates (eq. 2).  Blind: uses only the mask, never client identities."""

    def reduce(leaf):
        t = torch.as_tensor(tau, dtype=torch.float32, device=leaf.device)
        return torch.tensordot(w * t, leaf.float(), dims=([0], [0]))

    return tree_map(reduce, stacked_relayed)


def neighbor_support(A, adj) -> bool:
    """True iff A is supported on the closed neighborhoods of ``adj`` —
    i.e. no client uses an update it could never have received over D2D."""
    from repro_torch.core import topology

    m = topology.closed_mask(np.asarray(adj))
    if isinstance(A, torch.Tensor):
        A = A.detach().cpu().numpy()
    A = np.asarray(A)
    return bool(np.all(A[~m] == 0.0))
