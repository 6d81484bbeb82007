"""Ring-schedule D2D relay: the paper's physical exchange as point-to-point
rotations between ranks.

The PyTorch counterpart of the JAX package's ``fl/ring.py``.  The relaying
round of the paper (§II-C, eq. 2) is literally a network event: every
client transmits its local update to its D2D neighbors, each relay forms the
weighted consensus Δx̃_r = Σ_o α_{r,o} Δx_o, and the PS blindly sums what
arrives.  Across ranks the same dataflow is a **ring**: updates rotate
around the client axis (each rank sends to rank+1 and receives from rank−1
with ``torch.distributed.batch_isend_irecv``), and each rotation step adds
one α-weighted term to the local accumulator — after n−1 rotations every
relay holds its consensus with **O(1) live buffers** instead of the
O(n·|Δ|) gather.  The blind PS reduction is then a τ-weighted
``all_reduce`` over the same axis.

Step by step (4 ranks; at rotation s, rank r holds Δ_{(r−s) mod n} and adds
α_{r,(r−s)}·Δ_{(r−s)}):

    s=0   r0:Δ0   r1:Δ1   r2:Δ2   r3:Δ3      acc += α_{r,r}  Δ_r
    s=1   r0:Δ3   r1:Δ0   r2:Δ1   r3:Δ2      acc += α_{r,r−1}Δ_{r−1}
    s=2   r0:Δ2   r1:Δ3   r2:Δ0   r3:Δ1      acc += α_{r,r−2}Δ_{r−2}
    s=3   r0:Δ1   r1:Δ2   r2:Δ3   r3:Δ0      acc += α_{r,r−3}Δ_{r−3}
    all_reduce( w·τ_r · acc_r )  →  the PS increment, on every rank

Two granularities, each called by every rank of the mesh (SPMD, the
counterpart of a body inside ``shard_map``):

* **one client per rank** (:func:`ring_relay_local`,
  :func:`ring_colrel_increment`, :func:`make_ring_round_mixer`): pytree
  deltas, the reference formulation.
* **a block of clients per rank** (:func:`ring_relay_flat`,
  :func:`ring_colrel_increment_flat`): the production shape used inside
  `build_sharded_scan_round_step` — each of k ranks owns m = n/k client rows
  of the raveled (n, D) buffer, rotations move (m, D) blocks, and each step
  adds the (m, m) block product A[rows_r, rows_{r−s}] @ block.

Reduction-order note: the ring accumulates α-terms in rotation order
(diagonal first) through block products, whereas the dense backends sum
the origins in ascending order — the results agree to f32 accumulation
accuracy, *not* bitwise.  The sharded engine's ``exchange="gather"`` keeps
the dense order (bitwise against the single-device step);
``exchange="ring"`` trades that for O(1) buffers at a tolerance.  A
one-rank axis makes no point-to-point call at all.
"""
from __future__ import annotations

import torch

from repro_torch.utils import tree_axpy, tree_flatten, tree_map, tree_scale


def _f32_on(x, like) -> torch.Tensor:
    leaf = tree_flatten(like)[0][0]
    return torch.as_tensor(x, dtype=torch.float32, device=leaf.device)


def ring_relay_local(A, delta_local, axis_names: tuple, *, mesh):
    """Called by every rank of ``mesh``: ``delta_local`` is this rank's
    client's Δx (no client dim).  Returns Δx̃_r for the local relay r.
    A: (n, n), n = the size of ``axis_names``."""
    A = _f32_on(A, delta_local)
    n = A.shape[0]
    if n != mesh.axis_size(axis_names):
        raise ValueError(f"A is {n}×{n} but the axes {axis_names} hold "
                         f"{mesh.axis_size(axis_names)} ranks")
    r = mesh.axis_index(axis_names)
    acc = tree_scale(A[r, r], delta_local)
    buf = delta_local
    for s in range(1, n):
        buf = tree_map(lambda x: mesh.rotate(x, axis_names), buf)
        acc = tree_axpy(A[r, (r - s) % n], buf, acc)
    return acc


def ring_colrel_increment(A, tau, delta_local, *, w: float, axis_names: tuple, mesh):
    """The full blind round reduction, called by every rank:
    w · Σ_r τ_r Δx̃_r, the same on every rank of the client axes."""
    relayed = ring_relay_local(A, delta_local, axis_names, mesh=mesh)
    r = mesh.axis_index(axis_names)
    tau_r = _f32_on(tau, delta_local)[r]
    weighted = tree_scale(w * tau_r, relayed)
    return tree_map(lambda x: mesh.all_reduce(x, axis_names), weighted)


def make_ring_round_mixer(A, *, w: float, mesh, client_axes: tuple):
    """``mixer(tau, deltas_stacked)`` → the PS increment pytree, the same on
    every rank.  ``deltas_stacked`` has leaves (n, ...), n = the size of
    ``client_axes``; each rank reads only its own row (the one-client shard
    the JAX package's ``shard_map`` hands its device)."""

    def mixer(tau, deltas_stacked):
        r = mesh.axis_index(client_axes)
        delta_local = tree_map(lambda x: x[r], deltas_stacked)
        return ring_colrel_increment(A, tau, delta_local, w=w,
                                     axis_names=client_axes, mesh=mesh)

    return mixer


# --------------------------------------------------------------------------
# Block ring on the raveled (n, D) buffer: m = n/k clients per rank
# --------------------------------------------------------------------------


def ring_relay_flat(A, buf_local, *, axis_name: str, n_shards: int, mesh):
    """Called by every rank: ``buf_local`` is this rank's (m, D) block of
    the raveled delta buffer (rows j·m … (j+1)·m−1 of the (n, D) stack for
    rank j).  Returns the local relays' consensus block Δx̃ (m, D).

    ``A`` is the full (n, n) relay matrix, the same on every rank: rotation
    step s adds the (m, m) block product ``A[j·m:, origin·m:] @ block`` where
    ``origin = (j − s) mod k`` is the rank whose rows are passing through.
    """
    A = torch.as_tensor(A, dtype=torch.float32, device=buf_local.device)
    n = A.shape[0]
    if n % n_shards != 0:
        raise ValueError(f"n={n} not divisible by n_shards={n_shards}")
    if n_shards != mesh.axis_size(axis_name):
        raise ValueError(f"n_shards={n_shards} but the axis {axis_name!r} holds "
                         f"{mesh.axis_size(axis_name)} ranks")
    m = n // n_shards
    j = mesh.axis_index(axis_name)

    def block(r, c):
        return A[r * m:(r + 1) * m, c * m:(c + 1) * m]

    acc = block(j, j) @ buf_local
    buf = buf_local
    for s in range(1, n_shards):
        buf = mesh.rotate(buf, axis_name)
        acc = acc + block(j, (j - s) % n_shards) @ buf
    return acc


def ring_colrel_increment_flat(A, tau, buf_local, *, w, axis_name: str, n_shards: int, mesh):
    """The full blind round reduction on the flat buffer, called by every
    rank: u = w · Σ_r τ_r Δx̃_r → (D,), the same on every rank.

    ``tau`` is the full (n,) mask, the same on every rank (the sharded step
    draws it identically on every rank from the same seed); churn masking of
    A and τ is the *caller's* job, exactly as in
    ``aggregation.colrel_increment_flat`` — this function only phrases the
    contraction as k−1 rotations + an all_reduce.
    """
    relayed = ring_relay_flat(A, buf_local, axis_name=axis_name, n_shards=n_shards,
                              mesh=mesh)
    m = relayed.shape[0]
    j = mesh.axis_index(axis_name)
    tau = torch.as_tensor(tau, dtype=torch.float32, device=buf_local.device)
    u_local = (w * tau[j * m:(j + 1) * m]) @ relayed
    return mesh.all_reduce(u_local, axis_name)
