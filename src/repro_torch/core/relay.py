"""Collaborative relaying of local updates (paper §II-C, Alg. 1 lines 6-9),
the dense part.

Every function operates on a *stacked* pytree of client updates: each leaf has
a leading client dimension of size n.  Two paths compute the same math:

  * ``relay`` — the paper-faithful local consensus  Δx̃ = A · Δx.
  * ``fused_coefficients`` / ``fused_aggregate`` — relay and PS aggregation
    fused:  w Σ_r τ_r Δx̃_r = w Σ_o c_o Δx_o  with  c = τᵀA.  One weighted
    reduce instead of an n-way mix.

The relay matrix A comes from the host (``core.opt_alpha``, numpy) and is
moved to the buffer's device as f32.  The sparse ``EdgeRelay`` operand and
``segment_mix`` come with the sparse slice.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.utils import tree_map


def as_relay_operand(A, *, n: int, device) -> torch.Tensor | None:
    """A dense relay matrix as a float32 (n, n) tensor on ``device``."""
    if A is None:
        return None
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


def mask_relay_matrix(A, active) -> torch.Tensor:
    """Restrict A to the active block of a padded client dimension: zero
    every row and column of an inactive client (churn semantics — a departed
    client neither relays nor is relayed).  ``active`` is an (n,) 0/1
    vector, so membership can change per round."""
    A = _check_square(A).float()
    active = torch.as_tensor(active, dtype=torch.float32, device=A.device)
    return active[:, None] * A * active[None, :]


def fused_coefficients(A, tau) -> torch.Tensor:
    """c_o = Σ_r τ_r α_ro — the per-origin coefficient of the fused
    relay+aggregate path (c = τᵀ A)."""
    A = _check_square(A).float()
    tau = torch.as_tensor(tau, dtype=torch.float32, device=A.device)
    return tau @ A


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
