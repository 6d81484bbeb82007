"""Plain f32 torch versions of the relay kernels: the ``einsum`` backend, the
CPU path of the kernel wrappers, and the yardstick the CUDA kernels are held
against on the card."""
from __future__ import annotations

import torch


def relay_mix_2d(A: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Δ̃ = A·Δ, summed in f32, returned in Δ's dtype."""
    return (A.float() @ delta.float()).to(delta.dtype)


def fused_aggregate_2d(coeffs: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """u = c·Δ → (D,), summed in f32, returned in Δ's dtype."""
    return (coeffs.float() @ delta.float()).to(delta.dtype)
