"""Plain f32 torch versions of the relay kernels: the ``einsum`` backend, the
CPU path of the kernel wrappers, and the yardstick the CUDA kernels are held
against on the card.

Both sum the origins in ascending order, one multiply-add (``addcmul``) an
origin from zero, which is the order of the CUDA kernels' ``fmaf`` chains; on
the GPU ``addcmul`` is fused, so the two agree bit for bit.  A library
product (``A @ Δ``) leaves the order to cuBLAS, which picks it by shape: on
an H100 it differs from the kernels' by an ulp at some client counts, and a
ResNet-20 run at lr 0.05 amplifies that ulp past the harness's 1e-5 kernel
check within 24 rounds (``tools/backend_divergence.py`` shows it)."""
from __future__ import annotations

import torch

from repro_torch.utils import tree_map


def relay_mix_2d(A: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Δ̃ = A·Δ, summed in f32 over the origins in ascending order, returned
    in Δ's dtype."""
    A, d = A.float(), delta.float()
    out = d.new_zeros((A.shape[0],) + d.shape[1:])
    for j in range(d.shape[0]):
        out = torch.addcmul(out, A[:, j, None], d[j])
    return out.to(delta.dtype)


def fused_aggregate_2d(coeffs: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """u = c·Δ → (D,), summed in f32 over the origins in ascending order,
    returned in Δ's dtype."""
    c, d = coeffs.float(), delta.float()
    out = d.new_zeros(d.shape[1:])
    for j in range(d.shape[0]):
        out = torch.addcmul(out, c[j], d[j])
    return out.to(delta.dtype)


def relay_mix_pytree(A, stacked):
    """Δ̃ = A·Δ on every leaf of a stacked pytree (leaves (n, ...)): each leaf
    through :func:`relay_mix_2d` on its (n, prod(rest)) view, so in the same
    order, returned in the leaf's dtype."""

    def mix(leaf):
        A_l = torch.as_tensor(A, dtype=torch.float32, device=leaf.device)
        out = relay_mix_2d(A_l, leaf.reshape(leaf.shape[0], -1))
        return out.reshape((A_l.shape[0],) + tuple(leaf.shape[1:]))

    return tree_map(mix, stacked)
