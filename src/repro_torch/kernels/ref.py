"""Plain f32 torch versions of the relay kernels: the ``einsum`` backend, the
CPU path of the kernel wrappers, and the yardstick the CUDA kernels are held
against on the card.

Both sum the origins in ascending order, one multiply-add (``addcmul``) an
origin from zero, which is the order of the CUDA kernels' ``fmaf`` chains; on
the GPU ``addcmul`` is fused, so the two agree bit for bit.  The fused
reduction at many clients and a small D splits the origins into
:func:`fused_splits` ranges, each one such chain, and adds the ranges'
partials in ascending order, as its kernel does.  A library
product (``A @ Δ``) leaves the order to cuBLAS, which picks it by shape: on
an H100 it differs from the kernels' by an ulp at some client counts, and a
ResNet-20 run at lr 0.05 amplifies that ulp past the harness's 1e-5 kernel
check within 24 rounds (``tools/backend_divergence.py`` shows it)."""
from __future__ import annotations

import math

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


# The fused reduction's order is a function of (n, D) alone, so neither the
# card, the dtype nor Δ's alignment changes its bits.  Up to 128 clients, or
# once D alone gives the kernel enough column tiles, it is one chain; beyond,
# ranges of at most FUSED_RANGE origins (the kernel's blocks: column tiles
# × ranges).  FUSED_RANGE was chosen with tools/time_fused_aggregate.py
# (NVIDIA H100 80GB HBM3, 700 W; f32 µs at n = 256 / 1,000 / 1,025 / 10⁴,
# D = 698, with 4 warps a block): 64 took 4.31 / 5.50 / 5.12 / 18.13, 32 took
# 3.86 / 5.10 / 5.38 / 23.21 (twice the partials to add at 10⁴); 128, with
# one warp a block, was 6–13% slower at every n ≤ 1,025 (fewer blocks than
# SMs) and 5% faster at 10⁴.
FUSED_SPLIT_MIN_N = 128
FUSED_SPLIT_MAX_D = 131_072
FUSED_RANGE = 64


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def fused_splits(n: int, D: int) -> int:
    """S, the origin ranges of u = c·Δ for Δ of shape (n, D): range s holds
    origins [s·⌈n/S⌉, min(n, (s+1)·⌈n/S⌉)), each non-empty and at most
    :data:`FUSED_RANGE` long; 1 for n ≤ 128 or D ≥ 131,072."""
    if n <= FUSED_SPLIT_MIN_N or D >= FUSED_SPLIT_MAX_D:
        return 1
    return _cdiv(n, _cdiv(n, _cdiv(n, FUSED_RANGE)))


def _chain(c: torch.Tensor, d: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    out = d.new_zeros(d.shape[1:])
    for j in range(lo, hi):
        out = torch.addcmul(out, c[j], d[j])
    return out


def fused_aggregate_2d(coeffs: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """u = c·Δ → (D,) in f32, returned in Δ's dtype: with S =
    :func:`fused_splits` ranges, each range summed over its origins in
    ascending order and the S partials added in ascending order (S = 1: one
    chain over all origins)."""
    c, d = coeffs.float(), delta.float()
    n = d.shape[0]
    splits = fused_splits(n, math.prod(d.shape[1:]))
    if splits == 1:
        return _chain(c, d, 0, n).to(delta.dtype)
    size = _cdiv(n, splits)
    out = d.new_zeros(d.shape[1:])
    for lo in range(0, n, size):
        out = out + _chain(c, d, lo, min(n, lo + size))
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
