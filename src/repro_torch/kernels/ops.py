"""Backend dispatch for the relay contraction on the raveled ``(n, D)``
buffer, and pytree wrappers over the kernels.

The ``relay_backend`` knob (``make_aggregator``, ``FLSimulator``):

  einsum        plain torch (``kernels/ref.py``) on the flat buffer
  hopper        CUDA kernel mix Δ̃ = A·Δ; the PS reduction after it stays the
                plain reduction
  hopper_fused  CUDA kernel u = (w·τᵀA)·Δ — relay∘aggregate in one pass,
                writing D values instead of n·D
  segment       sparse edge-list path (``core.relay.EdgeRelay`` and its
                fixed-order segment sums): relay∘aggregate cost scales with
                the edge count E, not n² — the n ≫ 10³ cohort-sampling regime

The JAX package's ``pallas``/``pallas_fused`` are ``hopper``/``hopper_fused``
here.  Its ``block_d`` and ``interpret`` knobs are gone: they tile the TPU's
vector memory and run Pallas on a CPU, and the CUDA kernels pick their own
tiles and mask the ragged tail of D.

One deliberate difference from the JAX package: the dense (n,) reduce that
follows ``segment``'s sparse coefficients goes to the fused-aggregate kernel
(``hopper_fused``), where the JAX package sends it to its einsum.  The
port's plain reduce is a chain of n ``addcmul``s (``kernels/ref.py``), which
at n = 10⁴ would be 10⁴ launches a round on the hot path; the kernel is the
same function with the same summation order (bit for bit equal to the chain
on the card), and on a CPU buffer the wrapper runs that chain.
"""
from __future__ import annotations

import torch

from repro_torch.core import relay as relay_lib
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import relay_mix as _k
from repro_torch.utils import tree_map

RELAY_BACKENDS = ("einsum", "hopper", "hopper_fused", "segment")


def validate_backend(backend: str) -> str:
    if backend not in RELAY_BACKENDS:
        raise ValueError(f"unknown relay_backend {backend!r} (known: {RELAY_BACKENDS})")
    return backend


def validate_sharded_backend(backend: str, *, shard: str, exchange: str = "gather") -> str:
    """Backend dispatch under sharding (``build_sharded_scan_round_step``):

    * ``shard="d"``: every rank contracts its column slice of the (n, D)
      buffer and the slices are gathered — the plain contraction only.
    * ``exchange="ring"``: the ring collective *replaces* the relay
      contraction (k−1 send/recv rotations + all_reduce), so a kernel
      backend would be silently ignored — einsum only, by refusal rather
      than surprise.
    * ``exchange="gather"``: the gathered (n, D) buffer is whole on every
      rank, so any dense backend (both CUDA kernels) runs unchanged.
    * ``segment`` is refused under every sharding mode: the sharded step
      builders take a dense (n, n) operand.
    """
    validate_backend(backend)
    if backend == "segment":
        raise ValueError(
            "relay_backend='segment' is single-host only — the sharded "
            "round-step builders need a dense relay operand; use "
            "relay_backend='einsum' (or a hopper backend with "
            "exchange='gather')"
        )
    if shard == "d" and backend != "einsum":
        raise ValueError(
            "D-axis sharding contracts each rank's column slice of the buffer "
            "with the plain product; the CUDA kernels are not wired for "
            "slices — use relay_backend='einsum'"
        )
    if shard == "clients" and exchange == "ring" and backend != "einsum":
        raise ValueError(
            "exchange='ring' replaces the relay contraction with send/recv "
            "rotations; relay_backend must be 'einsum' (the kernel would "
            "never run)"
        )
    return backend


def _mask_A(A, active, device) -> torch.Tensor:
    """Restrict A to the active block of a padded client dim (client churn);
    the mask folds into the operand, the kernel itself is unchanged."""
    A = torch.as_tensor(A, dtype=torch.float32, device=device)
    if active is None:
        return A
    return relay_lib.mask_relay_matrix(A, active)


def relay_mix(A, stacked, *, active=None):
    """Δ̃ = A·Δ over a stacked pytree (leaves (n, ...)) through the mix
    kernel.  ``active`` is the optional churn mask: inactive rows/cols of A
    are zeroed, so a departed client's slot neither relays nor is relayed."""

    def mix(leaf):
        A_m = _mask_A(A, active, leaf.device)
        flat = leaf.reshape(A_m.shape[0], -1)
        return _k.relay_mix_2d(A_m, flat).reshape(leaf.shape)

    return tree_map(mix, stacked)


def fused_aggregate(A, tau, stacked, *, w, active=None):
    """w · Σ_r τ_r (A·Δ)_r through the fused kernel, without materializing
    the relayed updates.  ``w`` may be a python float (fixed membership) or a
    tensor (1/n_active under churn); ``active`` masks A and τ."""

    def reduce(leaf):
        A_m = _mask_A(A, active, leaf.device)
        t = torch.as_tensor(tau, dtype=torch.float32, device=leaf.device)
        if active is not None:
            t = t * torch.as_tensor(active, dtype=torch.float32, device=leaf.device)
        coeffs = (w * (t @ A_m)).contiguous()
        flat = leaf.reshape(A_m.shape[0], -1)
        return _k.fused_aggregate_2d(coeffs, flat).reshape(leaf.shape[1:])

    return tree_map(reduce, stacked)


# --------------------------------------------------------------------------
# Flat-buffer dispatch: the (n, D) raveled hot path (utils.stacked_ravel)
# --------------------------------------------------------------------------


def mix_flat(A, buf: torch.Tensor, *, active=None, backend: str = "einsum"):
    """Δ̃ = A·Δ on the contiguous (n, D) buffer.  ``backend`` picks the plain
    torch product, the CUDA mix kernel, or the sparse segment sums
    (``backend="segment"``, which needs an :class:`~repro_torch.core.relay.EdgeRelay`
    operand; the dense backends densify one); ``active`` is the churn mask
    (zeroes inactive rows/cols of A — or the touching edge values — before
    dispatch, on every backend)."""
    validate_backend(backend)
    if backend == "segment":
        if not isinstance(A, relay_lib.EdgeRelay):
            raise ValueError(
                "relay_backend='segment' needs an EdgeRelay operand "
                "(a sparse OPT-α policy); got a dense relay matrix — "
                "use relay_backend='einsum' or convert via "
                "relay.edge_relay_from_dense"
            )
        if active is not None:
            A = relay_lib.mask_relay_matrix(A, active)
        return relay_lib.segment_mix(A, buf)
    if isinstance(A, relay_lib.EdgeRelay):
        A = relay_lib.as_relay_operand(A, n=buf.shape[0], backend=backend,
                                       device=buf.device)
    A = _mask_A(A, active, buf.device)
    if backend == "einsum":
        return _ref.relay_mix_2d(A, buf)
    return _k.relay_mix_2d(A.contiguous(), buf)


def reduce_flat(coeffs, buf: torch.Tensor, *, backend: str = "einsum"):
    """u = coeffs·Δ on the (n, D) buffer → (D,).  ``coeffs`` already carries
    every weighting (w·τᵀA for the fused colrel path, w·τ for the blind
    sum, ...), so churn masking happens in the caller's coefficients.
    Every backend but ``einsum`` runs the fused-aggregate kernel: ``segment``
    lands here with a dense (n,) coefficient vector — the sparsity was spent
    computing it (see the module docstring)."""
    validate_backend(backend)
    coeffs = torch.as_tensor(coeffs, dtype=torch.float32, device=buf.device)
    if backend == "einsum":
        return _ref.fused_aggregate_2d(coeffs, buf)
    return _k.fused_aggregate_2d(coeffs.contiguous(), buf)
