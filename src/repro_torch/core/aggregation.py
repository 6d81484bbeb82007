"""PS aggregation strategies (paper §II-D, Alg. 2, and the Fig. 2-4 baselines).

All strategies consume the per-client updates plus the round's τ mask, and
produce the *global model increment* that the server optimizer (plain step or
global momentum, paper Fig. 4) applies.

Strategies
----------
  colrel           w=1/n blind masked sum of *relayed* updates (eq. 2)
  colrel_fused     same update computed via the fused coefficients (optimized)
  fedavg_blind     w=1/n blind masked sum of *raw* updates (missing ⇒ zero)
  fedavg_nonblind  masked mean over the successful clients (PS knows ids)
  no_dropout       plain 1/n average, perfect connectivity upper bound

Client churn (padded client dimension)
--------------------------------------
Every increment function accepts an optional ``active`` mask: an (n,) 0/1
vector marking which of the ``n = n_max`` padded client slots are live this
round.  With a mask, the averaging weight renormalizes to 1/n_active, τ is
intersected with the mask, and (for the colrel strategies) the relay matrix
is restricted to the active block — so an inactive client contributes
*exactly zero* to the increment.  ``active=None`` is the full-membership
path with the python-float 1/n weight.

Flat-buffer hot path (``relay_backend``)
----------------------------------------
Every strategy works on the raveled ``(n, D)`` buffer
(``repro_torch.utils.stacked_ravel``).  ``backend`` dispatches the
(n,n)·(n,D) contraction: ``einsum`` is plain torch, ``hopper`` materializes
Δ̃ = A·Δ through the CUDA mix kernel, ``hopper_fused`` runs the
relay∘aggregate composition u = (w·τᵀA)·Δ as one fused-kernel pass, and
``segment`` consumes a sparse ``relay.EdgeRelay`` operand and contracts by
fixed-order segment sums — O(E) in the edge count, the n ≫ 10³ regime of
cohort sampling over sparse geometric graphs — before the same fused-kernel
reduce (``kernels/ops.py`` says why the kernel and not the plain chain).  The
pytree ``Aggregator.fn`` is a thin ravel → flat → unravel wrapper, so all
callers share one math definition.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core import relay as relay_lib
from repro_torch.kernels import ops as kernel_ops
from repro_torch.utils import (
    stacked_ravel,
    tree_axpy,
    tree_map,
    tree_scale,
    tree_unravel,
    tree_zeros_like,
)


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def active_weight(active, *, n: int):
    """The blind averaging weight: 1/n_active (a tensor) under a churn mask,
    the python float 1/n without one."""
    if active is None:
        return 1.0 / n
    active = torch.as_tensor(active, dtype=torch.float32)
    return 1.0 / torch.clamp(active.sum(), min=1.0)


# --------------------------------------------------------------------------
# Flat-buffer increments on the raveled (n, D) buffer, with the
# relay_backend dispatch to the CUDA kernels
# --------------------------------------------------------------------------


def colrel_increment_flat(A, tau, buf, *, n: int, fused: bool = True,
                          active=None, backend: str = "einsum"):
    """ColRel PS increment over the (n, D) buffer → (D,).

    ``fused=True`` (or ``backend='hopper_fused'``, which implies it) computes
    u = (w·τᵀA)·Δ without materializing the relayed updates; ``fused=False``
    materializes Δ̃ = A·Δ (paper-faithful protocol shape) then runs the blind
    masked sum w·Σ τ_r Δ̃_r.  Churn: inactive rows/cols of A are zeroed and
    τ intersected with the mask, so inactive slots contribute exactly zero.

    ``backend="segment"`` takes A as an :class:`~repro_torch.core.relay.EdgeRelay`
    (dense matrices are refused — the point is never materializing (n, n));
    the coefficient contraction τᵀA becomes an O(E) segment sum and the rest
    of the pipeline is unchanged.  Conversely the dense backends accept an
    EdgeRelay by densifying it — a small-n parity convenience.
    """
    kernel_ops.validate_backend(backend)
    if backend == "segment" and not isinstance(A, relay_lib.EdgeRelay):
        raise ValueError(
            "relay_backend='segment' needs an EdgeRelay operand (e.g. a "
            "sparse OPT-α policy / SparseOptAlphaResult.edge_relay()); "
            "got a dense relay matrix"
        )
    dev = buf.device
    A = relay_lib.as_relay_operand(A, n=buf.shape[0], backend=backend, device=dev)
    w = active_weight(None if active is None else _f32(active, dev), n=n)
    tau = _f32(tau, dev)
    if active is not None:
        a = _f32(active, dev)
        A = relay_lib.mask_relay_matrix(A, a)
        tau = tau * a
    if fused or backend == "hopper_fused":
        coeffs = w * relay_lib.fused_coefficients(A, tau)
        reduce_backend = "einsum" if backend == "einsum" else "hopper_fused"
        return kernel_ops.reduce_flat(coeffs, buf, backend=reduce_backend)
    mixed = kernel_ops.mix_flat(A, buf, backend=backend)
    return kernel_ops.reduce_flat(w * tau, mixed, backend="einsum")


def fedavg_blind_increment_flat(tau, buf, *, n: int, active=None,
                                backend: str = "einsum"):
    dev = buf.device
    w = active_weight(None if active is None else _f32(active, dev), n=n)
    tau = _f32(tau, dev)
    if active is not None:
        tau = tau * _f32(active, dev)
    return _coeff_reduce(w * tau, buf, backend)


def fedavg_nonblind_increment_flat(tau, buf, *, active=None,
                                   backend: str = "einsum"):
    dev = buf.device
    tau = _f32(tau, dev)
    if active is not None:
        tau = tau * _f32(active, dev)
    coeffs = tau / torch.clamp(tau.sum(), min=1.0)
    return _coeff_reduce(coeffs, buf, backend)


def no_dropout_increment_flat(buf, *, n: int, active=None,
                              backend: str = "einsum"):
    dev = buf.device
    if active is None:
        coeffs = torch.full((n,), 1.0 / n, dtype=torch.float32, device=dev)
    else:
        a = _f32(active, dev)
        coeffs = a / torch.clamp(a.sum(), min=1.0)
    return _coeff_reduce(coeffs, buf, backend)


def _coeff_reduce(coeffs, buf, backend):
    # non-colrel strategies are already a single weighted reduce with dense
    # (n,) coefficients: the kernel backends and "segment" (nothing sparse
    # left to exploit) collapse to the fused-reduction kernel — so an
    # all-inactive cohort stays the exact-zero coefficient vector on every
    # backend rather than tripping a sparse path with no edges
    kernel_ops.validate_backend(backend)
    reduce_backend = "einsum" if backend == "einsum" else "hopper_fused"
    return kernel_ops.reduce_flat(coeffs, buf, backend=reduce_backend)


@dataclasses.dataclass(frozen=True)
class Aggregator:
    """Bundles a strategy name with its increment functions.

    ``flat_fn(tau, buf, A=None, active=None) -> (D,)`` is the raveled hot
    path; ``fn(tau, stacked_updates, A=None, active=None)`` ravels the
    stacked updates to the ``(n, D)`` buffer, runs ``flat_fn`` and unravels
    the result (leaves stay f32 — the server optimizer owns the cast back to
    the parameter dtype).

    For the colrel strategies A is a per-call input, so a time-varying
    channel can swap relay matrices between rounds; when omitted, the matrix
    bound at construction is used.
    """

    name: str
    fn: Callable  # (tau, stacked_updates, A=None, active=None) -> increment
    flat_fn: Callable  # (tau, buf, A=None, active=None) -> (D,) increment
    relay_backend: str = "einsum"


def make_aggregator(strategy: str, *, n: int, A=None,
                    relay_backend: str = "einsum") -> Aggregator:
    """``relay_backend`` ∈ ``repro_torch.kernels.ops.RELAY_BACKENDS`` picks
    plain torch or a CUDA kernel for the (n,n)·(n,D) contraction."""
    kernel_ops.validate_backend(relay_backend)
    default_A = A
    kw = dict(backend=relay_backend)

    def _resolve(A_arg):
        A_eff = default_A if A_arg is None else A_arg
        if A_eff is None:
            raise ValueError("colrel aggregation needs a relay matrix A "
                             "(bind one at construction or pass it per call)")
        return A_eff

    if strategy == "colrel":
        def flat_fn(tau, buf, A=None, active=None):
            return colrel_increment_flat(
                _resolve(A), tau, buf, n=n, fused=False, active=active, **kw)
    elif strategy == "colrel_fused":
        def flat_fn(tau, buf, A=None, active=None):
            return colrel_increment_flat(
                _resolve(A), tau, buf, n=n, fused=True, active=active, **kw)
    elif strategy == "fedavg_blind":
        def flat_fn(tau, buf, A=None, active=None):
            return fedavg_blind_increment_flat(
                tau, buf, n=n, active=active, **kw)
    elif strategy == "fedavg_nonblind":
        def flat_fn(tau, buf, A=None, active=None):
            return fedavg_nonblind_increment_flat(
                tau, buf, active=active, **kw)
    elif strategy == "no_dropout":
        def flat_fn(tau, buf, A=None, active=None):
            return no_dropout_increment_flat(buf, n=n, active=active, **kw)
    else:
        raise ValueError(f"unknown aggregation strategy: {strategy!r}")

    def fn(tau, upd, A=None, active=None):
        buf, spec = stacked_ravel(upd)
        return tree_unravel(spec, flat_fn(tau, buf, A, active), cast=False)

    return Aggregator(strategy, fn, flat_fn, relay_backend)


# --------------------------------------------------------------------------
# Server optimizer (paper Fig. 4 uses global momentum at the PS)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ServerOpt:
    """x ← x + lr · (m ← γ m + increment).  γ=0, lr=1 is plain Alg. 2."""

    momentum: float = 0.0
    lr: float = 1.0

    def init(self, params):
        if self.momentum == 0.0:
            return None
        return tree_zeros_like(params)

    def apply(self, params, state, increment):
        def upd(p, inc):
            return (p.float() + self.lr * inc).to(p.dtype)

        if self.momentum == 0.0:
            return tree_map(upd, params, increment), None
        new_state = tree_axpy(1.0, increment, tree_scale(self.momentum, state))
        new_params = tree_map(upd, params, new_state)
        return new_params, new_state
