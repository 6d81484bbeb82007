"""Single-host FL simulator (paper-scale: n≈10 clients, small models).

Implements Algs. 1 + 2 literally: per round —
  broadcast x^(r) → T local SGD steps per client (vmap over clients) →
  D2D relay Δx̃ = A·Δx → Bernoulli τ mask → blind PS aggregation → server opt.

The PyTorch counterpart of the JAX package's ``fl/simulator.py``.  It runs
eagerly: the local steps are ``torch.func.vmap`` of ``grad`` over the
clients in a Python loop over the T steps, and the aggregation goes through
the ``relay_backend`` dispatch (plain torch or the CUDA kernels).
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.core import aggregation
from repro_torch.core import relay as relay_lib
from repro_torch.core.aggregation import ServerOpt
from repro_torch.optim.sgd import ClientOpt
from repro_torch.utils import (
    resolve_device,
    stacked_ravel,
    tree_flatten,
    tree_map,
    tree_sub,
    tree_unflatten,
    tree_unravel,
)


def local_updates(grad_fn, client_opt: ClientOpt, params, batch, lr, steps: int):
    """``steps`` local SGD steps of every client from the broadcast
    ``params``: the stacked per-client deltas (leaves (n, ...)) and each
    client's loss at its first step.  ``grad_fn`` is
    ``torch.func.vmap(torch.func.grad_and_value(loss_fn))`` (or
    :func:`client_grad_fn`'s); ``batch`` has leaves (n, steps, b, ...), n
    the clients this call runs (all of them, or one rank's block in the
    sharded step).  Where the gradient's value is ``(loss, counters)`` (a
    loss with counters), the second result is ``(first loss, counters
    summed over the steps)``, each counter (n,)."""
    n = tree_flatten(batch)[0][0].shape[0]
    start = tree_map(lambda x: x.unsqueeze(0).expand(n, *x.shape), params)
    p, s = start, client_opt.init(start)
    first_loss, counters = None, None
    for t in range(steps):
        minibatch = tree_map(lambda x: x[:, t], batch)
        grads, loss = grad_fn(p, minibatch)
        if isinstance(loss, tuple):
            loss, c = loss
            counters = c if counters is None else tree_map(torch.add, counters, c)
        p, s = client_opt.step(p, grads, s, lr)
        if first_loss is None:
            first_loss = loss
    return tree_sub(p, start), (first_loss if counters is None else (first_loss, counters))


def client_grad_fn(loss_fn):
    """Every client's ``(grads, value)`` of ``loss_fn`` at once, the
    clients stacked on a leading dim of the parameters, the batch and the
    results: ``torch.func.vmap(torch.func.grad_and_value(loss_fn))``.  A
    loss whose ``clients_in_turn`` attribute is true runs the clients one
    after another through plain autograd instead (:func:`_grads_in_turn`);
    such a loss may return ``(loss, counters)``, and the value is then
    ``(losses, counters)``, each stacked over the clients."""
    if takes_clients_in_turn(loss_fn):
        return _grads_in_turn(loss_fn)
    return torch.func.vmap(torch.func.grad_and_value(loss_fn))


def takes_clients_in_turn(loss_fn) -> bool:
    """Whether ``loss_fn`` asks for its clients' gradients one at a time
    (:func:`client_grad_fn`)."""
    return getattr(loss_fn, "clients_in_turn", False)


def refuse_clients_in_turn(loss_fn, engine: str) -> None:
    """Raise for a loss that takes its clients in turn: ``engine`` vmaps
    the loss itself and reads a scalar value, so only :class:`FLSimulator`
    and the engines over its ``round_math`` run such a loss."""
    if takes_clients_in_turn(loss_fn):
        raise ValueError(f"{engine} vmaps the loss and reads a scalar: a loss that takes "
                         "its clients in turn and returns (loss, counters) runs only "
                         "through FLSimulator.run_round/round_math and their engines")


def _grads_in_turn(loss_fn):
    """The clients' ``(grads, value)`` one client at a time, each from
    ``torch.autograd.grad`` of its own loss, written into the stacked
    gradients.  ``torch.func.grad`` takes its gradient with
    ``create_graph=True``, so under it every intermediate gradient of the
    backward is kept until the backward ends; for a model whose activations
    fill the card (DeepSeek-V2-Lite's stage at 4,096 tokens on an H100: 22.7
    GB a client and step against 4.8 GB of saved activations) that leaves
    room for one client's backward, not n.  Here one client's activations are
    alive at a time and nothing of a backward is kept."""

    def grad_fn(params, batch):
        leaves, treedef = tree_flatten(params)
        n = tree_flatten(batch)[0][0].shape[0]
        grads = [torch.empty(x.shape, dtype=x.dtype, device=x.device) for x in leaves]
        values, auxes = [], []
        for i in range(n):
            mine = [x[i].detach().requires_grad_() for x in leaves]
            with torch.enable_grad():
                out = loss_fn(tree_unflatten(treedef, mine), tree_map(lambda b: b[i], batch))
                loss, aux = out if isinstance(out, tuple) else (out, None)
                for dst, g in zip(grads, torch.autograd.grad(loss, mine), strict=True):
                    dst[i].copy_(g)
            values.append(loss.detach())
            auxes.append(aux)
        value = torch.stack(values)
        if auxes[0] is not None:
            value = (value, tree_map(lambda *xs: torch.stack(xs), *auxes))
        return tree_unflatten(treedef, grads), value

    return grad_fn


def _metrics(loss, tau, delta_norm, counters=None):
    m = {"loss": loss, "tau": tau, "delta_norm": delta_norm}
    if counters is not None:
        m["counters"] = counters
    return m


class FLSimulator:
    """strategy ∈ {colrel, colrel_fused, fedavg_blind, fedavg_nonblind,
    no_dropout}; A is required for the colrel strategies.

    ``loss_fn(params, batch) -> scalar`` is a pure function of a parameter
    dict and one client's minibatch; it must be traceable by ``torch.func``.
    The clients' gradients come from :func:`client_grad_fn`; a loss that
    takes its clients in turn may return ``(scalar, counters)``, counters a
    dict of integer tensors (the DeepSeek-V2 stack's MoE counts), and each
    round's metrics then carry them under ``"counters"``, summed over the
    steps and the (live) clients.

    The relay matrix A, the connectivity vector p and the churn mask
    ``active`` are *round inputs*: ``run_round`` takes fresh values every
    round.  The values given at construction are only defaults.

    Client churn: ``n_clients`` is the *padded* client dimension ``n_max``.
    With ``run_round(..., active=mask)`` inactive slots still compute a local
    update (fixed shapes) but contribute exactly zero to the PS increment and
    are excluded from the metrics; the blind weight renormalizes to
    1/n_active.

    ``relay_backend`` ∈ {einsum, hopper, hopper_fused, segment} picks the
    engine for the relay∘aggregate contraction over the raveled ``(n, D)``
    delta buffer; ``segment`` takes the sparse
    :class:`~repro_torch.core.relay.EdgeRelay` operands of
    ``channels.SparseOptAlpha`` (the dense backends densify one).

    ``device`` defaults to the GPU, and construction raises when there is
    none; pass ``device="cpu"`` to run on the CPU.
    """

    def __init__(
        self,
        loss_fn: Callable[[Any, dict], torch.Tensor],
        *,
        n_clients: int,
        strategy: str = "colrel",
        A=None,
        p=None,
        local_steps: int = 8,
        client_opt: ClientOpt = ClientOpt(kind="sgd", weight_decay=1e-4),
        server_opt: ServerOpt = ServerOpt(),
        relay_backend: str = "einsum",
        device=None,
    ):
        self.device = resolve_device(device)
        self.loss_fn = loss_fn
        self.n = n_clients
        self.T = local_steps
        self.client_opt = client_opt
        self.server_opt = server_opt
        self.strategy = strategy
        self.relay_backend = relay_backend
        self.p = (
            torch.as_tensor(p, dtype=torch.float32, device=self.device)
            if p is not None
            else torch.ones((n_clients,), device=self.device)
        )
        self.A = relay_lib.as_relay_operand(
            A, n=n_clients, backend=relay_backend, device=self.device
        )
        self.aggregator = aggregation.make_aggregator(
            strategy, n=n_clients, relay_backend=relay_backend
        )
        self._grad_fn = client_grad_fn(loss_fn)

    def _to_device(self, tree):
        return tree_map(lambda x: torch.as_tensor(x, device=self.device), tree)

    # -- all clients: T local SGD steps from the broadcast global model ----
    def _client_updates(self, params, batch, lr):
        """Stacked per-client deltas (leaves (n, ...)) and each client's loss
        at its first local step."""
        return local_updates(self._grad_fn, self.client_opt, params, batch, lr, self.T)

    def round_math(self, params, server_state, batch, tau, A, lr, active):
        """One round on given τ: the counterpart of the JAX package's
        ``FLSimulator._round_math``."""
        deltas, losses = self._client_updates(params, batch, lr)
        losses, counters = losses if isinstance(losses, tuple) else (losses, None)
        # ravel the stacked deltas once: the aggregation hot spot (and the
        # kernel backends behind it) see one contiguous (n, D) buffer, while
        # the clients above ran on the structured view
        buf, spec = stacked_ravel(deltas)
        flat_inc = self.aggregator.flat_fn(tau, buf, A, active)
        increment = tree_unravel(spec, flat_inc, cast=False)
        new_params, new_state = self.server_opt.apply(params, server_state, increment)

        per_client_dn = (buf * buf).sum(dim=1)
        if active is None:
            mean_loss, dn = losses.mean(), per_client_dn.mean()
        else:
            # churn: metrics average over the live clients only (a padded
            # slot's local run is dead compute and must not skew them)
            denom = torch.clamp(active.sum(), min=1.0)
            mean_loss = (losses * active).sum() / denom
            dn = (per_client_dn * active).sum() / denom
            tau = tau * active
            if counters is not None:
                counters = tree_map(lambda c: c * (active > 0), counters)
        if counters is not None:
            counters = tree_map(lambda c: c.sum(), counters)
        return new_params, new_state, _metrics(mean_loss, tau, torch.sqrt(dn), counters)

    def run_round(
        self, generator, params, server_state, batch, lr, *, A=None, p=None,
        active=None, tau=None,
    ):
        """batch: pytree with leaves (n, T, b, ...) (numpy or tensors).

        τ is drawn from ``generator`` (a :class:`torch.Generator` on the
        simulator's device) with the round's p; pass ``tau=`` to hand one
        over instead (the cross-package tests do, since torch cannot draw
        JAX's numbers).  ``A`` / ``p`` override the construction-time
        channel for this round; ``active`` is the churn mask.
        """
        if tau is None:
            tau = self.sample_tau(generator, p)
        tau = torch.as_tensor(tau, dtype=torch.float32, device=self.device)
        A_round = (
            self.A if A is None
            else relay_lib.as_relay_operand(
                A, n=self.n, backend=self.relay_backend, device=self.device
            )
        )
        active_round = (
            None if active is None
            else torch.as_tensor(active, dtype=torch.float32, device=self.device)
        )
        return self.round_math(
            params, server_state, self._to_device(batch), tau, A_round, lr,
            active_round,
        )

    def sample_tau(self, generator: torch.Generator, p=None) -> torch.Tensor:
        """One round's uplink mask, exactly as ``run_round`` draws it."""
        p_round = (
            self.p if p is None
            else torch.as_tensor(p, dtype=torch.float32, device=self.device)
        )
        tau = torch.bernoulli(p_round, generator=generator)
        if self.strategy == "no_dropout":
            tau = torch.ones_like(tau)
        return tau

    def init_server_state(self, params):
        return self.server_opt.init(params)
