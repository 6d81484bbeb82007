"""Distributed ColRel round steps: the per-round step, the epoch steps and
the rank-sharded step.

The PyTorch counterpart of the JAX package's ``fl/distributed.py``.  Batches
arrive stacked (n_clients, T, local_batch, ...).  Two relay schedules
compute the identical PS update:

  * ``faithful``: per-client Δx materialized, local consensus Δx̃ = A·Δx,
    then the blind masked PS sum.  Mirrors the paper's physical protocol.
  * ``fused``: PS ∘ relay fused to one weighted reduce with c = τᵀA.  With
    T = 1 the weighted per-client gradient sum is formed directly, so no
    per-client full-parameter tensor ever exists.

τ is given per round to :func:`build_round_step` and
:func:`build_scan_round_step` — the step itself is deterministic and
identity-blind.  :func:`build_fused_scan_round_step` (the pipelined
engine's counterpart) takes a ``torch.Generator`` instead and draws each
round's τ = Bernoulli(p) from it in round order, the same calls as the
simulator's ``sample_tau``, so its τ stream and the advanced generator equal
R host draws bit for bit.

:func:`build_sharded_scan_round_step` is the **multi-rank** path (same
signature as the fused scan step), SPMD over the ranks of a
:class:`repro_torch.launch.mesh.Mesh`: every rank calls it with the same
arguments and gets the same result.  Under ``shard="clients"`` each rank owns
m = n/k client slots and runs only their local SGD; the relay exchange is
either an ``all_gather`` of the raveled delta blocks (then the dense
contraction, both CUDA kernels included: bitwise equal to the one-rank
step) or the block ring of `repro_torch.fl.ring` (f32-tolerance equal).
Under ``shard="d"`` every rank runs every client and contracts only its
column slice of the (n, D) buffer, then the slices are gathered.

The JAX package's ``block_d`` and ``interpret`` knobs are not here: they
tile the TPU's vector memory and run Pallas on a CPU (``kernels/ops.py``).
The steps run eagerly on the device of the parameters they are given.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.core import aggregation
from repro_torch.core import relay as relay_lib
from repro_torch.core.aggregation import ServerOpt, active_weight
from repro_torch.fl import ring as ring_lib
from repro_torch.fl.simulator import local_updates, refuse_clients_in_turn
from repro_torch.kernels import ops as kernel_ops
from repro_torch.optim.sgd import ClientOpt
from repro_torch.sharding import rules as sharding_rules
from repro_torch.utils import stacked_ravel, tree_flatten, tree_map, tree_scale, tree_unravel


def _device(params) -> torch.device:
    return tree_flatten(params)[0][0].device


def _f32(x, device):
    return None if x is None else torch.as_tensor(x, dtype=torch.float32, device=device)


def _mean_loss(losses, active):
    if active is None:
        return losses.mean()
    return (losses * active).sum() / torch.clamp(active.sum(), min=1.0)


def _rounds(batches) -> int:
    return tree_flatten(batches)[0][0].shape[0]


def _decayed_grads(shared_grad_fn, client_opt: ClientOpt, params, batch):
    """T = 1, every client at the shared ``params``: the decayed gradients
    g + wd·x (leaves (n, ...)) and the losses (n,); ``batch`` leaves
    (n, 1, b, ...)."""
    sq = tree_map(lambda x: x[:, 0], batch)
    grads, losses = shared_grad_fn(params, sq)
    wd = client_opt.weight_decay
    return tree_map(lambda g, p: g.float() + wd * p.float(), grads, params), losses


def build_round_step(
    loss_fn: Callable[[Any, dict], torch.Tensor],
    *,
    n_clients: int,
    local_steps: int,
    A=None,
    relay_mode: str = "faithful",
    relay_backend: str = "einsum",
    client_opt: ClientOpt = ClientOpt(kind="sgd", weight_decay=1e-4),
    server_opt: ServerOpt = ServerOpt(),
    constrain_buffer: Callable | None = None,
):
    """Returns round(params, server_state, batch, tau, lr, A=None, active=None)
    -> (params', state', loss).

    batch leaves: (n_clients, local_steps, per_client_batch, ...), numpy or
    tensors; they go to the parameters' device.

    The relay matrix may be bound at build time (static channel) or passed
    per call (time-varying channel); the call-time A wins when both are
    given.  ``active`` is the churn mask over the padded client dimension
    (``n_clients = n_max``): an (n,) 0/1 vector restricting the relay
    matrix, τ and the blind weight (1/n_active) to the live clients.

    ``relay_backend`` dispatches the relay∘aggregate contraction over the
    raveled (n, D) delta buffer to the CUDA kernels (see
    ``repro_torch.core.aggregation.colrel_increment_flat``).  It applies
    wherever per-client deltas are materialized — every path except T = 1
    fused, whose weighted-loss trick never forms an (n, D) tensor, so that
    path launches no kernel.

    ``constrain_buffer(buf, contract) -> (D,)`` wraps the contraction of
    the raveled (n, D) buffer (``contract(buf)`` is the whole one):
    `build_sharded_scan_round_step(shard="d")` passes one that contracts
    this rank's column slice and gathers the slices.
    """
    kernel_ops.validate_backend(relay_backend)
    refuse_clients_in_turn(loss_fn, "build_round_step")
    T = local_steps
    A_static = A
    fused = relay_mode == "fused"
    grad_fn = torch.func.vmap(torch.func.grad_and_value(loss_fn))
    shared_grad_fn = torch.func.vmap(torch.func.grad_and_value(loss_fn), in_dims=(None, 0))
    shared_loss_fn = torch.func.vmap(loss_fn, in_dims=(None, 0))

    def round(params, server_state, batch, tau, lr, A=None, active=None):
        A = A_static if A is None else A
        if A is None:
            raise ValueError("no relay matrix: bind A at build time or pass it")
        dev = _device(params)
        A = relay_lib.as_relay_operand(A, n=n_clients, backend=relay_backend, device=dev)
        tau, active = _f32(tau, dev), _f32(active, dev)
        batch = tree_map(lambda x: torch.as_tensor(x, device=dev), batch)

        def contract(buf):
            return aggregation.colrel_increment_flat(
                A, tau, buf, n=n_clients, fused=fused, active=active,
                backend=relay_backend,
            )

        def flat_increment(deltas):
            # ravel → kernel-dispatched increment → structured f32 view;
            # churn masking (A, τ, 1/n_active) happens inside the flat fn
            buf, spec = stacked_ravel(deltas)
            flat = contract(buf) if constrain_buffer is None else constrain_buffer(buf, contract)
            return tree_unravel(spec, flat, cast=False)

        if T == 1 and fused:
            # never materialize per-client deltas: weighted loss trick —
            # Σ_o c_o Δ_o = -lr · ∇ Σ_o c_o L_o(x)  (+ wd term)
            w = active_weight(active, n=n_clients)
            A_f, tau_f = A, tau
            if active is not None:
                A_f = relay_lib.mask_relay_matrix(A, active)
                tau_f = tau * active
            c = relay_lib.fused_coefficients(A_f, tau_f)  # (n,)
            sq = tree_map(lambda x: x[:, 0], batch)

            def weighted_loss(p):
                losses = shared_loss_fn(p, sq)
                return torch.sum(c * losses), losses

            gsum, losses = torch.func.grad(weighted_loss, has_aux=True)(params)
            csum = torch.sum(c)
            wd = client_opt.weight_decay
            inc = tree_map(
                lambda gs, pe: -lr * w * (gs.float() + csum * wd * pe.float()),
                gsum, params,
            )
        elif T == 1:
            # deltas_g: stacked decayed grads (n, ...); Δ_i = -lr · g_i
            deltas_g, losses = _decayed_grads(shared_grad_fn, client_opt, params, batch)
            inc = flat_increment(tree_scale(-lr, deltas_g))
        else:
            deltas, losses = local_updates(grad_fn, client_opt, params, batch, lr, T)
            inc = flat_increment(deltas)
        new_params, new_state = server_opt.apply(params, server_state, inc)
        return new_params, new_state, _mean_loss(losses, active)

    return round


def build_scan_round_step(
    loss_fn: Callable[[Any, dict], torch.Tensor],
    *,
    n_clients: int,
    local_steps: int,
    A=None,
    relay_mode: str = "faithful",
    relay_backend: str = "einsum",
    client_opt: ClientOpt = ClientOpt(kind="sgd", weight_decay=1e-4),
    server_opt: ServerOpt = ServerOpt(),
):
    """Epoch variant of :func:`build_round_step`: returns
    ``scan_rounds(params, server_state, batches, taus, lr, A=None,
    active=None) -> (params', state', losses)`` running R rounds in one call
    — one call per channel epoch instead of per round.

    ``batches`` leaves are stacked (R, n_clients, local_steps, b, ...) and
    ``taus`` is (R, n_clients); A and the churn mask are the epoch's.  Each
    round *is* the single-round step, so R sequential calls of the per-round
    function give bit-identical results.
    """
    round = build_round_step(
        loss_fn,
        n_clients=n_clients,
        local_steps=local_steps,
        A=A,
        relay_mode=relay_mode,
        relay_backend=relay_backend,
        client_opt=client_opt,
        server_opt=server_opt,
    )

    def scan_rounds(params, server_state, batches, taus, lr, A=None, active=None):
        losses = []
        for r in range(len(taus)):
            batch = tree_map(lambda x, r=r: x[r], batches)
            params, server_state, loss = round(
                params, server_state, batch, taus[r], lr, A=A, active=active
            )
            losses.append(loss)
        return params, server_state, torch.stack(losses)

    return scan_rounds


def build_fused_scan_round_step(
    loss_fn: Callable[[Any, dict], torch.Tensor],
    *,
    n_clients: int,
    local_steps: int,
    A=None,
    relay_mode: str = "faithful",
    relay_backend: str = "einsum",
    client_opt: ClientOpt = ClientOpt(kind="sgd", weight_decay=1e-4),
    server_opt: ServerOpt = ServerOpt(),
    constrain_buffer: Callable | None = None,
):
    """τ-in-step variant of :func:`build_scan_round_step`: returns
    ``scan_rounds(generator, params, server_state, batches, p, lr, A=None,
    active=None) -> (generator, params', state', losses)``.

    Instead of a host-drawn ``taus`` block, the step takes the
    ``torch.Generator`` (on the parameters' device) and the uplink
    marginals ``p`` and draws each round's τ = Bernoulli(p) from it at the
    round's start — the simulator's ``sample_tau`` call, in round order — so
    the realized τ stream and the advanced generator equal R sequential
    host draws bit for bit.
    """
    round = build_round_step(
        loss_fn,
        n_clients=n_clients,
        local_steps=local_steps,
        A=A,
        relay_mode=relay_mode,
        relay_backend=relay_backend,
        client_opt=client_opt,
        server_opt=server_opt,
        constrain_buffer=constrain_buffer,
    )

    def scan_rounds(generator, params, server_state, batches, p, lr, A=None, active=None):
        p = _f32(p, _device(params))
        losses = []
        for r in range(_rounds(batches)):
            tau = torch.bernoulli(p, generator=generator)
            batch = tree_map(lambda x, r=r: x[r], batches)
            params, server_state, loss = round(
                params, server_state, batch, tau, lr, A=A, active=active
            )
            losses.append(loss)
        return generator, params, server_state, torch.stack(losses)

    return scan_rounds


def build_sharded_scan_round_step(
    loss_fn: Callable[[Any, dict], torch.Tensor],
    *,
    n_clients: int,
    local_steps: int,
    mesh,
    shard: str = "clients",
    exchange: str = "gather",
    relay_mode: str = "fused",
    relay_backend: str = "einsum",
    client_opt: ClientOpt = ClientOpt(kind="sgd", weight_decay=1e-4),
    server_opt: ServerOpt = ServerOpt(),
):
    """Multi-rank variant of :func:`build_fused_scan_round_step`: same
    signature ``scan_rounds(generator, params, server_state, batches, p, lr,
    A=None, active=None) -> (generator, params', state', losses)``, called
    by every rank of ``mesh`` with the same arguments.

    ``shard="clients"``: each of the k ranks of the mesh's client axis owns
    ``m = n_clients / k`` client slots.  ``batches`` leaves are the epoch's
    (R, n_clients, T, b, ...) stack, of which the rank reads its clients'
    rows, or just the rank's (R, m, T, b, ...) block (what
    :class:`~repro_torch.fl.engine.ShardedScanEngine` stages).  The rank runs
    its clients' local SGD steps and exchanges the raveled delta blocks —

    * ``exchange="gather"``: ``all_gather`` the (m, D) blocks to the full
      (n, D) buffer and reuse ``aggregation.colrel_increment_flat``
      verbatim, any dense backend (both CUDA kernels) included.  Same
      contraction, same order ⇒ bitwise equal to the one-rank step, as long
      as the local steps on m clients give the rows of the n-client run.
    * ``exchange="ring"``: the block ring
      (`repro_torch.fl.ring.ring_colrel_increment_flat`): k−1 rotations, each
      adding an (m, m) block product, then a τ-weighted ``all_reduce``.
      O(1) live buffers; the ring sums in another order ⇒ equal only to f32
      accumulation accuracy.

    Parameters, the generator state, A, p and the churn mask are the same on
    every rank; every rank draws the *same* τ from its generator (seeded
    alike by the caller), so the realized randomness — and the returned
    generator — match the one-rank fused step exactly.  Churn masking
    composes unchanged: A and τ are masked before the exchange, so a
    departed client's block contributes exactly zero on either exchange.
    The per-client losses are gathered, so every rank reports the same mean.

    ``shard="d"``: every rank runs every client (batches whole on every
    rank), and the (n, D) contraction is split over the mesh's "model" axis
    by `sharding.rules.flat_buffer_specs`: each rank contracts its column
    slice and the slices are gathered (a D that does not divide stays whole
    on every rank).  einsum backend only
    (`kernels.ops.validate_sharded_backend`).
    """
    kernel_ops.validate_sharded_backend(relay_backend, shard=shard, exchange=exchange)
    if shard == "d":

        def constrain(buf, contract):
            spec = sharding_rules.flat_buffer_specs(mesh, n=buf.shape[0], d=buf.shape[1])
            if spec[1] is None:
                return contract(buf)
            cols = sharding_rules.local_shard(buf, spec, mesh)
            return mesh.all_gather(contract(cols), spec[1])

        return build_fused_scan_round_step(
            loss_fn,
            n_clients=n_clients,
            local_steps=local_steps,
            relay_mode=relay_mode,
            relay_backend=relay_backend,
            client_opt=client_opt,
            server_opt=server_opt,
            constrain_buffer=constrain,
        )
    if shard != "clients":
        raise ValueError(f"unknown shard mode: {shard!r} (clients | d)")
    if exchange not in ("gather", "ring"):
        raise ValueError(f"unknown exchange: {exchange!r} (gather | ring)")

    axis = sharding_rules.shard_axis(mesh)
    k_shards = mesh.shape[axis]
    if n_clients % k_shards != 0:
        raise ValueError(
            f"n_clients={n_clients} not divisible by the {k_shards}-rank "
            f"client axis {axis!r}"
        )
    m = n_clients // k_shards
    refuse_clients_in_turn(loss_fn, "build_sharded_scan_round_step")
    T = local_steps
    fused = relay_mode == "fused"
    grad_fn = torch.func.vmap(torch.func.grad_and_value(loss_fn))
    shared_grad_fn = torch.func.vmap(torch.func.grad_and_value(loss_fn), in_dims=(None, 0))

    def local_block(batches):
        width = tree_flatten(batches)[0][0].shape[1]
        if width == m:
            return batches
        if width != n_clients:
            raise ValueError(f"batches hold {width} clients: expected all "
                             f"{n_clients} or this rank's {m}")
        return sharding_rules.local_shard(
            batches, sharding_rules.round_batch_specs(batches, mesh), mesh)

    def scan_rounds(generator, params, server_state, batches, p, lr, A=None, active=None):
        if A is None:
            raise ValueError("no relay matrix: pass A per call")
        dev = _device(params)
        A = relay_lib.as_relay_operand(A, n=n_clients, backend=relay_backend, device=dev)
        p, active = _f32(p, dev), _f32(active, dev)
        batches = local_block(batches)
        losses_out = []
        for r in range(_rounds(batches)):
            tau = torch.bernoulli(p, generator=generator)
            batch = tree_map(lambda x, r=r: torch.as_tensor(x[r], device=dev), batches)
            if T == 1:
                deltas_g, losses = _decayed_grads(shared_grad_fn, client_opt, params, batch)
                deltas = tree_scale(-lr, deltas_g)
            else:
                deltas, losses = local_updates(grad_fn, client_opt, params, batch, lr, T)
            buf_local, spec = stacked_ravel(deltas)  # (m, D)
            if exchange == "gather":
                buf = mesh.all_gather(buf_local, axis)
                flat = aggregation.colrel_increment_flat(
                    A, tau, buf, n=n_clients, fused=fused, active=active,
                    backend=relay_backend,
                )
            else:
                w = active_weight(active, n=n_clients)
                A_eff, tau_eff = A, tau
                if active is not None:
                    A_eff = relay_lib.mask_relay_matrix(A, active)
                    tau_eff = tau * active
                flat = ring_lib.ring_colrel_increment_flat(
                    A_eff, tau_eff, buf_local, w=w, axis_name=axis,
                    n_shards=k_shards, mesh=mesh,
                )
            inc = tree_unravel(spec, flat, cast=False)
            mean_loss = _mean_loss(mesh.all_gather(losses, axis), active)
            params, server_state = server_opt.apply(params, server_state, inc)
            losses_out.append(mean_loss)
        return generator, params, server_state, torch.stack(losses_out)

    return scan_rounds
