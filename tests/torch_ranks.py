"""Rank programs for the port's multi-rank tests (not a test module).

``repro_torch.launch.mesh.run_ranks`` runs each function on every rank of a
gloo world, so they live in a module the spawned ranks can import; each
returns numpy arrays.  The JAX package's counterparts run in a subprocess
with a forced host device count, as ``tests/test_ring_relay.py`` runs them.
"""
import numpy as np
import torch

from repro_torch.core import aggregation
from repro_torch.core import relay as relay_lib
from repro_torch.fl import ring
from repro_torch.launch.mesh import make_client_mesh, make_local_mesh
from repro_torch.utils import tree_flatten


def _masked(A, tau, active, n):
    """(A, τ, w) of the ring branch: churn masking is the caller's."""
    A, tau = torch.as_tensor(A, dtype=torch.float32), torch.as_tensor(tau)
    if active is None:
        return A, tau, aggregation.active_weight(None, n=n)
    a = torch.as_tensor(active)
    return (relay_lib.mask_relay_matrix(A, a), tau * a,
            aggregation.active_weight(a, n=n))


def ring_cases(rank, A, tau, churn, buf, A_one, deltas, tau_one):
    """Block ring on the flat buffer (full and churned) on a 1-D client mesh
    of every rank, and the one-client-per-rank pytree mixer on the same
    mesh and on a (pod, data, model) mesh whose client axes span it."""
    mesh = make_client_mesh()
    k, n = mesh.size, A.shape[0]
    m = n // k
    local = torch.from_numpy(buf[rank * m:(rank + 1) * m])
    out = {}
    for label, active in (("full", None), ("churn", churn)):
        A_eff, tau_eff, w = _masked(A, tau, active, n)
        out[label] = ring.ring_colrel_increment_flat(
            A_eff, tau_eff, local, w=w, axis_name="clients", n_shards=k, mesh=mesh
        ).numpy()
    stacked = {key: torch.from_numpy(v) for key, v in deltas.items()}
    mixer = ring.make_ring_round_mixer(A_one, w=1.0 / k, mesh=mesh, client_axes=("clients",))
    out["mixer"] = {key: v.numpy() for key, v in mixer(tau_one, stacked).items()}
    pod = make_local_mesh(k // 2, 1, pod=2)
    mixer = ring.make_ring_round_mixer(A_one, w=1.0 / k, mesh=pod, client_axes=("pod", "data"))
    out["mixer_pod"] = {key: v.numpy() for key, v in mixer(tau_one, stacked).items()}
    return out


def _host(tree):
    return [x.detach().numpy().copy() for x in tree_flatten(tree)[0]]


def sharded_cases(rank, model, n, T, b, rounds, cases, deterministic_conv):
    """The fused scan step on one rank's view of all n clients (the
    reference) and the sharded step over every rank, for each
    ``(shard, exchange, backend)`` of ``cases``, on the same batches, A,
    churn mask and generator seed.  Returns each run's final params and
    losses, and the reference's."""
    from repro_torch.bench.scenarios import _make_mlp, _make_resnet20
    from repro_torch.fl import distributed as dist_fl

    torch.backends.mkldnn.enabled = not deterministic_conv
    dev = torch.device("cpu")
    rng = np.random.default_rng(11)
    if model == "mlp":
        init, loss = _make_mlp(16, 8, 10, dev)
        batches = {"inputs": rng.standard_normal((rounds, n, T, b, 16)).astype(np.float32)}
    else:
        init, loss = _make_resnet20(10, dev)
        batches = {"images": rng.standard_normal((rounds, n, T, b, 32, 32, 3)).astype(np.float32)}
    batches["labels"] = rng.integers(0, 10, (rounds, n, T, b)).astype(np.int32)
    A = rng.uniform(0.0, 1.0, (n, n)) / n + np.eye(n) * 0.5
    p = rng.uniform(0.3, 0.9, n)
    active = (np.arange(n) % 3 != 1).astype(np.float32)
    lr = 0.05
    out = {}
    for shard, exchange, backend in [(None, None, "einsum")] + list(cases):
        for label, act in (("full", None), ("churn", active)):
            gen = torch.Generator().manual_seed(5)
            if shard is None:
                step = dist_fl.build_fused_scan_round_step(
                    loss, n_clients=n, local_steps=T, relay_mode="fused")
            else:
                axis = "clients" if shard == "clients" else "model"
                step = dist_fl.build_sharded_scan_round_step(
                    loss, n_clients=n, local_steps=T, mesh=make_client_mesh(axis=axis),
                    shard=shard, exchange=exchange, relay_backend=backend)
            gen, params, _, losses = step(gen, init(0), None, batches, p, lr, A=A, active=act)
            out[(shard, exchange, backend, label)] = (
                _host(params), losses.numpy(), gen.get_state().numpy())
    return out


def harness_scenario(rank, name):
    """One rank of ``run_scenario`` on a registered shard scenario; rank 0
    returns the result's gates and each engine's losses and launches."""
    from repro_torch.bench import harness

    result = harness.run_scenario(name, device="cpu")
    runs = {k: (r.losses, r.dispatches, r.kernel_launches) for k, r in result["runs"].items()}
    return result["shard_check"], result["kernel_check"], result["bitwise_match"], runs


def engine_cases(rank, modes):
    """``ShardedScanEngine`` over every rank for each ``(shard, exchange,
    prefetch)`` of ``modes``, and the one-rank reference walk: the fused
    scan step called once per segment, as the engine calls its step, on a
    schedule with rotating-cohort churn and correlated shadowing.  Also the
    staged bytes: each rank's first staged epoch."""
    from repro_torch.bench.scenarios import ScenarioSpec, build
    from repro_torch.fl import distributed as dist_fl
    from repro_torch.fl.engine import ShardedScanEngine, _segment_value

    spec = ScenarioSpec(
        name="t", n_clients=8, rounds=16, local_steps=2, local_batch=4, dim=16, width=8,
        n_train=128, fading="corr_shadow", drift="static", adj_every=8, p_every=8,
        churn="rotating", n_cohorts=4, churn_hold=8,
    )
    bundle = build(spec, device="cpu")
    loader = bundle.make_loader()
    batches = [loader.round_batch(spec.local_steps, spec.local_batch) for _ in range(spec.rounds)]
    kw = dict(n_clients=spec.n_clients, local_steps=spec.local_steps)
    out = {}

    ref = dist_fl.build_fused_scan_round_step(bundle.loss_fn, relay_mode="fused", **kw)
    schedule, policy = bundle.make_schedule(), bundle.make_policy()
    params, gen, stream = bundle.init_fn(spec.seed), torch.Generator().manual_seed(1), iter(batches)
    segments = 0
    for seg in schedule.segments(spec.rounds):
        segments += 1
        A = policy.relay_matrix(seg.state)
        host = [next(stream) for _ in range(seg.n_rounds)]
        stacked = {k: np.stack([h[k] for h in host]) for k in host[0]}
        p, active = (_segment_value(x, torch.device("cpu")) for x in (seg.p, seg.active))
        gen, params, _, _ = ref(gen, params, None, stacked, p, spec.lr, A=A, active=active)
    out["reference"] = (_host(params), None, gen.get_state().numpy(), segments)

    for shard, exchange, prefetch in modes:
        axis = "clients" if shard == "clients" else "model"
        mesh = make_client_mesh(axis=axis)
        step = dist_fl.build_sharded_scan_round_step(
            bundle.loss_fn, mesh=mesh, shard=shard, exchange=exchange, **kw)
        eng = ShardedScanEngine(step, mesh=mesh, shard=shard, prefetch=prefetch, device="cpu")
        placed = []
        real_place = eng._place

        def place(host, _real=real_place, **kw_):
            staged = _real(host, **kw_)
            placed.append({k: v.numpy().copy() for k, v in staged.items()})
            return staged

        eng._place = place
        stream = iter(batches)
        params, _, metrics, gen = eng.run_schedule(
            torch.Generator().manual_seed(1), bundle.init_fn(spec.seed), None,
            schedule=bundle.make_schedule(), rounds=spec.rounds,
            next_batch=lambda: next(stream), lr=spec.lr, policy=bundle.make_policy(),
        )
        out[(shard, exchange, prefetch)] = (
            _host(params), metrics["loss"].numpy(), gen.get_state().numpy(),
            eng.dispatches, placed[0])
    return out


def hint_redistributes(rank):
    """A replicated DTensor hinted under a (data, model) mapping on a 2 × 2
    mesh: its placements, this rank's block and the whole tensor."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.sharding import hints

    dmesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    mesh = make_local_mesh(2, 2)
    x = distribute_tensor(torch.arange(32.0).reshape(4, 8), dmesh, [Replicate(), Replicate()])
    with hints.axis_rules(mesh, {"batch": "data", "qchunk": "model"}):
        y = hints.hint(x * 2, "batch", "qchunk")
        z = hints.hint(y, "batch", None)  # a hint that moves it again
    def names(t):
        return [(type(p).__name__, getattr(p, "dim", None)) for p in t.placements]

    return names(y), y.to_local().numpy(), y.full_tensor().numpy(), names(z)


def collectives_counted(rank):
    """hlo_cost.analyze over an all_reduce, an all_gather, a reduce-scatter
    and a send/recv pair on this gloo world, with real CPU tensors."""
    import torch.distributed as dist

    from repro_torch.launch import hlo_cost

    def step(x):
        dist.all_reduce(x.clone())
        dist.all_gather([torch.empty_like(x) for _ in range(dist.get_world_size())], x)
        out = torch.empty(x.shape[0] // dist.get_world_size(), *x.shape[1:])
        dist.reduce_scatter_tensor(out, x)
        other = 1 - dist.get_rank()
        recv = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x, other), dist.P2POp(dist.irecv, recv, other)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return recv

    return hlo_cost.analyze(step, torch.ones(4, 6))
