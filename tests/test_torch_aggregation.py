"""The port's relay and aggregation algebra against the JAX package's: every
strategy × {no mask, churn mask} × every backend (the kernel backends on the
CPU run the kernels' plain versions; the JAX side runs its Pallas kernels in
interpret mode on the matching backend)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jax_agg
from repro.core import relay as jax_relay
from repro_torch.core import aggregation, relay
from repro_torch.utils import tree_flatten

STRATEGIES = ["colrel", "colrel_fused", "fedavg_blind", "fedavg_nonblind", "no_dropout"]
JAX_BACKEND = {"einsum": "einsum", "hopper": "pallas", "hopper_fused": "pallas_fused"}
N, D = 8, 777
INACTIVE_FILL = 1e30  # an inactive slot's update must contribute exactly zero


def _case(masked):
    rng = np.random.default_rng(11 + masked)
    A = np.abs(rng.standard_normal((N, N))).astype(np.float32)
    tau = (rng.random(N) < 0.6).astype(np.float32)
    buf = rng.standard_normal((N, D)).astype(np.float32)
    active = None
    if masked:
        active = np.array([1, 0, 1, 1, 0, 1, 1, 0], np.float32)
        buf[active == 0] = INACTIVE_FILL
    return A, tau, buf, active


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("backend", ["einsum", "hopper", "hopper_fused"])
def test_flat_fn_matches_jax(strategy, masked, backend):
    A, tau, buf, active = _case(masked)
    jax_fn = jax_agg.make_aggregator(strategy, n=N, A=A, relay_backend=JAX_BACKEND[backend],
                                     block_d=256, interpret=True).flat_fn
    want = jax_fn(jnp.asarray(tau), jnp.asarray(buf), None,
                  None if active is None else jnp.asarray(active))
    agg = aggregation.make_aggregator(strategy, n=N, A=A, relay_backend=backend)
    got = agg.flat_fn(torch.from_numpy(tau), torch.from_numpy(buf), None,
                      None if active is None else torch.from_numpy(active))
    assert got.shape == (D,) and got.dtype == torch.float32
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("backend", ["einsum", "hopper", "hopper_fused"])
def test_inactive_slots_contribute_exactly_zero(strategy, backend):
    """Changing what an inactive slot holds changes nothing, bit for bit."""
    A, tau, buf, active = _case(True)
    agg = aggregation.make_aggregator(strategy, n=N, A=A, relay_backend=backend)
    act = torch.from_numpy(active)
    got_big = agg.flat_fn(torch.from_numpy(tau), torch.from_numpy(buf), None, act)
    buf0 = buf.copy()
    buf0[active == 0] = 0.0
    got_zero = agg.flat_fn(torch.from_numpy(tau), torch.from_numpy(buf0), None, act)
    assert torch.equal(got_big, got_zero)


def test_pytree_fn_unravels_like_jax():
    rng = np.random.default_rng(5)
    A = np.abs(rng.standard_normal((4, 4))).astype(np.float32)
    tau = np.array([1, 0, 1, 1], np.float32)
    upd = {"w": rng.standard_normal((4, 3, 5)).astype(np.float32),
           "b": rng.standard_normal((4, 5)).astype(np.float32)}
    want = jax_agg.make_aggregator("colrel", n=4, A=A).fn(jnp.asarray(tau),
                                                          jax.tree.map(jnp.asarray, upd))
    got = aggregation.make_aggregator("colrel", n=4, A=A).fn(
        torch.from_numpy(tau), {key: torch.from_numpy(v) for key, v in upd.items()})
    for key in upd:
        assert tuple(got[key].shape) == want[key].shape
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-5)


def test_make_aggregator_errors():
    with pytest.raises(ValueError, match="unknown aggregation strategy"):
        aggregation.make_aggregator("median", n=3)
    with pytest.raises(ValueError, match="relay matrix A"):
        aggregation.make_aggregator("colrel", n=3).flat_fn(torch.ones(3), torch.ones(3, 4))
    # the JAX package's contract: a dense A on the segment backend is refused
    with pytest.raises(ValueError, match="needs an EdgeRelay operand"):
        aggregation.make_aggregator("colrel", n=3, A=np.eye(3),
                                    relay_backend="segment").flat_fn(torch.ones(3),
                                                                     torch.ones(3, 4))


@pytest.mark.parametrize("momentum, lr", [(0.0, 1.0), (0.9, 1.0), (0.5, 0.3)])
def test_server_opt_matches_jax(momentum, lr):
    rng = np.random.default_rng(6)
    params = {"a": rng.standard_normal((3, 4)).astype(np.float32),
              "b": rng.standard_normal(5).astype(np.float32)}
    incs = [{key: rng.standard_normal(v.shape).astype(np.float32) for key, v in params.items()}
            for _ in range(3)]
    jopt = jax_agg.ServerOpt(momentum=momentum, lr=lr)
    topt = aggregation.ServerOpt(momentum=momentum, lr=lr)
    jp, tp = jax.tree.map(jnp.asarray, params), {k: torch.from_numpy(v) for k, v in params.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for inc in incs:
        jp, js = jopt.apply(jp, js, jax.tree.map(jnp.asarray, inc))
        tp, ts = topt.apply(tp, ts, {k: torch.from_numpy(v) for k, v in inc.items()})
    for a, b in zip(jax.tree.leaves(jp), tree_flatten(tp)[0]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6, rtol=1e-6)
    assert (ts is None) == (momentum == 0.0)


def test_relay_algebra_matches_jax():
    rng = np.random.default_rng(7)
    n = 5
    A = rng.standard_normal((n, n)).astype(np.float32)
    tau = (rng.random(n) < 0.5).astype(np.float32)
    active = np.array([1, 1, 0, 1, 1], np.float32)
    upd = {"x": rng.standard_normal((n, 6, 2)).astype(np.float32)}
    jupd = jax.tree.map(jnp.asarray, upd)
    tupd = {"x": torch.from_numpy(upd["x"])}
    np.testing.assert_allclose(relay.mask_relay_matrix(torch.from_numpy(A), active).numpy(),
                               np.asarray(jax_relay.mask_relay_matrix(A, active)))
    np.testing.assert_allclose(relay.fused_coefficients(A, tau).numpy(),
                               np.asarray(jax_relay.fused_coefficients(A, tau)), atol=1e-6)
    np.testing.assert_allclose(relay.relay(torch.from_numpy(A), tupd)["x"].numpy(),
                               np.asarray(jax_relay.relay(A, jupd)["x"]), atol=1e-5)
    np.testing.assert_allclose(relay.fused_aggregate(A, tau, tupd, w=0.2)["x"].numpy(),
                               np.asarray(jax_relay.fused_aggregate(A, tau, jupd, w=0.2)["x"]),
                               atol=1e-5)
    np.testing.assert_allclose(relay.masked_aggregate(tau, tupd, w=0.2)["x"].numpy(),
                               np.asarray(jax_relay.masked_aggregate(tau, jupd, w=0.2)["x"]),
                               atol=1e-5)
    got = relay.as_relay_operand(A, n=n, device="cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == (n, n)
    with pytest.raises(ValueError, match="relay matrix shape"):
        relay.as_relay_operand(A, n=n + 1, device="cpu")
    with pytest.raises(ValueError, match="square"):
        relay.relay(torch.ones(2, 3), tupd)


def _increment(agg, strategy, A, tau, upd, n, active):
    if strategy in ("colrel", "colrel_fused"):
        return agg.colrel_increment(A, tau, upd, n=n, fused=strategy == "colrel_fused",
                                    active=active)
    if strategy == "fedavg_blind":
        return agg.fedavg_blind_increment(tau, upd, n=n, active=active)
    if strategy == "fedavg_nonblind":
        return agg.fedavg_nonblind_increment(tau, upd, active=active)
    return agg.no_dropout_increment(upd, n=n, active=active)


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("masked", [False, True])
def test_pytree_increments_match_jax(strategy, masked):
    """The four pytree increments (colrel fused and unfused) on a stacked
    pytree, with and without a churn mask, within 1e-6 of the JAX
    package's."""
    rng = np.random.default_rng(21 + masked)
    A = np.abs(rng.standard_normal((N, N)) / N).astype(np.float32)
    tau = (rng.random(N) < 0.6).astype(np.float32)
    upd = {"w": rng.standard_normal((N, 3, 5)).astype(np.float32),
           "blocks": [rng.standard_normal((N, 7)).astype(np.float32)]}
    active = np.array([1, 0, 1, 1, 0, 1, 1, 0], np.float32) if masked else None
    want = _increment(jax_agg, strategy, jnp.asarray(A), jnp.asarray(tau),
                      jax.tree.map(jnp.asarray, upd), N,
                      None if active is None else jnp.asarray(active))
    got = _increment(aggregation, strategy, A, torch.from_numpy(tau),
                     {"w": torch.from_numpy(upd["w"]),
                      "blocks": [torch.from_numpy(upd["blocks"][0])]}, N,
                     None if active is None else torch.from_numpy(active))
    got_leaves, want_leaves = tree_flatten(got)[0], jax.tree.leaves(want)
    assert len(got_leaves) == len(want_leaves) == 2
    for g, w in zip(got_leaves, want_leaves):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


def test_pytree_colrel_increment_is_the_flat_fn():
    """The pytree increment and the aggregator's flat hot path are the same
    math (the JAX package's fused ≡ faithful oracle, on the port)."""
    A, tau, buf, active = _case(True)
    upd = {"x": torch.from_numpy(buf)}
    for fused, strategy in ((True, "colrel_fused"), (False, "colrel")):
        got = aggregation.colrel_increment(A, torch.from_numpy(tau), upd, n=N, fused=fused,
                                           active=torch.from_numpy(active))["x"]
        want = aggregation.make_aggregator(strategy, n=N, A=A).flat_fn(
            torch.from_numpy(tau), torch.from_numpy(buf), None, torch.from_numpy(active))
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["optimized", "off_support", "identity"])
def test_neighbor_support_matches_jax(case):
    from repro.core import opt_alpha as jax_opt_alpha
    from repro_torch.core import topology

    adj = topology.ring(N, 1)
    if case == "optimized":
        A = jax_opt_alpha.optimize(np.linspace(0.2, 0.9, N), adj, sweeps=10).A
    elif case == "off_support":
        A = np.eye(N)
        A[0, N // 2] = 0.1  # client 0 cannot hear client N/2 on a ring
    else:
        A = np.eye(N)
    got = relay.neighbor_support(torch.as_tensor(np.asarray(A)), adj)
    assert got == jax_relay.neighbor_support(A, adj) == (case != "off_support")
