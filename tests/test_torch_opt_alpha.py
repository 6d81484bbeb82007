"""The port's host math (topology, OPT-α, connectivity) against the JAX
package's: numpy in both, so the results must be *equal*, not close."""
import numpy as np
import pytest
import torch

from repro.core import opt_alpha as jax_opt
from repro.core import topology as jax_top
from repro.core.connectivity import heterogeneous_profile as jax_hetero
from repro.core.connectivity import paper_heterogeneous as jax_paper
from repro_torch.core import connectivity, opt_alpha, topology


@pytest.mark.parametrize(
    "name, args",
    [
        ("ring", (10, 1)), ("ring", (12, 2)), ("fully_connected", (6,)),
        ("disconnected", (5,)), ("erdos_renyi", (20, 0.3, 4)), ("clusters", (11, 3)),
        ("random_geometric", (200, 0.12)),
    ],
)
def test_topologies_equal(name, args):
    adj = getattr(topology, name)(*args)
    want = getattr(jax_top, name)(*args)
    assert np.array_equal(adj, want)
    assert np.array_equal(topology.closed_mask(adj), jax_top.closed_mask(want))
    g, jg = topology.closed_csc(adj), jax_top.closed_csc(want)
    assert np.array_equal(g.indptr, jg.indptr) and np.array_equal(g.rows, jg.rows)


@pytest.mark.parametrize("method", ["bisect", "exact"])
@pytest.mark.parametrize("k", [1, 2])
def test_optimize_equal_on_paper_ring(method, k):
    p = connectivity.paper_heterogeneous().p
    assert np.array_equal(p, jax_paper().p)
    adj = topology.ring(10, k=k)
    got = opt_alpha.optimize(p, adj, sweeps=50, method=method)
    want = jax_opt.optimize(p, adj, sweeps=50, method=method)
    assert np.array_equal(got.A, want.A)
    assert np.array_equal(got.S_history, want.S_history)
    assert np.array_equal(got.feasible_columns, want.feasible_columns)
    assert got.sweeps == want.sweeps
    assert got.bisection_iters_total == want.bisection_iters_total
    assert np.abs(opt_alpha.unbiasedness_residual(p, got.A)).max() < 1e-9


@pytest.mark.parametrize("seed", range(6))
def test_optimize_masked_equal_on_random_draws(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(4, 16))
    p = rng.uniform(0.0, 1.0, n)
    p[rng.random(n) < 0.15] = 0.0
    adj = topology.erdos_renyi(n, 0.4, seed=seed)
    active = rng.random(n) < 0.7
    method = "exact" if seed % 2 else "bisect"
    got = opt_alpha.optimize_masked(p, adj, active, sweeps=30, method=method)
    want = jax_opt.optimize_masked(p, adj, active, sweeps=30, method=method)
    assert np.array_equal(got.A, want.A)
    assert np.array_equal(got.feasible_columns, want.feasible_columns)
    A_prev = want.A
    p2 = np.clip(p + rng.normal(0, 0.05, n), 0, 1)
    assert np.array_equal(opt_alpha.warm_start_weights(p2, adj, A_prev),
                          jax_opt.warm_start_weights(p2, adj, A_prev))
    assert np.array_equal(opt_alpha.initial_weights(p2, adj), jax_opt.initial_weights(p2, adj))
    assert opt_alpha.variance_proxy(p, got.A) == jax_opt.variance_proxy(p, want.A)


def test_solve_column_and_helpers_equal():
    rng = np.random.default_rng(9)
    p = rng.uniform(0.05, 0.95, 8)
    closed = rng.random(8) < 0.6
    beta = rng.uniform(0, 2, 8)
    for method in ("bisect", "exact"):
        col, ok, it = opt_alpha.solve_column(p, closed, beta, method=method)
        jcol, jok, jit = jax_opt.solve_column(p, closed, beta, method=method)
        assert np.array_equal(col, jcol) and ok == jok and it == jit
    with pytest.raises(ValueError, match="unknown column solver"):
        opt_alpha.solve_column(p, closed, beta, method="newton")
    assert np.array_equal(opt_alpha.fedavg_weights(5), jax_opt.fedavg_weights(5))
    adj = topology.ring(6, 1)
    A = opt_alpha.optimize(p[:6], adj).A
    assert opt_alpha.variance_proxy_literal(p[:6], A, adj) == pytest.approx(
        jax_opt.variance_proxy_literal(p[:6], A, adj))


def test_connectivity_draws_from_a_torch_generator():
    model = connectivity.heterogeneous_profile(14, seed=3)
    assert np.array_equal(model.p, jax_hetero(14, seed=3).p)
    gen = torch.Generator().manual_seed(0)
    tau = model.sample(gen)
    assert tau.shape == (14,) and set(tau.unique().tolist()) <= {0.0, 1.0}
    rounds = model.sample_rounds(torch.Generator().manual_seed(1), 4000)
    assert rounds.shape == (4000, 14)
    np.testing.assert_allclose(rounds.mean(0).numpy(), model.p, atol=0.03)
    again = model.sample_rounds(torch.Generator().manual_seed(1), 4000)
    assert torch.equal(rounds, again)
    with pytest.raises(ValueError, match="lie in"):
        connectivity.ConnectivityModel([0.5, 1.5])
    assert np.array_equal(connectivity.homogeneous(4, 0.3).p, np.full(4, 0.3, np.float32))


@pytest.mark.parametrize("topo", ["ring1", "ring2", "er", "clusters"])
def test_optimize_distributed_equals_jax_and_the_centralized_solve(topo):
    """Paper Remark 2 (oracle: ``tests/test_distributed_opt_alpha.py``): the
    2-hop solve equals the JAX package's bit for bit, and the centralized
    Gauss-Seidel solve column for column."""
    n = 12
    p = connectivity.heterogeneous_profile(n).p
    adj = {
        "ring1": topology.ring(n, 1),
        "ring2": topology.ring(n, 2),
        "er": topology.erdos_renyi(n, 0.35, seed=3),
        "clusters": topology.clusters(n, 3),
    }[topo]
    got = opt_alpha.optimize_distributed(p, adj, sweeps=25)
    want = jax_opt.optimize_distributed(p, adj, sweeps=25)
    for field in ("A", "S_history", "feasible_columns"):
        assert np.array_equal(getattr(got, field), getattr(want, field)), field
    assert (got.sweeps, got.bisection_iters_total) == (want.sweeps, want.bisection_iters_total)
    central = opt_alpha.optimize(p, adj, sweeps=25)
    np.testing.assert_allclose(got.A, central.A, atol=1e-10)
    np.testing.assert_allclose(got.S_history, central.S_history, atol=1e-10)


def test_optimize_distributed_is_unbiased():
    p = connectivity.paper_heterogeneous().p
    res = opt_alpha.optimize_distributed(p, topology.ring(10, 1), sweeps=30)
    assert res.feasible_columns.all()
    assert np.abs(opt_alpha.unbiasedness_residual(p, res.A)).max() < 1e-8
