"""The paper's convergence claims on the port: the counterpart of
``tests/test_fl_convergence.py`` on the strongly convex quadratic where
Theorem 1's assumptions hold exactly (``repro_torch.bench.claims``).

Two halves.  Parity: one τ seed's 150-round trajectory of colrel_fused,
fedavg_blind and no_dropout, with the reference's batches and τ
(``sample_tau``) handed over: each round, started from the reference's x
before it, within 1e-5 of the JAX simulator's (relative to |x| where it
exceeds 1: the early rounds pass through |x| ~ 1e6), and the trajectory
from x = 0 within 1e-5 absolute after the last round.
Claims: the reference's bounds, unchanged, over the same seeds, with the
port's own τ from a CPU generator (and the port's own batch noise); slow, as
the reference marks them.  Also the reference's two algebra checks: colrel
equals colrel_fused, and ``fl.distributed``'s round step the simulator.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import connectivity as jax_conn
from repro.core import opt_alpha as jax_opt
from repro.core import topology as jax_top
from repro.data.synthetic import quadratic_problem as jax_quadratic_problem
from repro.fl.simulator import FLSimulator as JaxSimulator
from repro.optim.sgd import ClientOpt as JaxClientOpt
from repro_torch.bench import claims
from repro_torch.fl.simulator import FLSimulator
from repro_torch.optim.sgd import ClientOpt

PARITY_SEED = claims.SEEDS[0]


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@functools.cache
def _reference():
    """The reference test's fixture: problem, channel, loss and its
    jax.random batch noise."""
    n, dim, T, rounds = (claims.N_CLIENTS, claims.DIM, claims.LOCAL_STEPS, claims.ROUNDS)
    H, centers, x_star = jax_quadratic_problem(dim, n, seed=0)
    p = jax_conn.paper_heterogeneous().p
    adj = jax_top.ring(10, 1)
    Hj = jnp.asarray(H)

    def loss_fn(params, batch):
        diff = params["x"][None, :] - batch["c"]
        return 0.5 * jnp.mean(jnp.einsum("bi,ij,bj->b", diff, Hj, diff))

    noise = np.asarray(jax.random.normal(jax.random.key(1), (rounds, n, T, 8, dim))) * 0.5
    return dict(loss_fn=loss_fn, p=p, A=jax_opt.optimize(p, adj, sweeps=60).A,
                A0=jax_opt.initial_weights(p, adj), noise=noise,
                batches=centers[None, :, None, None, :] + noise, x_star=x_star)


@functools.cache
def _reference_run(strategy):
    """The reference's ``_run`` at the parity seed: x after every round and
    the τ it drew."""
    q = _reference()
    A = q["A"] if strategy.startswith("colrel") else None
    sim = JaxSimulator(q["loss_fn"], n_clients=claims.N_CLIENTS, strategy=strategy, A=A,
                       p=q["p"], local_steps=claims.LOCAL_STEPS,
                       client_opt=JaxClientOpt(kind="sgd", weight_decay=0.0))
    params = {"x": jnp.zeros((claims.DIM,))}
    ss = sim.init_server_state(params)
    key, xs, taus = jax.random.key(PARITY_SEED), [], []
    for r in range(claims.ROUNDS):
        key, sub = jax.random.split(key)
        taus.append(np.asarray(sim.sample_tau(sub)))
        lr = min(0.4, 4.0 / (r * claims.LOCAL_STEPS + 1))
        params, ss, _ = sim.run_round(sub, params, ss, {"c": jnp.asarray(q["batches"][r])}, lr)
        xs.append(np.asarray(params["x"]))
    return np.stack(xs), np.stack(taus)


@functools.cache
def _port_setting():
    return claims.quadratic_setting(device="cpu")


def test_setting_matches_the_reference():
    q, ref = claims.quadratic_setting(device="cpu", noise=_reference()["noise"]), _reference()
    np.testing.assert_array_equal(q["A"], ref["A"])
    np.testing.assert_array_equal(q["A0"], ref["A0"])
    np.testing.assert_array_equal(q["p"], ref["p"])
    np.testing.assert_array_equal(q["batches"].numpy(), ref["batches"].astype(np.float32))
    np.testing.assert_array_equal(q["x_star"].numpy(), ref["x_star"])


@pytest.mark.parametrize("strategy", ["colrel_fused", "fedavg_blind", "no_dropout"])
def test_trajectory_matches_the_reference(strategy):
    want, taus = _reference_run(strategy)
    ref = _reference()
    q = claims.quadratic_setting(device="cpu", noise=ref["noise"])
    A = q["A"] if strategy.startswith("colrel") else None
    # every round on its own, from the reference's x before it: within 1e-5
    # of the larger |x| of its input and output (lr 0.4 on the stiffest
    # eigenvalue, 10, multiplies x by -3 a local step, so rounds 2-5 pass
    # through |x| ~ 1e5-1e6, where one f32 ulp is up to 0.06)
    sim = FLSimulator(q["loss_fn"], n_clients=claims.N_CLIENTS, strategy=strategy, A=A,
                      p=q["p"], local_steps=claims.LOCAL_STEPS,
                      client_opt=ClientOpt(kind="sgd", weight_decay=0.0), device="cpu")
    before = np.concatenate([np.zeros((1, claims.DIM), np.float32), want[:-1]])
    for r in range(claims.ROUNDS):
        lr = min(0.4, 4.0 / (r * claims.LOCAL_STEPS + 1))
        out, _, _ = sim.run_round(torch.Generator(), {"x": torch.as_tensor(before[r])}, None,
                                  {"c": q["batches"][r]}, lr, tau=taus[r])
        scale = max(np.abs(before[r]).max(), np.abs(want[r]).max(), 1.0)
        np.testing.assert_allclose(out["x"].numpy(), want[r], atol=1e-5 * scale, rtol=0,
                                   err_msg=f"round {r}")
    # and the whole trajectory from x = 0: the f32 differences of the
    # |x| ~ 1e6 rounds contract away, and the last round, back at |x| < 1,
    # is within 1e-5 absolute
    err, xs = claims.run_quadratic(q, strategy, A, taus=taus, trajectory=True)
    assert np.abs(xs[-1].numpy() - want[-1]).max() <= 1e-5 and np.abs(want[-1]).max() < 1.0
    np.testing.assert_allclose(err, float(np.sum((want[-1] - ref["x_star"]) ** 2)),
                               atol=1e-5, rtol=0)


@functools.cache
def _errors(strategy, which, seed):
    q = _port_setting()
    A = {"A": q["A"], "A0": q["A0"], None: None}[which]
    return claims.run_quadratic(q, strategy, A, seed=seed)


def _mean(strategy, which=None):
    return float(np.mean([_errors(strategy, which, s) for s in claims.SEEDS]))


@pytest.mark.slow
def test_colrel_beats_fedavg_dropout():
    err_colrel = _errors("colrel_fused", "A", claims.SEEDS[0])
    err_blind = _errors("fedavg_blind", None, claims.SEEDS[0])
    assert err_colrel < err_blind * 0.3, (err_colrel, err_blind)


@pytest.mark.slow
def test_optimized_weights_beat_init():
    err_opt, err_init = _mean("colrel_fused", "A"), _mean("colrel_fused", "A0")
    assert err_opt < err_init * 1.05, (err_opt, err_init)


@pytest.mark.slow
def test_colrel_within_reach_of_no_dropout():
    err_colrel, err_full = _mean("colrel_fused", "A"), _mean("no_dropout")
    assert err_colrel < 250 * max(err_full, 1e-4), (err_colrel, err_full)


@pytest.mark.slow
def test_check_claims_is_the_three_tests():
    """``claims.check_claims`` (the card's claims phase) reports the same
    sides as the three tests above, and every claim holds."""
    out = claims.check_claims(_port_setting())
    c = out["claims"]
    assert c["colrel_beats_fedavg_dropout"]["value"] == _errors("colrel_fused", "A", 42)
    assert c["colrel_beats_fedavg_dropout"]["bound"] == 0.3 * _errors("fedavg_blind", None, 42)
    assert c["optimized_beats_init"]["bound"] == 1.05 * _mean("colrel_fused", "A0")
    assert c["colrel_within_reach_of_no_dropout"]["bound"] == 250 * max(
        _mean("no_dropout"), 1e-4)
    assert all(v["holds"] for v in c.values()), c
    assert [len(v) for v in out["errors"].values()] == [3, 1, 3, 3]


def test_faithful_equals_fused_rounds():
    """The two relay schedules are algebraically identical per round."""
    q = _port_setting()
    params = {"x": torch.ones((claims.DIM,))}
    batch = {"c": q["batches"][0]}
    out = []
    for strategy in ("colrel", "colrel_fused"):
        sim = FLSimulator(q["loss_fn"], n_clients=claims.N_CLIENTS, strategy=strategy,
                          A=q["A"], p=q["p"], local_steps=claims.LOCAL_STEPS,
                          client_opt=ClientOpt(kind="sgd", weight_decay=0.0), device="cpu")
        gen = torch.Generator().manual_seed(7)
        out.append(sim.run_round(gen, params, None, batch, 0.1)[0]["x"])
    np.testing.assert_allclose(out[0].numpy(), out[1].numpy(), atol=1e-5)


def test_distributed_round_matches_simulator():
    """fl.distributed (T = 1) computes the same update as the single-host
    simulator on identical inputs, both relay modes."""
    from repro_torch.fl.distributed import build_round_step

    q = _port_setting()
    n = claims.N_CLIENTS
    params = {"x": torch.ones((claims.DIM,))}
    batch1 = {"c": q["batches"][0][:, :1]}  # (n, 1, b, dim)
    tau = torch.as_tensor(np.random.default_rng(0).random(n) < q["p"], dtype=torch.float32)
    sim = FLSimulator(q["loss_fn"], n_clients=n, strategy="colrel", A=q["A"], p=q["p"],
                      local_steps=1, client_opt=ClientOpt(kind="sgd", weight_decay=0.0),
                      device="cpu")
    want, _, _ = sim.round_math(params, None, batch1, tau, sim.A, 0.1, None)
    for mode in ("faithful", "fused"):
        step = build_round_step(q["loss_fn"], n_clients=n, local_steps=1, A=q["A"],
                                relay_mode=mode,
                                client_opt=ClientOpt(kind="sgd", weight_decay=0.0))
        got, _, _ = step(params, None, batch1, tau, 0.1)
        np.testing.assert_allclose(got["x"].numpy(), want["x"].numpy(), atol=1e-5,
                                   err_msg=f"relay_mode={mode}")


@pytest.mark.slow
def test_noniid_failure_mode_and_colrel_rescue():
    """Paper Fig. 4 in miniature: sort-and-partition non-IID + dropout makes
    blind FedAvg fail; ColRel recovers most accuracy (the port's own τ)."""
    from repro_torch.core import connectivity, opt_alpha, topology
    from repro_torch.data.loader import FederatedLoader
    from repro_torch.data.partition import sort_and_partition
    from repro_torch.data.synthetic import gaussian_classification

    n, dim, ncls = 10, 32, 10
    ds = gaussian_classification(4000, dim=dim, n_classes=ncls, snr=0.8, seed=0)
    parts = sort_and_partition(ds, n, shards_per_client=1, seed=0)
    loader = FederatedLoader(ds, parts, seed=0)
    p = connectivity.paper_heterogeneous().p
    A = opt_alpha.optimize(p, topology.ring(n, 2), sweeps=40).A

    def loss_fn(params, batch):
        logits = batch["inputs"] @ params["w"] + params["b"]
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, 1, batch["labels"].long()[:, None])[:, 0]
        return torch.mean(logz - gold)

    test = gaussian_classification(2000, dim=dim, n_classes=ncls, snr=0.8, seed=9)

    def acc(params):
        logits = torch.as_tensor(test.inputs) @ params["w"] + params["b"]
        return float((logits.argmax(-1) == torch.as_tensor(test.labels)).float().mean())

    results = {}
    for name, strat, Am in [("blind", "fedavg_blind", None), ("colrel", "colrel_fused", A)]:
        sim = FLSimulator(loss_fn, n_clients=n, strategy=strat, A=Am, p=p, local_steps=4,
                          client_opt=ClientOpt(kind="sgd", weight_decay=1e-4), device="cpu")
        params = {"w": torch.zeros((dim, ncls)), "b": torch.zeros((ncls,))}
        ss = sim.init_server_state(params)
        gen = torch.Generator().manual_seed(1)
        for _ in range(10):
            batch = loader.round_batch(4, 16)
            params, ss, _ = sim.run_round(gen, params, ss, batch, 0.5)
        results[name] = acc(params)
    assert results["colrel"] > results["blind"] + 0.15, results
