"""One and two ``FLSimulator`` rounds of ResNet-20 in the port against the JAX
package's, for every strategy, with and without a churn mask.

τ, the initial parameters and the batches come from the JAX side (torch
cannot draw threefry's numbers) and are handed over as arrays.  ResNet-20 at
n = 4 clients, 2 local steps of batch 2.

The JAX side runs its own ``FLSimulator._round_math`` with the clients'
local update jitted once and shared by every strategy: one ResNet-20
compile instead of one a strategy.  ``test_shared_update_is_run_round``
holds that shortcut bitwise to ``run_round``.

The client lr is small on purpose.  The two packages' convolutions round
differently (~1e-7), so a pre-activation that lies within that noise of zero
takes the other ReLU branch in one of them, and that step's gradient moves
by up to ~3e-3 in the first layers (seen at lr 0.05 in round 2).  At
lr 1e-3 such a flip moves a parameter by a few 1e-6, inside the 1e-5
tolerance, while any error in the round's own algebra still shows.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.resnet20_cifar import CONFIG as JAX_CONFIG
from repro.core import opt_alpha as jax_opt
from repro.core import topology as jax_top
from repro.fl.simulator import FLSimulator as JaxSimulator
from repro.models.resnet import init_resnet20 as jax_init
from repro.models.resnet import resnet20_loss as jax_resnet20_loss
from repro_torch.configs.resnet20_cifar import CONFIG
from repro_torch.fl.simulator import FLSimulator
from repro_torch.models.resnet import resnet20_loss
from repro_torch.utils import from_jax_params, tree_flatten

STRATEGIES = ["colrel", "colrel_fused", "fedavg_blind", "fedavg_nonblind", "no_dropout"]
N, T, B, LR, ROUNDS = 4, 2, 2, 1e-3, 2
P = np.array([0.3, 0.6, 0.9, 0.5], np.float32)
ACTIVE = np.array([1, 1, 0, 1], np.float32)
BACKEND = {"colrel": "hopper", "colrel_fused": "hopper_fused", "fedavg_blind": "einsum",
           "fedavg_nonblind": "hopper_fused", "no_dropout": "hopper"}


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    # the suite runs several test processes side by side; torch's default of
    # one thread a core each would oversubscribe the machine
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def jax_loss(params, batch):
    return jax_resnet20_loss(params, JAX_CONFIG, batch)


def torch_loss(params, batch):
    return resnet20_loss(params, CONFIG, batch)


@functools.cache
def _setup():
    A = jax_opt.optimize(P, jax_top.ring(N, k=1)).A
    params = jax.jit(jax_init, static_argnums=1)(jax.random.key(0), JAX_CONFIG)
    rng = np.random.default_rng(0)
    batches = [{"images": rng.standard_normal((N, T, B, 32, 32, 3)).astype(np.float32),
                "labels": rng.integers(0, 10, (N, T, B)).astype(np.int32)}
               for _ in range(ROUNDS)]
    shared_update = jax.jit(JaxSimulator(jax_loss, n_clients=N, local_steps=T,
                                         strategy="no_dropout")._client_update)
    return A, params, batches, shared_update


def _jax_sim(strategy):
    A, _, _, shared_update = _setup()
    sim = JaxSimulator(jax_loss, n_clients=N, strategy=strategy, A=A, p=P, local_steps=T)
    sim._client_update = shared_update
    return sim


@functools.cache
def rounds(strategy, masked):
    """Both packages' (params, metrics) after each of ROUNDS rounds."""
    _, jparams, batches, _ = _setup()
    active = ACTIVE if masked else None
    jsim = _jax_sim(strategy)
    tsim = FLSimulator(torch_loss, n_clients=N, strategy=strategy, A=jsim.A, p=P,
                       local_steps=T, relay_backend=BACKEND[strategy], device="cpu")
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
    js, ts = jsim.init_server_state(jparams), tsim.init_server_state(tparams)
    key = jax.random.key(7)
    out = []
    for r in range(ROUNDS):
        key, sub = jax.random.split(key)
        tau = jsim.sample_tau(sub)
        jparams, js, jm = jsim._round_math(
            jparams, js, jax.tree.map(jnp.asarray, batches[r]), tau, jsim.A, LR,
            None if active is None else jnp.asarray(active))
        tparams, ts, tm = tsim.run_round(None, tparams, ts, batches[r], LR, active=active,
                                         tau=np.array(tau))
        out.append((jax.tree.map(np.asarray, (jparams, jm)), (tparams, tm)))
    return out


def check_round(strategy, masked, round_idx):
    (jparams, jm), (tparams, tm) = rounds(strategy, masked)[round_idx]
    jl, tl = jax.tree.leaves(jparams), tree_flatten(tparams)[0]
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(b.numpy(), a, atol=1e-5, rtol=1e-5)
    for name in ("loss", "tau", "delta_norm"):
        np.testing.assert_allclose(tm[name].numpy(), jm[name], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("round_idx", range(ROUNDS))
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_rounds_match_jax(strategy, round_idx):
    check_round(strategy, False, round_idx)


@pytest.mark.parametrize("round_idx", range(ROUNDS))
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_churn_rounds_match_jax(strategy, round_idx):
    check_round(strategy, True, round_idx)


def test_shared_update_is_run_round():
    """The reference shortcut above is the JAX package's own run_round."""
    _, jparams, batches, _ = _setup()
    batch = jax.tree.map(jnp.asarray, batches[0])
    key = jax.random.key(3)
    sim = JaxSimulator(jax_loss, n_clients=N, strategy="colrel_fused", A=_setup()[0], p=P,
                       local_steps=T)
    want = sim.run_round(key, jparams, None, batch, LR)
    fast = _jax_sim("colrel_fused")
    got = fast._round_math(jparams, None, batch, fast.sample_tau(key), fast.A, LR, None)
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_tau_metric_is_masked_under_churn():
    (_, _), (_, tm) = rounds("colrel_fused", True)[0]
    assert tm["tau"][ACTIVE == 0].eq(0).all()


def test_sample_tau_from_generator():
    sim = FLSimulator(torch_loss, n_clients=N, strategy="colrel_fused", A=np.eye(N), p=P,
                      device="cpu")
    draws = torch.stack([sim.sample_tau(torch.Generator().manual_seed(s)) for s in range(2000)])
    np.testing.assert_allclose(draws.mean(0).numpy(), P, atol=0.04)
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    assert torch.equal(sim.sample_tau(g1), sim.sample_tau(g2))
    override = sim.sample_tau(torch.Generator().manual_seed(0), p=np.zeros(N))
    assert override.eq(0).all()
    nodrop = FLSimulator(torch_loss, n_clients=N, strategy="no_dropout", device="cpu")
    assert nodrop.sample_tau(torch.Generator().manual_seed(0)).eq(1).all()
