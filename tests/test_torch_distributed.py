"""The port's distributed round steps (``repro_torch.fl.distributed``)
against the JAX package's ``repro.fl.distributed`` on the same numpy inputs.

* Across packages, 1e-5: ``build_round_step`` (two rounds) and
  ``build_scan_round_step`` on the JAX package's initial params, batches and
  τ handed over as arrays (torch cannot draw threefry's numbers), for the
  scenario MLP and ResNet-20/GN on 8×8 images, paper-faithful and fused
  relay, T = 1 (the fused branch is the weighted-loss step) and T = 2,
  with and without a churn mask.  ResNet runs at lr 1e-3, as in
  ``tests/test_torch_engine.py`` (a ~1e-7 convolution difference can flip a
  ReLU at a larger lr).
* Within the port, bitwise: the scan step equals R calls of the round; the
  fused scan step, which draws τ from a ``torch.Generator``, equals R host
  draws (``torch.bernoulli``, the simulator's ``sample_tau``) followed by
  the scan step, generator state included.  And the T = 1 weighted-loss
  step within 1e-5 of the T = 1 per-client step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.bench.scenarios import _make_mlp as jax_make_mlp
from repro.configs.resnet20_cifar import CONFIG as JAX_CONFIG
from repro.fl import distributed as jax_dist
from repro.models.resnet import init_resnet20 as jax_init_resnet20
from repro.models.resnet import resnet20_loss as jax_resnet20_loss
from repro_torch.bench.scenarios import _make_mlp
from repro_torch.configs.resnet20_cifar import CONFIG
from repro_torch.core import connectivity, opt_alpha, topology
from repro_torch.core.aggregation import ServerOpt
from repro_torch.fl import distributed
from repro_torch.models.resnet import resnet20_loss
from repro_torch.utils import from_jax_params, tree_flatten


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    # the suite runs several test processes side by side
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _mlp_batch(rng, shape):
    return {"inputs": rng.standard_normal(shape + (16,)).astype(np.float32),
            "labels": rng.integers(0, 10, shape).astype(np.int32)}


def _resnet_batch(rng, shape):
    return {"images": rng.standard_normal(shape + (8, 8, 3)).astype(np.float32),
            "labels": rng.integers(0, 10, shape).astype(np.int32)}


MODELS = {
    # port loss, JAX loss, JAX initial params, batch maker, n, b, lr
    "mlp": (_make_mlp(16, 8, 10, torch.device("cpu"))[1], jax_make_mlp(16, 8, 10)[1],
            lambda: jax_make_mlp(16, 8, 10)[0](jax.random.key(0)), _mlp_batch, 6, 4, 0.1),
    "resnet20": (lambda p, b: resnet20_loss(p, CONFIG, b),
                 lambda p, b: jax_resnet20_loss(p, JAX_CONFIG, b),
                 lambda: jax_init_resnet20(jax.random.key(0), JAX_CONFIG),
                 _resnet_batch, 4, 2, 1e-3),
}


def _channel(n, seed=0):
    rng = np.random.default_rng(seed)
    p = connectivity.heterogeneous_profile(n).p
    A = opt_alpha.optimize(p, topology.ring(n, 1), sweeps=20).A
    active = np.ones(n, np.float32)
    active[1::3] = 0.0
    taus = (rng.random((3, n)) < p).astype(np.float32)
    return p, A, active, taus


def _close(got, want):
    got_l = [] if got is None else tree_flatten(got)[0]
    want_l = [] if want is None else jax.tree.leaves(want)
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)


def _equal(a, b) -> bool:
    la = [] if a is None else tree_flatten(a)[0]
    lb = [] if b is None else tree_flatten(b)[0]
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


@pytest.mark.parametrize("churn", [False, True], ids=["full", "churn"])
@pytest.mark.parametrize("T", [1, 2])
@pytest.mark.parametrize("mode", ["faithful", "fused"])
@pytest.mark.parametrize("model", ["mlp", "resnet20"])
def test_round_step_matches_jax(model, mode, T, churn):
    loss, jax_loss, init, make_batch, n, b, lr = MODELS[model]
    p, A, active, taus = _channel(n)
    act = active if churn else None
    server = dict(momentum=0.5)
    jround = jax.jit(jax_dist.build_round_step(
        jax_loss, n_clients=n, local_steps=T, relay_mode=mode,
        server_opt=jax_dist.ServerOpt(**server)))
    tround = distributed.build_round_step(
        loss, n_clients=n, local_steps=T, A=A, relay_mode=mode, server_opt=ServerOpt(**server))
    jparams = init()
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
    js, ts = jax_dist.ServerOpt(**server).init(jparams), ServerOpt(**server).init(tparams)
    rng = np.random.default_rng(7)
    for r in range(2):
        batch = make_batch(rng, (n, T, b))
        jparams, js, jloss = jround(jparams, js, jax.tree.map(jnp.asarray, batch),
                                    jnp.asarray(taus[r]), lr, jnp.asarray(A, jnp.float32),
                                    None if act is None else jnp.asarray(act))
        tparams, ts, tloss = tround(tparams, ts, batch, taus[r], lr, active=act)
        _close(tparams, jparams)
        _close(ts, js)
        np.testing.assert_allclose(float(tloss), float(jloss), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("model", ["mlp", "resnet20"])
def test_scan_step_equals_rounds_and_matches_jax(model):
    loss, jax_loss, init, make_batch, n, b, lr = MODELS[model]
    p, A, active, taus = _channel(n, seed=1)
    T, R = 2, 3
    batches = make_batch(np.random.default_rng(2), (R, n, T, b))
    kw = dict(n_clients=n, local_steps=T, relay_mode="fused")
    jparams = init()
    params = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
    scan = distributed.build_scan_round_step(loss, **kw)
    got_p, _, got_l = scan(params, None, batches, taus, lr, A=A, active=active)
    round = distributed.build_round_step(loss, **kw)
    want_p, losses = params, []
    for r in range(R):
        want_p, _, loss_r = round(want_p, None, {k: v[r] for k, v in batches.items()},
                                  taus[r], lr, A=A, active=active)
        losses.append(loss_r)
    assert _equal(got_p, want_p) and torch.equal(got_l, torch.stack(losses))
    jscan = jax.jit(jax_dist.build_scan_round_step(jax_loss, **kw))
    jp, _, jl = jscan(jparams, None, jax.tree.map(jnp.asarray, batches), jnp.asarray(taus),
                      lr, jnp.asarray(A, jnp.float32), jnp.asarray(active))
    _close(got_p, jp)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(jl), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("churn", [False, True], ids=["full", "churn"])
@pytest.mark.parametrize("mode", ["faithful", "fused"])
def test_fused_scan_draws_tau_like_the_host(mode, churn):
    """The τ-in-step scan equals R host draws then the scan step, bit for
    bit: params, losses and the advanced generator."""
    loss, _, init, make_batch, n, b, lr = MODELS["mlp"]
    p, A, active, _ = _channel(n)
    act = active if churn else None
    T, R = 2, 4
    batches = make_batch(np.random.default_rng(3), (R, n, T, b))
    params = from_jax_params(jax.tree.map(np.asarray, init()), device="cpu")
    kw = dict(n_clients=n, local_steps=T, relay_mode=mode)
    fused = distributed.build_fused_scan_round_step(loss, **kw)
    gen, got_p, _, got_l = fused(torch.Generator().manual_seed(9), params, None, batches,
                                 p, lr, A=A, active=act)
    host = torch.Generator().manual_seed(9)
    p32 = torch.as_tensor(p, dtype=torch.float32)
    taus = torch.stack([torch.bernoulli(p32, generator=host) for _ in range(R)])
    want_p, _, want_l = distributed.build_scan_round_step(loss, **kw)(
        params, None, batches, taus, lr, A=A, active=act)
    assert _equal(got_p, want_p) and torch.equal(got_l, want_l)
    assert torch.equal(gen.get_state(), host.get_state())


@pytest.mark.parametrize("model", ["mlp", "resnet20"])
def test_t1_weighted_loss_step_matches_the_per_client_step(model):
    """T = 1 fused never forms the (n, D) buffer; it is the same increment
    as the per-client fused step within 1e-5, and launches no kernel."""
    loss, _, init, make_batch, n, b, lr = MODELS[model]
    p, A, active, taus = _channel(n)
    params = from_jax_params(jax.tree.map(np.asarray, init()), device="cpu")
    batch = make_batch(np.random.default_rng(4), (n, 1, b))
    calls = []

    def constrain(buf, contract):
        calls.append(buf.shape)
        return contract(buf)

    weighted = distributed.build_round_step(loss, n_clients=n, local_steps=1, A=A,
                                            relay_mode="fused", constrain_buffer=constrain)
    per_client = distributed.build_round_step(loss, n_clients=n, local_steps=1, A=A,
                                              relay_mode="faithful",
                                              constrain_buffer=constrain)
    for act in (None, active):
        wp, _, wl = weighted(params, None, batch, taus[0], lr, active=act)
        assert calls == []  # no buffer formed
        cp, _, cl = per_client(params, None, batch, taus[0], lr, active=act)
        assert calls.pop() == (n, sum(x.numel() for x in tree_flatten(params)[0]))
        for x, y in zip(tree_flatten(wp)[0], tree_flatten(cp)[0]):
            np.testing.assert_allclose(x.numpy(), y.numpy(), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(float(wl), float(cl), atol=1e-6)


def test_round_step_needs_a_relay_matrix():
    loss, _, init, make_batch, n, b, lr = MODELS["mlp"]
    round = distributed.build_round_step(loss, n_clients=n, local_steps=1)
    params = from_jax_params(jax.tree.map(np.asarray, init()), device="cpu")
    with pytest.raises(ValueError, match="no relay matrix"):
        round(params, None, make_batch(np.random.default_rng(0), (n, 1, b)), np.ones(n), lr)
    with pytest.raises(ValueError, match="unknown relay_backend"):
        distributed.build_round_step(loss, n_clients=n, local_steps=1, relay_backend="pallas")
