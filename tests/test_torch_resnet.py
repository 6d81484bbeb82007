"""The port's ResNet-20/GN and client optimizers against the JAX package's,
on the JAX package's own initial parameters."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs.resnet20_cifar import CONFIG as JAX_CONFIG
from repro.models import resnet as jax_resnet
from repro.optim.sgd import ClientOpt as JaxClientOpt
from repro_torch.configs.resnet20_cifar import CONFIG
from repro_torch.models import resnet
from repro_torch.optim.sgd import ClientOpt
from repro_torch.utils import from_jax_params, tree_flatten, tree_size


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    # the suite runs several test processes side by side; torch's default of
    # one thread a core each would oversubscribe the machine
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def model():
    jp = jax.jit(jax_resnet.init_resnet20, static_argnums=1)(jax.random.key(0), JAX_CONFIG)
    rng = np.random.default_rng(0)
    batch = {"images": rng.standard_normal((3, 32, 32, 3)).astype(np.float32),
             "labels": rng.integers(0, 10, 3).astype(np.int32)}
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    return jp, tp, batch


def _torch_batch(batch):
    return {key: torch.from_numpy(v) for key, v in batch.items()}


def test_logits_and_loss_match_jax(model):
    jp, tp, batch = model
    want = jax.jit(jax_resnet.resnet20_logits, static_argnums=1)(
        jp, JAX_CONFIG, jnp.asarray(batch["images"]))
    got = resnet.resnet20_logits(tp, CONFIG, torch.from_numpy(batch["images"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    jl = jax.jit(jax_resnet.resnet20_loss, static_argnums=1)(
        jp, JAX_CONFIG, jax.tree.map(jnp.asarray, batch))
    tl = resnet.resnet20_loss(tp, CONFIG, _torch_batch(batch))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)


def test_gradients_match_jax(model):
    jp, tp, batch = model
    jg = jax.jit(jax.grad(jax_resnet.resnet20_loss), static_argnums=1)(
        jp, JAX_CONFIG, jax.tree.map(jnp.asarray, batch))
    tg = torch.func.grad(resnet.resnet20_loss)(tp, CONFIG, _torch_batch(batch))
    jl, tl = jax.tree.leaves(jg), tree_flatten(tg)[0]
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert tuple(b.shape) == a.shape
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-4)


def test_stride2_same_padding_regression():
    """XLA's SAME pads a stride-2 3×3 conv on an even input (0, 1);
    F.conv2d(padding=1) pads (1, 1) and is off.  The port follows XLA."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 32, 32, 16)).astype(np.float32)
    w = rng.standard_normal((3, 3, 16, 32)).astype(np.float32)
    want = np.asarray(jax_resnet._conv(jnp.asarray(w), jnp.asarray(x), stride=2))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = resnet._conv(torch.from_numpy(w), xt, stride=2).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-5)
    symmetric = F.conv2d(xt, torch.from_numpy(w).permute(3, 2, 0, 1), stride=2, padding=1)
    assert np.abs(symmetric.permute(0, 2, 3, 1).numpy() - want).max() > 1.0
    assert resnet._same_pad(32, 3, 2) == (0, 1)
    assert resnet._same_pad(32, 3, 1) == (1, 1)
    assert resnet._same_pad(32, 1, 2) == (0, 0)


def test_groupnorm_uses_population_variance():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 5, 16)).astype(np.float32) * 3 + 1
    p = {"scale": rng.standard_normal(16).astype(np.float32),
         "bias": rng.standard_normal(16).astype(np.float32)}
    want = np.asarray(jax_resnet._gn(jax.tree.map(jnp.asarray, p), jnp.asarray(x)))
    got = resnet._gn({k: torch.from_numpy(v) for k, v in p.items()},
                     torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_init_matches_reference_structure():
    jp = jax.eval_shape(lambda key: jax_resnet.init_resnet20(key, JAX_CONFIG), jax.random.key(1))
    tp = resnet.init_resnet20(1, CONFIG, device="cpu")
    assert tree_size(tp) == 272_282
    jl, tl = jax.tree.leaves(jp), tree_flatten(tp)[0]
    assert [a.shape for a in jl] == [tuple(b.shape) for b in tl]
    again = resnet.init_resnet20(1, CONFIG, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tl, tree_flatten(again)[0]))
    # He-normal conv weights, as the reference draws them
    assert abs(float(tp["stem"].std()) - (2.0 / 27) ** 0.5) < 0.05


@pytest.mark.parametrize("kind", ["sgd", "momentum", "adam"])
def test_client_opt_matches_jax(kind):
    rng = np.random.default_rng(3)
    params = {"w": rng.standard_normal((4, 3)).astype(np.float32),
              "b": rng.standard_normal(3).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(3)]
    jopt, topt = JaxClientOpt(kind=kind, weight_decay=1e-3), ClientOpt(kind=kind,
                                                                      weight_decay=1e-3)
    jp = jax.tree.map(jnp.asarray, params)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for g in grads:
        jp, js = jopt.step(jp, jax.tree.map(jnp.asarray, g), js, 0.05)
        tp, ts = topt.step(tp, {k: torch.from_numpy(v) for k, v in g.items()}, ts, 0.05)
    for a, b in zip(jax.tree.leaves(jp), tree_flatten(tp)[0]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError):
        ClientOpt(kind="lion").init(tp)
