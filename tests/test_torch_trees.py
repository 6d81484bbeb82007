"""The port's pytree and ravel layer against the JAX package's
(``repro_torch.utils.trees`` vs ``repro.utils.trees``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.resnet20_cifar import CONFIG as JAX_CONFIG
from repro.models.resnet import init_resnet20 as jax_init_resnet20
from repro.utils import stacked_ravel as jax_stacked_ravel
from repro.utils import tree_ravel as jax_tree_ravel
from repro_torch.utils import (
    from_jax_params,
    stacked_ravel,
    tree_flatten,
    tree_map,
    tree_ravel,
    tree_size,
    tree_unflatten,
    tree_unravel,
)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def test_flatten_sorts_dict_keys_like_jax():
    """torch.utils._pytree keeps insertion order; the port sorts, as JAX."""
    tree = {"b": np.ones(2), "a": {"z": np.zeros(1), "c": np.ones(3)}, "aa": [np.ones(1)]}
    jax_leaves = jax.tree.leaves(tree)
    port_leaves, treedef = tree_flatten(tree)
    assert [x.shape for x in port_leaves] == [x.shape for x in jax_leaves]
    assert all(x is y for x, y in zip(port_leaves, jax_leaves))
    back = tree_unflatten(treedef, port_leaves)
    assert list(back) == ["a", "aa", "b"] and list(back["a"]) == ["c", "z"]


def test_resnet20_stacked_ravel_bitwise_equal_to_jax():
    """The (n, D) buffer of a stacked ResNet-20 tree matches JAX's column by
    column, bit for bit."""
    n = 3
    params = jax.eval_shape(lambda key: jax_init_resnet20(key, JAX_CONFIG), jax.random.key(0))
    rng = np.random.default_rng(0)
    stacked = jax.tree.map(
        lambda x: jnp.asarray(rng.standard_normal((n, *x.shape)), jnp.float32), params
    )
    want, jspec = jax_stacked_ravel(stacked)
    got, spec = stacked_ravel(from_jax_params(_np_tree(stacked), device="cpu"))
    assert spec.total == jspec.total == 272_282
    assert spec.shapes == jspec.shapes
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_ravel_round_trip_bit_exact(dtype):
    rng = np.random.default_rng(1)
    tree = {
        "w": jnp.asarray(rng.standard_normal((4, 5)), dtype),
        "b": jnp.asarray(rng.standard_normal((7,)), dtype),
        "nested": {"k": jnp.asarray(rng.standard_normal((2, 3)), dtype)},
    }
    jflat, _ = jax_tree_ravel(tree)
    port_tree = from_jax_params(_np_tree(tree), device="cpu")
    flat, spec = tree_ravel(port_tree)
    assert flat.dtype == torch.float32
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))
    back = tree_unravel(spec, flat)
    for a, b in zip(tree_flatten(back)[0], tree_flatten(port_tree)[0]):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)
    kept = tree_unravel(spec, flat, cast=False)
    assert all(x.dtype == torch.float32 for x in tree_flatten(kept)[0])


@pytest.mark.parametrize("dtype", [torch.int32, torch.float64])
def test_ravel_refuses_inexact_dtypes(dtype):
    tree = {"x": torch.zeros(3, dtype=dtype)}
    with pytest.raises(TypeError, match="not exactly representable"):
        tree_ravel(tree)
    with pytest.raises(TypeError, match="not exactly representable"):
        stacked_ravel({"x": torch.zeros(2, 3, dtype=dtype)})


def test_stacked_ravel_rejects_ragged_client_dim():
    with pytest.raises(ValueError, match="client"):
        stacked_ravel({"a": torch.zeros(2, 3), "b": torch.zeros(3, 3)})


def test_unravel_rejects_wrong_length():
    _, spec = tree_ravel({"a": torch.zeros(4)})
    with pytest.raises(ValueError, match="buffer shape"):
        tree_unravel(spec, torch.zeros(5))


def test_from_jax_params_keeps_bf16_bits_and_structure():
    rng = np.random.default_rng(2)
    tree = {"x": jnp.asarray(rng.standard_normal((3, 4)), jnp.bfloat16),
            "y": (jnp.arange(3, dtype=jnp.int32), jnp.ones((2,), jnp.float32))}
    got = from_jax_params(_np_tree(tree), device="cpu")
    assert got["x"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["x"].float().numpy(),
                                  np.asarray(tree["x"], np.float32))
    assert isinstance(got["y"], tuple) and got["y"][0].dtype == torch.int32
    assert tree_size(got) == 12 + 3 + 2
    doubled = tree_map(lambda a: a * 2, got["y"])
    assert doubled[1].tolist() == [2.0, 2.0]


def test_namedtuples_and_none_keep_their_structure_like_jax():
    """A NamedTuple comes back as its own type and None is a node without
    leaves, as in ``jax.tree``: an EdgeRelay survives ``tree_map``."""
    import collections

    Pair = collections.namedtuple("Pair", ["a", "b"])
    tree = {"p": Pair(np.arange(3.0), None), "q": (np.ones(2), None)}
    leaves, treedef = tree_flatten(tree)
    assert len(leaves) == len(jax.tree.leaves(tree)) == 2
    back = tree_unflatten(treedef, leaves)
    assert type(back["p"]) is Pair and back["p"].b is None and back["q"][1] is None
    doubled = tree_map(lambda x: 2 * x, tree)
    assert type(doubled["p"]) is Pair
    assert np.array_equal(doubled["p"].a, 2 * np.arange(3.0))
    want = jax.tree.map(lambda x: 2 * x, tree)
    assert type(want["p"]) is Pair and want["p"].b is None
