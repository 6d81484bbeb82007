"""The port's checkpoint layer (``repro_torch.checkpoint``) against the JAX
package's ``tests/test_checkpoint.py`` and ``tests/test_resume.py``
contracts, and the npz layout both packages share.

* Layout, both ways: a tree of f32, bf16, f16 and int leaves in nested dicts
  and lists, and the ResNet-20/GN params, saved by one package restore
  bitwise in the other, and both packages write the same npz keys.
* The port's own contracts: round trip, shape and missing-leaf errors, the
  torn write, publish/rotate/prune, the momentum-free ``None`` state, and
  the generator state round trip.
* The one deliberate difference: the port stores ``torch.Generator`` state
  under ``rng_state`` where the JAX package stores threefry key data under
  ``rng_key``, so a JAX snapshot is refused by ``restore_training_state``
  (its params still load through ``restore``).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jax_checkpoint
from repro.configs.resnet20_cifar import CONFIG as JAX_CONFIG
from repro.models.resnet import init_resnet20 as jax_init_resnet20
from repro_torch import checkpoint
from repro_torch.utils import from_jax_params, tree_flatten, tree_map


def _jax_tree():
    return {
        "blocks": {"w": jnp.arange(12, dtype=jnp.float32).reshape(3, 4),
                   "b": (jnp.arange(4, dtype=jnp.float32) / 3).astype(jnp.bfloat16)},
        "head": [jnp.linspace(-1, 1, 4, dtype=jnp.float16).reshape(2, 2), jnp.int32(7),
                 {"idx": jnp.arange(5, dtype=jnp.int64 if jax.config.x64_enabled
                                    else jnp.int32)}],
    }


def _jax_resnet():
    return jax_init_resnet20(jax.random.key(0), JAX_CONFIG)


TREES = {"mixed": _jax_tree, "resnet20": _jax_resnet}


def _port(jax_tree):
    return from_jax_params(jax.tree.map(np.asarray, jax_tree))


def _bits(x) -> np.ndarray:
    """A leaf's bytes as a flat uint8 array (bitwise comparison of any
    dtype, bf16 included)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.contiguous().numpy().reshape(-1).view(np.uint8)
    x = np.asarray(x)
    return np.ascontiguousarray(x).reshape(-1).view(np.uint8)


def _assert_bitwise(got, want_leaves):
    got_leaves = tree_flatten(got)[0] if not isinstance(got, list) else got
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        assert tuple(g.shape) == tuple(np.shape(w))
        np.testing.assert_array_equal(_bits(g), _bits(w))


@pytest.mark.parametrize("tree", sorted(TREES))
def test_both_packages_write_the_same_npz(tree, tmp_path):
    jt = TREES[tree]()
    jax_checkpoint.save(str(tmp_path / "jax.npz"), jt)
    checkpoint.save(str(tmp_path / "port.npz"), _port(jt))
    with np.load(tmp_path / "jax.npz") as a, np.load(tmp_path / "port.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key])
    if tree == "mixed":
        assert "__bf16__:blocks/b" in a.files and "head/2/idx" in a.files


@pytest.mark.parametrize("tree", sorted(TREES))
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_restores_across_packages_bitwise(tree, direction, tmp_path):
    jt = TREES[tree]()
    path = str(tmp_path / "ckpt.npz")
    if direction == "jax_to_port":
        jax_checkpoint.save(path, jt)
        got = checkpoint.restore(path, tree_map(torch.zeros_like, _port(jt)))
        for g, w in zip(tree_flatten(got)[0], tree_flatten(_port(jt))[0]):
            assert g.dtype == w.dtype
    else:
        checkpoint.save(path, _port(jt))
        got = jax_checkpoint.restore(path, jax.tree.map(jnp.zeros_like, jt))
        got = jax.tree.leaves(got)
        for g, w in zip(got, jax.tree.leaves(jt)):
            assert g.dtype == w.dtype
    _assert_bitwise(got, [np.asarray(x) for x in jax.tree.leaves(jt)])


def test_roundtrip(tmp_path):
    t = _port(_jax_tree())
    path = str(tmp_path / "ckpt.npz")
    checkpoint.save(path, t, metadata={"round": 3, "arch": "x"})
    got = checkpoint.restore(path, tree_map(torch.zeros_like, t))
    for a, b in zip(tree_flatten(t)[0], tree_flatten(got)[0]):
        assert a.dtype == b.dtype and a.device == b.device
        assert torch.equal(a, b)
    assert checkpoint.load_metadata(path) == {"round": 3, "arch": "x"}


def test_restore_takes_the_like_leaves_dtype(tmp_path):
    path = str(tmp_path / "ckpt.npz")
    checkpoint.save(path, {"x": torch.arange(4, dtype=torch.float32)})
    got = checkpoint.restore(path, {"x": torch.zeros(4, dtype=torch.float64)})["x"]
    assert got.dtype == torch.float64 and torch.equal(got, torch.arange(4.0, dtype=torch.float64))
    got = checkpoint.restore(path, {"x": np.zeros(4, np.float32)})["x"]
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32


def test_shape_mismatch_rejected(tmp_path):
    t = _port(_jax_tree())
    path = str(tmp_path / "ckpt.npz")
    checkpoint.save(path, t)
    bad = tree_map(lambda x: torch.zeros(tuple(x.shape) + (1,), dtype=x.dtype), t)
    with pytest.raises(ValueError, match="shape"):
        checkpoint.restore(path, bad)


def test_missing_leaf_rejected(tmp_path):
    t = _port(_jax_tree())
    path = str(tmp_path / "ckpt.npz")
    checkpoint.save(path, t)
    with pytest.raises(KeyError, match="extra"):
        checkpoint.restore(path, {**t, "extra": torch.zeros(1)})


def test_generator_state_round_trips_bitwise(tmp_path):
    gen = torch.Generator().manual_seed(5)
    torch.rand(17, generator=gen)  # move it off its seed
    path = str(tmp_path / "state.npz")
    params = {"x": torch.arange(4.0)}
    checkpoint.save_training_state(path, params=params, server_state=None,
                                   generator=gen, round=9)
    meta = checkpoint.load_metadata(path)
    assert meta["rng"] == {"impl": "torch", "device": "cpu"} and meta["round"] == 9
    with np.load(path) as z:
        assert z["rng_state"].dtype == np.uint8 and "rng_key" not in z.files
    rp, rs, rgen, rnd = checkpoint.restore_training_state(
        path, params_like={"x": torch.zeros(4)})
    assert rs is None and rnd == 9 and torch.equal(rp["x"], params["x"])
    assert rgen is not gen and torch.equal(rgen.get_state(), gen.get_state())
    assert torch.equal(torch.rand(8, generator=rgen), torch.rand(8, generator=gen))


def test_jax_snapshot_is_refused_by_restore_training_state(tmp_path):
    path = str(tmp_path / "jax_state.npz")
    params = {"x": jnp.arange(4.0)}
    jax_checkpoint.save_training_state(path, params=params, server_state={"x": jnp.ones(4)},
                                       key=jax.random.key(3), round=5)
    with pytest.raises(ValueError, match="rng_key.*threefry"):
        checkpoint.restore_training_state(path, params_like={"x": torch.zeros(4)},
                                          server_state_like={"x": torch.zeros(4)})
    # the params still cross over
    got = checkpoint.restore(path, {"params": {"x": torch.zeros(4)}})["params"]["x"]
    assert torch.equal(got, torch.arange(4.0))


def test_momentum_free_snapshot_round_trips_none_server_state(tmp_path):
    params = {"x": torch.arange(4.0)}
    gen = torch.Generator().manual_seed(3)
    path = str(tmp_path / "nomom.npz")
    checkpoint.save_training_state(path, params=params, server_state=None, generator=gen,
                                   round=5)
    rp, rs, rgen, rnd = checkpoint.restore_training_state(
        path, params_like={"x": torch.zeros(4)})
    assert rs is None and rnd == 5 and torch.equal(rp["x"], params["x"])
    assert torch.equal(rgen.get_state(), gen.get_state())
    # a momentum-carrying snapshot refuses restore without the like tree
    path2 = str(tmp_path / "mom.npz")
    checkpoint.save_training_state(path2, params=params, server_state={"x": torch.ones(4)},
                                   generator=gen, round=5)
    with pytest.raises(ValueError, match="server-optimizer state"):
        checkpoint.restore_training_state(path2, params_like={"x": torch.zeros(4)})
    _, rs2, _, _ = checkpoint.restore_training_state(
        path2, params_like={"x": torch.zeros(4)}, server_state_like={"x": torch.zeros(4)})
    assert torch.equal(rs2["x"], torch.ones(4))


def test_publish_rotates_latest_and_prunes(tmp_path):
    d = str(tmp_path / "ckpts")
    gen = torch.Generator().manual_seed(0)
    for rnd in (10, 20, 30):
        checkpoint.publish(d, params={"x": torch.full((4,), float(rnd))}, server_state=None,
                           generator=gen, round=rnd, keep=2)
    latest = checkpoint.latest_checkpoint(d)
    assert latest is not None and latest.endswith("ckpt_00000030.npz")
    snaps = sorted(f for f in os.listdir(d) if f.startswith("ckpt_") and f.endswith(".npz"))
    assert snaps == ["ckpt_00000020.npz", "ckpt_00000030.npz"]  # keep=2
    assert not os.path.exists(os.path.join(d, "ckpt_00000010.npz.meta.json"))
    rp, _, _, rnd = checkpoint.restore_training_state(latest, params_like={"x": torch.zeros(4)})
    assert rnd == 30 and float(rp["x"][0]) == 30.0
    assert checkpoint.latest_checkpoint(str(tmp_path / "nothing")) is None


@pytest.mark.parametrize("where", ["savez", "os_replace"])
def test_torn_write_leaves_previous_snapshot_loadable(where, tmp_path, monkeypatch):
    """A crash mid-save (``np.savez`` raising after the tmp file opened, or
    the rename failing) leaves the LATEST pointer and the previous snapshot
    intact, and no stray tmp file."""
    d = str(tmp_path / "ckpts")
    params = {"x": torch.ones(4)}
    gen = torch.Generator().manual_seed(0)
    checkpoint.publish(d, params=params, server_state=None, generator=gen, round=1)
    before = checkpoint.latest_checkpoint(d)

    def torn_savez(f, **arrs):
        f.write(b"partial garbage")
        raise OSError("disk full")

    def torn_replace(src, dst):
        raise OSError("disk full")

    if where == "savez":
        monkeypatch.setattr(np, "savez", torn_savez)
    else:
        monkeypatch.setattr(os, "replace", torn_replace)
    with pytest.raises(OSError, match="disk full"):
        checkpoint.publish(d, params=params, server_state=None, generator=gen, round=2)
    monkeypatch.undo()

    assert checkpoint.latest_checkpoint(d) == before
    assert not os.path.exists(os.path.join(d, "ckpt_00000002.npz"))
    rp, _, _, rnd = checkpoint.restore_training_state(before, params_like={"x": torch.zeros(4)})
    assert rnd == 1 and torch.equal(rp["x"], params["x"])
    assert not [f for f in os.listdir(d) if f.endswith(".tmp")]
