"""The port's sharding rules (``repro_torch.sharding.rules``) against the JAX
package's, case for case of ``tests/test_sharding_rules.py``: pure shape
arithmetic over stub meshes, so the specs must be *equal* (a JAX
``PartitionSpec`` is a tuple, compared as ``tuple(spec)``).  Then the port's
meshes (``repro_torch.launch.mesh``) in one process: their axes, the
placements ``to_shardings`` gives, and the error when the world holds fewer
ranks than the mesh."""
import numpy as np
import pytest
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from repro.sharding import rules as jax_rules
from repro_torch.launch.mesh import (
    Mesh,
    make_client_mesh,
    make_local_mesh,
    make_production_mesh,
)
from repro_torch.sharding import rules


class StubMesh:
    """Just enough mesh for rule resolution: named axes and their sizes."""

    def __init__(self, **axes):
        self.axis_names = tuple(axes)
        self.shape = dict(axes)


CLIENT8 = StubMesh(clients=8)
MODEL4 = StubMesh(model=4)
PROD = StubMesh(data=4, model=4)
POD = StubMesh(pod=2, data=4, model=4)


def _as_tuples(tree):
    """A JAX spec tree with every PartitionSpec as a plain tuple."""
    if isinstance(tree, dict):
        return {k: _as_tuples(v) for k, v in tree.items()}
    return tuple(tree)


def _same(fn, *args, **kw):
    """The port's result, checked equal to the JAX package's on the same
    arguments."""
    got = getattr(rules, fn)(*args, **kw)
    want = getattr(jax_rules, fn)(*args, **kw)
    assert got == _as_tuples(want) if isinstance(want, (dict, tuple)) else got == want
    return got


# --------------------------------------------------------------------- axes


def test_shard_axis_prefers_clients_axis():
    assert _same("shard_axis", CLIENT8) == "clients"


def test_shard_axis_falls_back_to_client_axes():
    assert _same("shard_axis", PROD) == "data"
    assert _same("shard_axis", POD) == "pod"


def test_client_axes_single_and_multi_pod():
    assert _same("client_axes", PROD) == ("data",)
    assert _same("client_axes", POD) == ("pod", "data")
    assert rules.STACK_KEYS == jax_rules.STACK_KEYS


# --------------------------------------------- epoch-stacked round batches


def test_round_batch_specs_shards_dim1_only():
    batch = {"c": np.zeros((6, 8, 2, 4, 3)), "y": np.zeros((6, 8, 2, 4))}
    specs = _same("round_batch_specs", batch, CLIENT8)
    assert specs["c"] == (None, "clients", None, None, None)
    assert specs["y"] == (None, "clients", None, None)


def test_round_batch_specs_rank2_leaf():
    assert _same("round_batch_specs", {"m": np.zeros((6, 8))}, CLIENT8)["m"] == (None, "clients")


def test_round_batch_specs_on_production_mesh():
    assert _same("round_batch_specs", {"c": np.zeros((6, 8, 2))}, PROD)["c"] == (None, "data", None)


def test_train_batch_specs_shards_client_dim():
    specs = _same("train_batch_specs", {"c": np.zeros((8, 2, 4, 3))}, PROD)
    assert specs["c"] == ("data", None, None, None)  # one axis: its bare name
    specs = _same("train_batch_specs", {"c": np.zeros((8, 2))}, POD)
    assert specs["c"] == (("pod", "data"), None)


# ------------------------------------------------- flat (n, D) delta buffer


def test_flat_buffer_specs_divisible_d():
    assert _same("flat_buffer_specs", MODEL4, n=8, d=12) == (None, "model")


def test_flat_buffer_specs_indivisible_d_replicates():
    # a split that does not divide is worse than none
    assert _same("flat_buffer_specs", MODEL4, n=8, d=10) == (None, None)
    assert _same("flat_buffer_specs", MODEL4, n=8, d=2) == (None, None)


def test_flat_buffer_specs_no_model_axis_replicates():
    assert _same("flat_buffer_specs", CLIENT8, n=8, d=64) == (None, None)


def test_flat_buffer_specs_unknown_d_defers_to_the_caller():
    assert _same("flat_buffer_specs", MODEL4, n=8, d=None) == (None, "model")


# -------------------------------------------------------- parameter specs


def test_param_specs_tp_shards_largest_divisible_dim():
    params = {"w": np.zeros((8, 12)), "b": np.zeros((7,))}
    specs = _same("param_specs", params, PROD, mode="tp")
    assert specs["w"] == (None, "model")  # 12 > 8, both divide 4
    assert specs["b"] == (None,)  # 7 not divisible: replicated


def test_param_specs_fsdp_tp_adds_data_dim():
    assert _same("param_specs", {"w": np.zeros((8, 12))}, PROD, mode="fsdp_tp")["w"] == (
        "data", "model")


def test_param_specs_never_shards_stack_dims():
    params = {"blocks": {"w": np.zeros((3, 8, 8))}, "groups": {"selfs": {"w": np.zeros((2, 2, 8))}}}
    specs = _same("param_specs", params, PROD)
    # dim 0 is the stacked-layer dim; the tie between the two 8s resolves to
    # the later dim; a two-deep stack skips both leading dims
    assert specs["blocks"]["w"] == (None, None, "model")
    assert specs["groups"]["selfs"]["w"] == (None, None, "model")


# ------------------------------------------------------ serve batches, caches


def test_serve_batch_specs_shard_divisible_batches_only():
    batch = {"tokens": np.zeros((8, 16)), "one": np.zeros((1, 16)), "s": np.zeros(())}
    specs = _same("serve_batch_specs", batch, POD)
    assert specs["tokens"] == (("pod", "data"), None)
    assert specs["one"] == (None, None) and specs["s"] == ()


def test_cache_specs_batch_then_model_dim():
    cache = {"k": np.zeros((2, 8, 64, 4, 16)), "pos": np.zeros((2, 64)),
             "h": np.zeros((2, 5, 12))}
    specs = _same("cache_specs", cache, PROD, batch_size=8)
    assert specs["k"] == (None, "data", "model", None, None)
    assert specs["pos"] == (None, "model")
    assert specs["h"] == (None, None, "model")


# ------------------------------------------------------------ real meshes


def test_to_shardings_gives_placements():
    specs = {"c": (None, "clients"), "r": (None, None), "nest": [(("pod", "data"), None)]}
    got = rules.to_shardings(specs, StubMesh(clients=8))
    assert got["c"] == (Shard(1),) and got["r"] == (Replicate(),)
    got = rules.to_shardings({"x": (("pod", "data"), "model")}, POD)
    assert got["x"] == (Shard(0), Shard(0), Shard(1))
    assert rules.to_shardings([(None,)], PROD) == [(Replicate(), Replicate())]


def test_make_client_mesh_axis_naming():
    assert not dist.is_initialized()  # one process: a world of one rank
    mesh = make_client_mesh()
    assert mesh.axis_names == ("clients",) and mesh.shape == {"clients": 1}
    assert mesh.group is None and mesh.rank == 0
    assert make_client_mesh(1, axis="model").axis_names == ("model",)
    x = np.arange(6.0)
    assert mesh.all_gather(x) is x and mesh.all_reduce(x) is x  # identity


def test_make_client_mesh_too_many_devices_raises():
    with pytest.raises(RuntimeError, match="need 4096 devices"):
        make_client_mesh(4096)
    with pytest.raises(RuntimeError, match="need 256 devices"):
        make_production_mesh()
    with pytest.raises(RuntimeError, match="need 512 devices"):
        make_production_mesh(multi_pod=True)
    with pytest.raises(RuntimeError, match="need 4 devices"):
        make_local_mesh(2, 2)


def test_mesh_coordinates_are_row_major():
    mesh = Mesh(("data", "model"), (1, 1))
    assert mesh.coords(0) == {"data": 0, "model": 0}
    assert mesh.axis_size(("data", "model")) == 1 and mesh.axis_index("model") == 0
