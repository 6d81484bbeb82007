"""The port's dry run (``repro_torch.launch.dryrun``) beside the JAX
package's (``tests/test_sharding_dryrun.py``): every assigned arch's
parameter specs on the production mesh equal to the reference's and cut
without a remainder, a miniature dry run of glm4-9b ``reduced()`` on a
(2, 2, 2) pod × data × model mesh whose per-device bytes are the
``local_shard`` blocks, and a failure recorded as an error."""
import math

import jax
import jax.numpy as jnp
import pytest
import torch

from repro_torch.configs import registry as creg
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import MeshShape, make_production_mesh
from repro_torch.models import registry as mreg
from repro_torch.sharding import rules
from repro_torch.utils import tree_flatten


class FakeMesh:
    """The reference's rules read only the axes and their sizes."""

    def __init__(self, mesh):
        self.axis_names, self.shape = mesh.axis_names, dict(mesh.shape)


def _spec_leaves(tree) -> list:
    """A port spec tree's specs in leaf order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _spec_leaves(tree[k])]
    if isinstance(tree, list):
        return [s for v in tree for s in _spec_leaves(v)]
    return [tuple(tree)]


def _nbytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_flatten(tree)[0])


@pytest.mark.parametrize("arch", creg.ASSIGNED)
def test_every_assigned_arch_resolves_its_specs_on_pod16x16(arch):
    from repro.configs import registry as jax_creg
    from repro.models import registry as jax_mreg
    from repro.sharding import rules as jax_rules

    mesh = make_production_mesh(shape_only=True)
    assert mesh.size == 256 and mesh.group is None
    params = dryrun._meta_params(mreg.get_model(creg.get_config(arch)))
    jparams = jax.eval_shape(jax_mreg.get_model(jax_creg.get_config(arch)).init,
                             jax.ShapeDtypeStruct((2,), jnp.uint32))
    leaves = tree_flatten(params)[0]
    assert [tuple(x.shape) for x in leaves] == [tuple(x.shape) for x in jax.tree.leaves(jparams)]
    for mode in ("tp", "fsdp_tp"):
        specs = rules.param_specs(params, mesh, mode)
        jspecs = jax.tree.leaves(jax_rules.param_specs(jparams, FakeMesh(mesh), mode),
                                 is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        assert _spec_leaves(specs) == [tuple(s) for s in jspecs]
        local = tree_flatten(rules.local_shard(params, specs, mesh))[0]  # raises on a remainder
        for leaf, block, spec in zip(leaves, local, _spec_leaves(specs)):
            split = math.prod(mesh.axis_size(a) for a in spec if a is not None)
            assert block.numel() * split == leaf.numel()


def _local_sum(trees, specs, mesh) -> int:
    total = 0
    for tree, spec in zip(trees, specs):
        if isinstance(tree, torch.Tensor):
            tree, spec = [tree], [spec]
        if tree is not None:
            total += _nbytes(rules.local_shard(tree, spec, mesh))
    return total


@pytest.mark.parametrize("shape_name", ["train_4k", "decode_32k"])
def test_mini_dryrun_per_device_bytes_are_the_local_shards(tmp_path, shape_name):
    mesh = MeshShape(("pod", "data", "model"), (2, 2, 2))
    rec = dryrun.run_one("glm4-9b", shape_name, multi_pod=True, mesh=mesh, reduced=True,
                         out_dir=str(tmp_path))
    assert rec["status"] == "ok", rec.get("traceback")
    build = (dryrun.build_train_lowering if shape_name == "train_4k"
             else dryrun.build_serve_lowering)
    lowered, cfg, shape = build("glm4-9b", shape_name, mesh, reduced=True)
    assert rec["per_device"]["argument_bytes"] == _local_sum(lowered.args, lowered.arg_specs, mesh)
    assert rec["chips"] == 8 and rec["collective_bytes_per_device"] is None
    assert rec["per_device"]["flops"] == rec["global"]["flops"] / 8 > 0
    assert rec["model_flops_global"] == dryrun.model_flops(cfg, INPUT_SHAPES[shape_name])
    assert (tmp_path / f"glm4-9b__{shape_name}.json").exists()
    if shape_name == "train_4k":
        # n = pod × data = 4 clients of 64 sequences, the batch split over them
        assert lowered.args[2]["tokens"].shape == (4, 1, 64, 4096)


def test_failure_is_recorded_as_an_error(tmp_path, monkeypatch):
    def indivisible(*a, **k):
        raise ValueError("dim 0 of size 3 does not divide over 2 ranks of data")

    monkeypatch.setattr(dryrun, "build_serve_lowering", indivisible)
    rec = dryrun.run_one("glm4-9b", "prefill_32k", multi_pod=False, out_dir=str(tmp_path))
    assert rec["status"] == "error" and "does not divide" in rec["error"]
    skipped = [(a, s) for a in creg.ASSIGNED for s in INPUT_SHAPES if creg.is_skipped(a, s)]
    if skipped:
        a, s = skipped[0]
        assert dryrun.run_one(a, s, multi_pod=False, out_dir=str(tmp_path))["status"] == "skipped"
