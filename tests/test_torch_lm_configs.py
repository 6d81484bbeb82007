"""The port's LM configs against the JAX package's: every registered config,
full and ``reduced()``, field by field; the analytic parameter counts;
``for_shape``, ``is_skipped`` and ``INPUT_SHAPES``; and ``input_specs``
(shapes and dtypes, on the ``meta`` device) for every family and shape
kind."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jax_base
from repro.configs import registry as jax_creg
from repro.models import registry as jax_mreg
from repro_torch.configs import base, registry
from repro_torch.models import get_model, input_specs

ALL = list(registry.ARCHS)
SUB_CONFIGS = ("moe", "ssm", "rglru")


def _fields(cfg):
    out = {}
    for f in dataclasses.fields(cfg):
        value = getattr(cfg, f.name)
        out[f.name] = _fields(value) if dataclasses.is_dataclass(value) else value
    return out


def test_registry_lists_the_reference_archs():
    assert registry.ARCHS == jax_creg.ARCHS
    assert registry.ASSIGNED == jax_creg.ASSIGNED
    assert len(registry.ASSIGNED) == 10


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ALL)
def test_config_equals_reference(arch, reduced):
    cfg = registry.get_config(arch, reduced=reduced)
    want = jax_creg.get_config(arch, reduced=reduced)
    assert _fields(cfg) == _fields(want)
    assert cfg.hd == want.hd
    assert cfg.param_count() == want.param_count()
    assert cfg.active_param_count() == want.active_param_count()
    assert cfg.pdtype == torch.float32 and cfg.cdtype == torch.float32
    for sub in SUB_CONFIGS:
        if getattr(cfg, sub) is not None:
            assert type(getattr(cfg, sub)).__module__ == "repro_torch.configs.base"


@pytest.mark.parametrize("cls", ["ModelConfig", "MoEConfig", "SSMConfig", "RGLRUConfig",
                                 "ShapeConfig"])
def test_config_classes_keep_the_reference_fields_and_defaults(cls):
    def fields(c):
        return [(f.name, f.default) for f in dataclasses.fields(c)]

    assert fields(getattr(base, cls)) == fields(getattr(jax_base, cls))


def test_glm4_full_param_count():
    """The served model: 9,399,767,040 parameters, 37.6 GB in f32."""
    cfg = registry.get_config("glm4-9b")
    assert cfg.param_count() == 9_399_767_040
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd, cfg.d_ff, cfg.vocab) == (
        40, 4096, 32, 2, 128, 13696, 151552)


def test_input_shapes_equal_reference():
    assert {k: dataclasses.astuple(v) for k, v in base.INPUT_SHAPES.items()} == {
        k: dataclasses.astuple(v) for k, v in jax_base.INPUT_SHAPES.items()}


@pytest.mark.parametrize("shape", list(base.INPUT_SHAPES))
@pytest.mark.parametrize("arch", ALL)
def test_for_shape_and_is_skipped_equal_reference(arch, shape):
    got = registry.for_shape(registry.get_config(arch), base.INPUT_SHAPES[shape])
    want = jax_creg.for_shape(jax_creg.get_config(arch), jax_base.INPUT_SHAPES[shape])
    assert _fields(got) == _fields(want)
    assert registry.is_skipped(arch, shape) == jax_creg.is_skipped(arch, shape)


_DTYPES = {jnp.dtype(jnp.int32): torch.int32, jnp.dtype(jnp.float32): torch.float32}


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ALL)
def test_input_specs_equal_reference(arch, kind):
    shape = base.ShapeConfig("t", 512, 4, kind)
    jshape = jax_base.ShapeConfig("t", 512, 4, kind)
    cfg, jcfg = registry.get_config(arch, reduced=True), jax_creg.get_config(arch, reduced=True)
    got = get_model(cfg).input_specs(shape, batch_override=2)
    want = jax_mreg.input_specs(jcfg, jshape, batch_override=2)
    assert got.keys() == want.keys()
    for name, spec in got.items():
        assert spec.device.type == "meta"
        assert tuple(spec.shape) == want[name].shape
        assert spec.dtype == _DTYPES[np.dtype(want[name].dtype)]
    assert input_specs(cfg, shape).keys() == want.keys()


def test_get_model_rejects_unknown_family():
    with pytest.raises(ValueError):
        get_model(dataclasses.replace(registry.get_config("glm4-9b"), family="nope"))


@pytest.mark.parametrize("arch", list(registry.ASSIGNED))
def test_init_cache_equals_reference(arch):
    """``init_cache`` (the decode stand-in at a given length): the JAX
    package's leaves, shapes, dtypes and values, on the requested device."""
    import jax

    from repro_torch.utils import tree_flatten

    got = get_model(registry.get_config(arch, reduced=True)).init_cache(2, 80, device="cpu")
    want = jax_mreg.get_model(jax_creg.get_config(arch, reduced=True)).init_cache(2, 80)
    got_leaves, want_leaves = tree_flatten(got)[0], jax.tree.leaves(want)
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert g.dtype == _DTYPES[np.dtype(w.dtype)]
