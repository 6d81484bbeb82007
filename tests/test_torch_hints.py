"""The port's logical sharding hints (``repro_torch.sharding.hints``)
against the JAX package's contract (``tests/test_hints.py``): inert
without rules, a rank mismatch refused, indivisible dims unconstrained, a
DTensor moved to the mapped placements on 4 gloo ranks, and blockwise
attention bitwise unchanged with hints active."""
import numpy as np
import pytest
import torch

from repro_torch.sharding import hints


class FakeMesh:
    def __init__(self, **shape):
        self.shape = shape
        self.axis_names = tuple(shape)


def test_hint_noop_without_rules():
    x = torch.ones(4, 8)
    assert hints.hint(x, "batch", "qchunk") is x


def test_hint_rank_mismatch_rejected():
    from repro.sharding import hints as jax_hints

    x = torch.ones(4, 8)
    with hints.axis_rules(FakeMesh(model=2), {"qchunk": "model"}):
        with pytest.raises(ValueError, match="rank mismatch"):
            hints.hint(x, "batch")
    with jax_hints.axis_rules(FakeMesh(model=2), {"qchunk": "model"}):
        with pytest.raises(ValueError):  # the reference refuses it too
            jax_hints.hint(np.ones((4, 8)), "batch")


def test_hint_skips_indivisible_dims_and_rules_nest():
    x = torch.ones(3, 5)
    outer, inner = FakeMesh(model=16), FakeMesh(model=2)
    with hints.axis_rules(outer, {"batch": "model", "qchunk": "model"}):
        assert hints.hint(x, "batch", "qchunk") is x  # 3 % 16 and 5 % 16 ≠ 0
        with hints.axis_rules(inner, {"qchunk": "model"}):
            assert hints._rules.get()[0] is inner
        assert hints._rules.get()[0] is outer  # restored on exit
    assert hints._rules.get() is None
    # a plain tensor passes through even where a dim resolves: eager torch
    # has no partitioner to constrain
    with hints.axis_rules(FakeMesh(model=2), {"qchunk": "model"}):
        y = torch.ones(4, 8)
        assert hints.hint(y, None, "qchunk") is y


def test_hint_redistributes_a_dtensor_on_4_gloo_ranks():
    import torch_ranks

    from repro_torch.launch.mesh import run_ranks

    full = 2 * np.arange(32.0).reshape(4, 8)
    for rank, (placements, local, whole, again) in enumerate(
            run_ranks(torch_ranks.hint_redistributes, 4, num_threads=1)):
        assert placements == [("Shard", 0), ("Shard", 1)]
        d, m = divmod(rank, 2)  # row-major (data, model) coordinates
        np.testing.assert_array_equal(local, full[2 * d:2 * d + 2, 4 * m:4 * m + 4])
        np.testing.assert_array_equal(whole, full)
        assert again == [("Shard", 0), ("Replicate", None)]


def test_blockwise_attention_unchanged_by_hints():
    """Bitwise the same with a mapping active whose axes divide every hinted
    dim (so every hint resolves) and with one that divides none."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import attention as att

    cfg = ModelConfig(name="t", family="dense", n_layers=1, d_model=64, n_heads=4, n_kv=2,
                      d_ff=128, vocab=64, head_dim=16)
    rng = np.random.default_rng(0)
    B, S = 2, 256
    q = torch.as_tensor(rng.standard_normal((B, S, 4, 16)), dtype=torch.float32)
    k = torch.as_tensor(rng.standard_normal((B, S, 2, 16)), dtype=torch.float32)
    v = torch.as_tensor(rng.standard_normal((B, S, 2, 16)), dtype=torch.float32)
    pos = torch.arange(S, dtype=torch.int32)[None].expand(B, S)
    kw = dict(pos_q=pos, pos_k=pos, causal=True, window=0, cfg=cfg, q_chunk=64, kv_chunk=64)
    base = att.blockwise_gqa(q, k, v, **kw)
    for mesh, mapping in ((FakeMesh(data=2, model=2), {"batch": "data", "qchunk": "model"}),
                          (FakeMesh(model=1024), {"qchunk": "model"})):
        with hints.axis_rules(mesh, mapping):
            assert torch.equal(att.blockwise_gqa(q, k, v, **kw), base)
