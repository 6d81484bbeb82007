"""The port's loop-aware cost model (``repro_torch.launch.hlo_cost``) on
known-FLOP programs, beside the JAX package's (``tests/test_hlo_cost.py``).
The port counts every dispatched op, so a loop is counted once a trip and
its FLOPs are exact; the reference reconstructs the trips from HLO text."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.launch import hlo_cost as jax_hlo_cost
from repro_torch.launch import hlo_cost


def _meta(*shape):
    return torch.empty(shape, device="meta")


def _jax_flops(f, *shapes):
    specs = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    return jax_hlo_cost.analyze(jax.jit(f).lower(*specs).compile().as_text())["flops"]


def _layers(w, x):
    for wi in w:
        x = torch.tanh(x @ wi)
    return x.sum()


def _jax_layers(w, x):
    y, _ = jax.lax.scan(lambda x, wi: (jnp.tanh(x @ wi), None), x, w)
    return y.sum()


def test_loop_trip_count_multiplies_flops():
    L, B, D = 7, 8, 32
    want = L * 2 * B * D * D
    res = hlo_cost.analyze(_layers, _meta(L, D, D), _meta(B, D))
    assert res["flops"] == want
    # the reference's parser reconstructs the scan's trips to within 5%
    assert abs(_jax_flops(_jax_layers, (L, D, D), (B, D)) - want) / want < 0.05
    # bytes: at least every matmul's operands and result, once a layer
    assert res["hbm_bytes"] >= L * 4 * (B * D + D * D + B * D)


def test_grad_of_loop_counts_three_dots_per_layer():
    L, B, D = 5, 4, 16
    grad = torch.func.grad(_layers, argnums=(0, 1))
    res = hlo_cost.analyze(grad, _meta(L, D, D), _meta(B, D))
    assert res["flops"] == L * 3 * 2 * B * D * D  # fwd + dx + dw


def test_unlooped_dot_exact():
    def f(a, b):
        return (a @ b).sum()

    res = hlo_cost.analyze(f, _meta(32, 64), _meta(64, 16))
    assert res["flops"] == 2 * 32 * 64 * 16 == _jax_flops(f, (32, 64), (64, 16))
    assert res["collectives"] == {"total": 0.0}


def test_nested_loops_multiply():
    def f(x):
        for _ in range(4):
            for _ in range(3):
                x = torch.tanh(x @ x)
        return x.sum()

    assert hlo_cost.analyze(f, _meta(8, 8))["flops"] == 4 * 3 * 2 * 8 * 8 * 8


def test_collectives_counted_with_shapes_on_2_gloo_ranks():
    """An all_reduce, an all_gather, a reduce-scatter and a send/recv pair
    of a (4, 6) f32 block: each kind's result bytes, the same on both
    ranks; a one-device step has none (the reference's case)."""
    import torch_ranks

    from repro_torch.launch.mesh import run_ranks

    block = 4 * 6 * 4
    want = {"all-reduce": block, "all-gather": 2 * block, "reduce-scatter": block // 2,
            "collective-permute": block}
    for res in run_ranks(torch_ranks.collectives_counted, 2, num_threads=1):
        assert res["collectives"] == {**want, "total": float(sum(want.values()))}
        assert res["flops"] == 0.0
    assert hlo_cost.analyze(lambda x: x * 2, torch.ones(8))["collectives"]["total"] == 0.0
    assert np.isclose(hlo_cost.analyze(lambda x: x * 2, torch.ones(8))["hbm_bytes"], 64.0)
