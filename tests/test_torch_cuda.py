"""The CUDA kernels on the card against their plain torch versions.

Needs an NVIDIA GPU (and nvcc to build the kernels); skips without one.  The
file imports neither jax nor the JAX package, so it also runs on a machine
that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""
import math

import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels import relay_mix as k

pytestmark = pytest.mark.cuda

# f32: sum order differs from cuBLAS, atol 1e-5 + rtol 1e-5; bf16: one bf16
# ulp of the output (rtol 2^-7) + the same atol
TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-5, 2.0**-7)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(n, D, dtype, dev, layout="contiguous"):
    """A, c and Δ (n, D) from a seed; Δ contiguous, or a row slice big[1:] of
    an (n + 1, D) buffer, or an (n, D) view of a flat buffer from its second
    element (both contiguous, their base addresses offset by a row or by one
    element)."""
    gen = torch.Generator(device=dev).manual_seed(n * 100_003 + D)
    A = torch.randn(n, n, generator=gen, device=dev) / math.sqrt(n)
    c = torch.randn(n, generator=gen, device=dev) / math.sqrt(n)
    if layout == "contiguous":
        d = torch.randn(n, D, generator=gen, device=dev).to(dtype)
    elif layout == "row_slice":
        d = torch.randn(n + 1, D, generator=gen, device=dev).to(dtype)[1:]
    else:
        d = torch.randn(n * D + 1, generator=gen, device=dev).to(dtype)[1:].view(n, D)
    return A, c, d


def _vec_bytes(d):
    """The fused kernel's alignment rule: the widest of 16, 8 or 4 bytes that
    divides Δ's base address and its row pitch (the output, from torch's
    allocator, is aligned), else one element."""
    e = d.element_size()
    for w in (16, 8, 4):
        if w > e and d.data_ptr() % w == 0 and d.shape[1] * e % w == 0:
            return w
    return e


# besides the main path's n = 10 and D = 272,282: D below one vector (1, 3)
# and odd (4,097, 272,283); n across the fused kernel's origin chunks (6
# with 16-byte, 12 with 8-byte, 24 with 4- and 2-byte loads; 16 for a
# chunk of 16) and beyond the 1,024 coefficients it stages at once; Δ's base
# address off 16 bytes
@pytest.mark.parametrize("layout", ["contiguous", "row_slice", "elem_offset"])
@pytest.mark.parametrize("n", [1, 7, 10, 12, 13, 15, 16, 17, 24, 25, 64, 128, 300, 1030])
@pytest.mark.parametrize("D", [1, 3, 100, 4097, 5000, 272_282, 272_283])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain_versions(dev, n, D, dtype, layout):
    A, c, d = _inputs(n, D, dtype, dev, layout)
    atol, rtol = TOL[dtype]
    before = dict(k.LAUNCHES)
    torch.testing.assert_close(k.relay_mix_2d(A, d).float(),
                               ref.relay_mix_2d(A.to(dtype), d).float(), atol=atol, rtol=rtol)
    u = k.fused_aggregate_2d(c, d)
    torch.testing.assert_close(u.float(), ref.fused_aggregate_2d(c.to(dtype), d).float(),
                               atol=atol, rtol=rtol)
    assert torch.equal(k.fused_aggregate_2d(c, d), u)  # no atomics: bitwise repeatable
    torch.cuda.synchronize()
    assert k.LAUNCHES["relay_mix_2d"] == before["relay_mix_2d"] + 1
    assert k.LAUNCHES["fused_aggregate_2d"] == before["fused_aggregate_2d"] + 2
    plan = k.fused_aggregate_plan(d)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert plan["vec_bytes"] == _vec_bytes(d)
    assert 1 <= plan["grid"] <= sms * plan["blocks_per_sm"]


def test_relay_mix_backward_on_card(dev):
    A, _, d = _inputs(6, 3001, torch.float32, dev)
    cot = torch.randn_like(d)
    grads = []
    for fn in (k.relay_mix_2d, ref.relay_mix_2d):
        A_ = A.clone().requires_grad_(True)
        d_ = d.clone().requires_grad_(True)
        (fn(A_, d_) * cot).sum().backward()
        grads.append((A_.grad, d_.grad))
    torch.testing.assert_close(grads[0][0], grads[1][0], atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(grads[0][1], grads[1][1], atol=1e-5, rtol=1e-5)


def test_kernels_are_bitwise_deterministic(dev):
    A, c, d = _inputs(10, 272_282, torch.float32, dev)
    assert torch.equal(k.relay_mix_2d(A, d), k.relay_mix_2d(A, d))
    assert torch.equal(k.fused_aggregate_2d(c, d), k.fused_aggregate_2d(c, d))


def test_kernel_backends_dispatch_to_kernels(dev):
    A, c, d = _inputs(10, 1000, torch.float32, dev)
    k.reset_launches()
    ops.mix_flat(A, d, backend="hopper")
    ops.reduce_flat(c, d, backend="hopper_fused")
    ops.mix_flat(A, d, backend="einsum")
    ops.reduce_flat(c, d, backend="einsum")
    assert k.LAUNCHES == {"relay_mix_2d": 1, "fused_aggregate_2d": 1}


def test_wrapper_refuses_mixed_devices(dev):
    with pytest.raises(ValueError, match="weights on"):
        k.relay_mix_2d(torch.eye(3), torch.ones(3, 8, device=dev))
