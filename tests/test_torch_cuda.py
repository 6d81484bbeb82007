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


def _inputs(n, D, dtype, dev):
    gen = torch.Generator().manual_seed(n * 100_003 + D)
    A = (torch.randn(n, n, generator=gen) / math.sqrt(n)).to(dev)
    c = (torch.randn(n, generator=gen) / math.sqrt(n)).to(dev)
    d = torch.randn(n, D, generator=gen).to(dev, dtype)
    return A, c, d


@pytest.mark.parametrize("n", [1, 7, 10, 64, 128, 300])
@pytest.mark.parametrize("D", [100, 5000, 272_282])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain_versions(dev, n, D, dtype):
    A, c, d = _inputs(n, D, dtype, dev)
    atol, rtol = TOL[dtype]
    before = dict(k.LAUNCHES)
    torch.testing.assert_close(k.relay_mix_2d(A, d).float(),
                               ref.relay_mix_2d(A.to(dtype), d).float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(k.fused_aggregate_2d(c, d).float(),
                               ref.fused_aggregate_2d(c.to(dtype), d).float(),
                               atol=atol, rtol=rtol)
    torch.cuda.synchronize()
    assert k.LAUNCHES["relay_mix_2d"] == before["relay_mix_2d"] + 1
    assert k.LAUNCHES["fused_aggregate_2d"] == before["fused_aggregate_2d"] + 1


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
