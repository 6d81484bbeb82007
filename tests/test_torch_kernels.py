"""The port's relay kernels on the CPU (their plain versions, by the device of
the operands) against the JAX package's Pallas kernels in interpret mode, and
the wrappers' checks.  The CUDA kernels themselves are held against the plain
versions on the card (tests/test_torch_cuda.py, chip_smoke.py)."""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import relay_mix as jax_k
from repro_torch.kernels import ops
from repro_torch.kernels import relay_mix as k

# f32: the sums run in another order than XLA's, so atol 1e-5 + rtol 1e-5;
# bf16: within one bf16 ulp of the output (rtol 2^-7) + the same atol
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-5, 2.0**-7)}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _case(n, D, dtype, salt):
    rng = np.random.default_rng(hash((n, D, dtype, salt)) % 2**31)
    A = (rng.standard_normal((n, n)) / np.sqrt(n)).astype(np.float32)
    c = (rng.standard_normal(n) / np.sqrt(n)).astype(np.float32)
    d = np.asarray(jnp.asarray(rng.standard_normal((n, D)), JNP[dtype]))
    return A, c, d


def _to_torch(d):
    if d.dtype.name == "bfloat16":
        return torch.from_numpy(np.asarray(d, np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(d))


def _assert_close(got, want, dtype):
    atol, rtol = TOL[dtype]
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), atol=atol, rtol=rtol
    )


@pytest.mark.parametrize("n", [1, 7, 10, 64, 128, 130])
@pytest.mark.parametrize("D", [100, 5000])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_relay_mix_2d_matches_pallas(n, D, dtype):
    A, _, d = _case(n, D, dtype, 0)
    want = jax_k.relay_mix_2d(jnp.asarray(A), jnp.asarray(d), interpret=True)
    got = k.relay_mix_2d(torch.from_numpy(A), _to_torch(d))
    assert got.dtype == TORCH[dtype] and got.shape == (n, D)
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("n", [1, 7, 10, 64, 128, 130])
@pytest.mark.parametrize("D", [100, 5000])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_aggregate_2d_matches_pallas(n, D, dtype):
    _, c, d = _case(n, D, dtype, 1)
    want = jax_k.fused_aggregate_2d(jnp.asarray(c), jnp.asarray(d), interpret=True)
    got = k.fused_aggregate_2d(torch.from_numpy(c), _to_torch(d))
    assert got.dtype == TORCH[dtype] and got.shape == (D,)
    _assert_close(got, want, dtype)


def test_relay_mix_autograd_matches_jax_custom_vjp():
    """The autograd.Function's (dA, dΔ) against jax.grad through the Pallas
    kernel's custom_vjp, with a ragged D."""
    n, D = 5, 700
    rng = np.random.default_rng(17)
    A = rng.standard_normal((n, n)).astype(np.float32)
    d = rng.standard_normal((n, D)).astype(np.float32)
    cot = rng.standard_normal((n, D)).astype(np.float32)

    def loss_jax(A_, d_):
        return jnp.vdot(jax_k.relay_mix_2d(A_, d_, block_d=256, interpret=True), cot)

    gA_j, gd_j = jax.grad(loss_jax, argnums=(0, 1))(jnp.asarray(A), jnp.asarray(d))
    A_t = torch.from_numpy(A).requires_grad_(True)
    d_t = torch.from_numpy(d).requires_grad_(True)
    loss = (k.relay_mix_2d(A_t, d_t) * torch.from_numpy(cot)).sum()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_jax(jnp.asarray(A), jnp.asarray(d))),
                               rtol=1e-5)
    np.testing.assert_allclose(A_t.grad.numpy(), np.asarray(gA_j), atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(d_t.grad.numpy(), np.asarray(gd_j), atol=1e-5, rtol=1e-5)


def test_relay_mix_bf16_gradient_dtypes():
    A = torch.randn(4, 4, requires_grad=True)
    d = torch.randn(4, 33).to(torch.bfloat16).requires_grad_(True)
    k.relay_mix_2d(A, d).float().sum().backward()
    assert A.grad.dtype == torch.float32 and d.grad.dtype == torch.bfloat16


def test_cpu_calls_count_no_launches():
    k.reset_launches()
    k.relay_mix_2d(torch.eye(3), torch.ones(3, 8))
    k.fused_aggregate_2d(torch.ones(3), torch.ones(3, 8))
    assert k.LAUNCHES == {"relay_mix_2d": 0, "fused_aggregate_2d": 0}


@pytest.mark.parametrize(
    "fn, weights, delta, exc, match",
    [
        (k.relay_mix_2d, torch.eye(3), torch.ones(3, 8, dtype=torch.float16), TypeError, "dtype"),
        (k.relay_mix_2d, torch.eye(3, dtype=torch.float64), torch.ones(3, 8), TypeError,
         "float32"),
        (k.relay_mix_2d, torch.eye(4), torch.ones(3, 8), ValueError, "shape"),
        (k.relay_mix_2d, torch.eye(3), torch.ones(8, 3).t(), ValueError, "contiguous"),
        (k.relay_mix_2d, torch.eye(3), torch.ones(24), ValueError, "2-D"),
        (k.fused_aggregate_2d, torch.ones(4), torch.ones(3, 8), ValueError, "shape"),
        (k.fused_aggregate_2d, torch.ones(3), torch.ones(3, 8, dtype=torch.int32), TypeError,
         "dtype"),
    ],
)
def test_wrappers_refuse_bad_operands(fn, weights, delta, exc, match):
    with pytest.raises(exc, match=match):
        fn(weights, delta)


def test_fused_aggregate_plan_needs_a_cuda_tensor():
    # the plan is the CUDA launcher's own choice; a CPU Δ launches nothing
    with pytest.raises(ValueError, match="CUDA"):
        k.fused_aggregate_plan(torch.ones(3, 8))


def test_relay_mix_plan_needs_a_cuda_tensor():
    with pytest.raises(ValueError, match="CUDA"):
        k.relay_mix_plan(torch.ones(3, 8))


def _timing_tool():
    path = Path(__file__).resolve().parents[1] / "tools" / "time_fused_aggregate.py"
    spec = importlib.util.spec_from_file_location("time_fused_aggregate", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def test_timing_tool_kernel_option_and_shapes():
    """The A/B timing tool parses without a GPU: the fused kernel by default
    at the main shape and (8, 10⁷); the mix at those, mesh_corr_500's width,
    the two LM widths and n = 32, 64 and 128 at the main width; each shape's
    bound by the bytes below the ridge and by the FMAs at n = 128."""
    tool = _timing_tool()
    assert tool.parse_args([]).kernel == "fused_aggregate_2d"
    args = tool.parse_args(["--kernel", "relay_mix_2d", "--parent", "p", "--repeat", "2"])
    assert (args.kernel, args.parent, args.repeat) == ("relay_mix_2d", "p", 2)
    with pytest.raises(SystemExit):
        tool.parse_args(["--kernel", "relay_mix"])
    assert tool.SHAPES["fused_aggregate_2d"] == ((10, 272_282), (8, 10_000_000))
    assert tool.SHAPES["relay_mix_2d"] == (
        (10, 272_282), (8, 10_000_000), (10, 2_410), (10, 1_443_072), (10, 3_804_416),
        (32, 272_282), (64, 272_282), (128, 272_282))
    bounds = [tool.KERNELS["relay_mix_2d"].bound_ms(n, D)[1]
              for n, D in tool.SHAPES["relay_mix_2d"]]
    assert bounds == ["bytes"] * 7 + ["operations"]


def test_ops_backend_names():
    buf = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="relay_backend"):
        ops.mix_flat(torch.eye(2), buf, backend="pallas")
    with pytest.raises(ValueError, match="relay_backend"):
        ops.reduce_flat(torch.ones(2), buf, backend="cuda")
    # the JAX package's contract: a dense matrix on the segment backend is
    # refused with its message
    with pytest.raises(ValueError, match="needs an EdgeRelay operand"):
        ops.mix_flat(torch.eye(2), buf, backend="segment")
    assert ops.RELAY_BACKENDS == ("einsum", "hopper", "hopper_fused", "segment")


@pytest.mark.parametrize("backend", ["einsum", "hopper", "hopper_fused"])
@pytest.mark.parametrize("masked", [False, True])
def test_flat_dispatch_matches_jax_ops(backend, masked):
    """mix_flat / reduce_flat against the JAX package's dispatch on the
    matching backend (pallas in interpret mode for the kernel backends)."""
    from repro.kernels import ops as jax_ops

    jax_backend = {"einsum": "einsum", "hopper": "pallas", "hopper_fused": "pallas_fused"}
    n, D = 7, 1000
    rng = np.random.default_rng(3)
    A = (rng.standard_normal((n, n)) / np.sqrt(n)).astype(np.float32)
    buf = rng.standard_normal((n, D)).astype(np.float32)
    c = rng.standard_normal(n).astype(np.float32)
    active = (rng.random(n) < 0.6).astype(np.float32) if masked else None
    kw = {"interpret": True, "block_d": 256} if backend != "einsum" else {}
    want_mix = jax_ops.mix_flat(jnp.asarray(A), jnp.asarray(buf),
                                active=None if active is None else jnp.asarray(active),
                                backend=jax_backend[backend], **kw)
    got_mix = ops.mix_flat(A, torch.from_numpy(buf), active=active, backend=backend)
    np.testing.assert_allclose(got_mix.numpy(), np.asarray(want_mix), atol=1e-5, rtol=1e-5)
    want_red = jax_ops.reduce_flat(jnp.asarray(c), jnp.asarray(buf),
                                   backend=jax_backend[backend], **kw)
    got_red = ops.reduce_flat(c, torch.from_numpy(buf), backend=backend)
    np.testing.assert_allclose(got_red.numpy(), np.asarray(want_red), atol=1e-5, rtol=1e-5)


def test_pytree_wrappers_match_jax():
    from repro.kernels import ops as jax_ops

    n = 6
    rng = np.random.default_rng(4)
    A = rng.standard_normal((n, n)).astype(np.float32)
    tau = (rng.random(n) < 0.5).astype(np.float32)
    active = np.array([1, 1, 0, 1, 0, 1], np.float32)
    upd = {"w": rng.standard_normal((n, 33, 7)).astype(np.float32),
           "b": rng.standard_normal((n, 257)).astype(np.float32)}
    jupd = jax.tree.map(jnp.asarray, upd)
    tupd = {key: torch.from_numpy(v) for key, v in upd.items()}
    want = jax_ops.relay_mix(jnp.asarray(A), jupd, active=jnp.asarray(active),
                             interpret=True)
    got = ops.relay_mix(A, tupd, active=active)
    want_f = jax_ops.fused_aggregate(jnp.asarray(A), jnp.asarray(tau), jupd, w=0.25,
                                     active=jnp.asarray(active), interpret=True)
    got_f = ops.fused_aggregate(A, tau, tupd, w=0.25, active=active)
    for key in upd:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-5)
        np.testing.assert_allclose(got_f[key].numpy(), np.asarray(want_f[key]), atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_relay_mix_pytree_matches_jax(dtype):
    from repro.kernels import ref as jax_ref
    from repro_torch.kernels import ref
    from repro_torch.utils import tree_flatten

    n = 6
    rng = np.random.default_rng(9)
    A = (rng.standard_normal((n, n)) / np.sqrt(n)).astype(np.float32)
    upd = {"w": rng.standard_normal((n, 4, 3)), "b": [rng.standard_normal((n, 9))]}
    jupd = jax.tree.map(lambda x: jnp.asarray(x, JNP[dtype]), upd)
    tupd = jax.tree.map(lambda x: _to_torch(np.asarray(x)), jupd)
    want = jax_ref.relay_mix_pytree(jnp.asarray(A), jupd)
    got = ref.relay_mix_pytree(A, tupd)
    for g, w in zip(tree_flatten(got)[0], jax.tree.leaves(want)):
        assert g.dtype == TORCH[dtype] and tuple(g.shape) == w.shape
        _assert_close(g, w, dtype)
