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


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 6, 8, 10, 13, 17, 64])
@pytest.mark.parametrize("D", [1000, 272_282])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_bitwise_equal_to_plain_versions(dev, n, D, dtype):
    """The plain versions sum the origins in the kernels' order (ascending,
    one fused multiply-add each), so on the card the two agree bit for bit;
    a library product does not at every n (cuBLAS picks its order by
    shape)."""
    A, c, d = _inputs(n, D, dtype, dev)
    assert torch.equal(k.relay_mix_2d(A, d), ref.relay_mix_2d(A.to(dtype), d))
    assert torch.equal(k.fused_aggregate_2d(c, d), ref.fused_aggregate_2d(c.to(dtype), d))


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


# -- churn masks and the engines on the card ---------------------------------

ACTIVE = (1, 0, 1, 1, 0, 1, 1, 1, 0, 1)


@pytest.mark.parametrize("D", [1000, 272_282])
def test_masked_relay_through_kernels_matches_plain(dev, D):
    """A churn mask folds into A before dispatch: each kernel backend equals
    plain torch, and an inactive slot adds exactly zero (poisoned rows of Δ
    change nothing)."""
    from repro_torch.core import aggregation

    A, _, d = _inputs(10, D, torch.float32, dev)
    active = torch.tensor(ACTIVE, dtype=torch.float32, device=dev)
    tau = torch.tensor([1, 1, 0, 1, 1, 1, 0, 1, 1, 1], dtype=torch.float32, device=dev)
    poisoned = d.clone()
    poisoned[active == 0] = 1e30
    want = ops.mix_flat(A, d, active=active, backend="einsum")
    k.reset_launches()
    got = ops.mix_flat(A, d, active=active, backend="hopper")
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert got[active == 0].eq(0).all()
    for fused, backend in ((False, "hopper"), (True, "hopper_fused")):
        inc = [aggregation.colrel_increment_flat(A, tau, buf, n=10, fused=fused, active=active,
                                                 backend=b)
               for buf, b in ((d, backend), (poisoned, backend), (d, "einsum"))]
        assert torch.equal(inc[0], inc[1])
        torch.testing.assert_close(inc[0], inc[2], atol=1e-5, rtol=1e-5)
    torch.cuda.synchronize()
    assert k.LAUNCHES == {"relay_mix_2d": 3, "fused_aggregate_2d": 2}


def _churn_schedule(n):
    from repro_torch import channels
    from repro_torch.core import topology

    link = channels.MarkovLinkProcess(topology.ring(n, 2), p_up_to_down=0.4,
                                      p_down_to_up=0.6, seed=3)
    drift = channels.PiecewiseConstantDrift([0.2 + 0.7 * i / (n - 1) for i in range(n)],
                                            hold=1, low=0.1, high=0.9, seed=4)
    member = channels.RotatingCohorts(n, n_cohorts=3, hold=5)
    return channels.ChurnSchedule(membership=member, link_process=link, p_process=drift,
                                  adj_every=3, p_every=4)


@pytest.mark.parametrize("engine", ["scan", "pipelined_inline", "pipelined_thread"])
@pytest.mark.parametrize("strategy,backend", [("colrel", "hopper"),
                                              ("colrel_fused", "hopper_fused")])
def test_engines_bitwise_equal_to_loop_on_card(dev, strategy, backend, engine):
    """Each engine against the per-round loop on a kernel backend under
    churn, fading and drift: bitwise equal params, server state, metrics and
    generator state, and one kernel launch a round."""
    import numpy as np

    from repro_torch import channels
    from repro_torch.core.aggregation import ServerOpt
    from repro_torch.fl.engine import EpochScanEngine, PipelinedScanEngine, run_rounds_loop
    from repro_torch.fl.simulator import FLSimulator

    n, rounds, dim = 6, 17, 4097

    def loss_fn(params, batch):
        diff = params["x"][None, :] - batch["c"]
        return 0.5 * torch.mean(torch.sum(diff**2, dim=-1))

    def run(name):
        rng = np.random.default_rng(42)
        sim = FLSimulator(loss_fn, n_clients=n, strategy=strategy, local_steps=2,
                          relay_backend=backend, server_opt=ServerOpt(momentum=0.5))
        params = {"x": torch.ones(dim, device=dev)}
        kw = dict(schedule=_churn_schedule(n), rounds=rounds, lr=0.1,
                  policy=channels.AdaptiveOptAlpha(sweeps=20, warm_sweeps=8),
                  next_batch=lambda: {"c": rng.standard_normal((n, 2, 4, dim))
                                      .astype(np.float32)})
        gen = torch.Generator(device=dev).manual_seed(7)
        k.reset_launches()
        if name == "loop":
            out = run_rounds_loop(sim, gen, params, sim.init_server_state(params), **kw)
        elif name == "scan":
            out = EpochScanEngine(sim, chunk=4).run_schedule(
                gen, params, sim.init_server_state(params), **kw)
        else:
            out = PipelinedScanEngine(sim, chunk=4, prefetch=name.split("_")[1]).run_schedule(
                gen, params, sim.init_server_state(params), **kw)
        torch.cuda.synchronize()
        return out, dict(k.LAUNCHES)

    (lp, ls, lm, lg), _ = run("loop")
    (ep, es, em, eg), launches = run(engine)
    kernel = "relay_mix_2d" if backend == "hopper" else "fused_aggregate_2d"
    assert launches == {name: rounds if name == kernel else 0 for name in launches}
    assert torch.equal(ep["x"], lp["x"]) and torch.equal(es["x"], ls["x"])
    for name in ("loss", "tau", "delta_norm"):
        assert torch.equal(em[name], lm[name])
    assert torch.equal(eg.get_state(), lg.get_state())


# -- the bench harness on the card -------------------------------------------


@pytest.fixture
def deterministic(dev):
    """f32 convolutions and cuDNN's deterministic algorithms, as the bench
    CLI sets them: the bitwise gate needs every engine to run the same
    convolution sums."""
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    yield dev
    (torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic,
     torch.backends.cudnn.benchmark) = flags


@pytest.mark.parametrize("name", ["relay_sweep_smoke", "resnet20_cifar"])
def test_bench_scenario_gates_and_launches_on_card(deterministic, name):
    """``run_scenario`` on the card: the engines bitwise equal to the loop,
    the kernel check within 1e-5 of einsum, and the check's kernel launched
    once a round in its cold and warm passes (never by the einsum
    engines).  resnet20_cifar is cut to 8 rounds in chunks of 4."""
    import dataclasses

    from repro_torch.bench import harness, report, scenarios

    spec = scenarios.get_scenario(name)
    if name == "resnet20_cifar":
        spec = dataclasses.replace(spec, rounds=8, chunk=4)
    k.reset_launches()
    result = harness.run_scenario(spec)
    kernel = {"hopper": "relay_mix_2d", "hopper_fused": "fused_aggregate_2d"}[spec.check_backend]
    want = {kn: 2 * spec.rounds if kn == kernel else 0 for kn in k.LAUNCHES}
    assert k.LAUNCHES == want
    assert result["bitwise_match"] is True
    assert result["kernel_check"]["allclose"] and result["kernel_check"]["max_abs_diff"] <= 1e-5
    for engine, run in result["runs"].items():
        assert run.kernel_launches == (want if engine.startswith("scan_") else
                                       dict.fromkeys(want, 0))
        assert all(math.isfinite(x) for x in run.losses)
    rep = report.make_report(spec, result)
    assert rep["backend"] == "cuda"
    assert rep["device"]["name"] == torch.cuda.get_device_name(0)


# -- the sparse path and the async engine on the card ------------------------


@pytest.mark.parametrize("n", [1_000, 1_025, 10_000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_kernel_bitwise_at_segment_shapes(dev, n, dtype):
    """The segment backend's dense reduce at the sample sweeps' D = 698:
    n past the 1,024 coefficients the kernel stages at once (and one past
    it) gives the plain version's bits, twice."""
    _, c, d = _inputs(n, 698, dtype, dev)
    u = k.fused_aggregate_2d(c, d)
    assert torch.equal(u, ref.fused_aggregate_2d(c.to(dtype), d))
    assert torch.equal(k.fused_aggregate_2d(c, d), u)
    assert torch.equal(ops.reduce_flat(c, d, backend="segment"), u)


def _geometric_edge_relay(n, seed):
    import numpy as np

    from repro_torch.core import opt_alpha, topology

    adj = topology.random_geometric(n, float(np.sqrt(8.0 / (np.pi * n))), seed=seed)
    p = np.random.default_rng(seed).uniform(0.2, 0.9, n)
    active = np.random.default_rng(seed + 1).random(n) < 0.3
    return opt_alpha.optimize_sparse(p, adj, active, sweeps=5).edge_relay(), active


@pytest.mark.parametrize("n", [300, 5_000])
def test_segment_ops_repeatable_on_card(dev, n):
    """fused_coefficients and segment_mix on an EdgeRelay on the card: two
    calls give the same bits (no atomics), within 1e-6 / 1e-5 of the same
    ops on the CPU, and the masked increment on ``segment`` launches the
    fused kernel once."""
    from repro_torch.core import aggregation
    from repro_torch.core import relay as relay_lib

    er, active = _geometric_edge_relay(n, seed=n)
    gen = torch.Generator().manual_seed(n)
    tau = torch.bernoulli(torch.full((n,), 0.6), generator=gen)
    buf = torch.randn(n, 698, generator=gen)
    on = relay_lib.as_relay_operand(er, n=n, backend="segment", device=dev)
    assert on.rows.dtype == torch.int32 and on.layout.by_col.device.type == "cuda"
    for fn, args, atol in ((relay_lib.fused_coefficients, (tau,), 1e-6),
                           (relay_lib.segment_mix, (buf,), 1e-5)):
        a, b = fn(on, *(x.to(dev) for x in args)), fn(on, *(x.to(dev) for x in args))
        assert torch.equal(a, b)
        torch.testing.assert_close(a.cpu(), fn(er, *args), atol=atol, rtol=atol)
    k.reset_launches()
    act = torch.as_tensor(active, dtype=torch.float32, device=dev)
    inc = [aggregation.colrel_increment_flat(on, tau.to(dev), buf.to(dev), n=n, active=act,
                                             backend="segment") for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(inc[0], inc[1])
    assert k.LAUNCHES == {"relay_mix_2d": 0, "fused_aggregate_2d": 2}


@pytest.mark.parametrize("strategy", ["colrel_fused", "fedavg_blind"])
def test_async_delay0_bitwise_equal_to_loop_on_card(dev, strategy):
    """AsyncRoundEngine at ZeroDelays against run_rounds_loop on
    ``hopper_fused`` under churn, fading and drift: bitwise equal params,
    server state, metrics and generator state, and the fused kernel once a
    round in both."""
    import numpy as np

    from repro_torch import channels
    from repro_torch.core.aggregation import ServerOpt
    from repro_torch.fl.async_engine import AsyncRoundEngine
    from repro_torch.fl.engine import run_rounds_loop
    from repro_torch.fl.simulator import FLSimulator

    n, rounds, dim = 6, 17, 4097

    def loss_fn(params, batch):
        diff = params["x"][None, :] - batch["c"]
        return 0.5 * torch.mean(torch.sum(diff**2, dim=-1))

    def run(name):
        rng = np.random.default_rng(42)
        sim = FLSimulator(loss_fn, n_clients=n, strategy=strategy, local_steps=2,
                          relay_backend="hopper_fused", server_opt=ServerOpt(momentum=0.5))
        params = {"x": torch.ones(dim, device=dev)}
        kw = dict(schedule=_churn_schedule(n), rounds=rounds, lr=0.1,
                  policy=channels.AdaptiveOptAlpha(sweeps=20, warm_sweeps=8),
                  next_batch=lambda: {"c": rng.standard_normal((n, 2, 4, dim))
                                      .astype(np.float32)})
        gen = torch.Generator(device=dev).manual_seed(7)
        k.reset_launches()
        state = sim.init_server_state(params)
        if name == "loop":
            out = run_rounds_loop(sim, gen, params, state, **kw)
        else:
            out = AsyncRoundEngine(sim).run_schedule(gen, params, state, **kw)
        torch.cuda.synchronize()
        return out, dict(k.LAUNCHES)

    (lp, ls, lm, lg), loop_launches = run("loop")
    (ap, as_, am, ag), launches = run("async")
    assert launches == loop_launches == {"relay_mix_2d": 0, "fused_aggregate_2d": rounds}
    assert torch.equal(ap["x"], lp["x"]) and torch.equal(as_["x"], ls["x"])
    for name in ("loss", "tau", "delta_norm"):
        assert torch.equal(am[name], lm[name])
    assert torch.equal(ag.get_state(), lg.get_state())
