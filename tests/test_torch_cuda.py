"""The CUDA kernels on the card against their plain torch versions.

Needs an NVIDIA GPU (and nvcc to build the kernels); skips without one.  The
file imports neither jax nor the JAX package, so it also runs on a machine
that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""
import functools
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
    assert plan["splits"] == k.fused_splits(n, D)
    if plan["splits"] == 1:  # one wave of blocks striding over the column tiles
        assert 1 <= plan["grid"] <= sms * plan["blocks_per_sm"]
    else:  # a block a (column tile, origin range)
        tiles = math.ceil(D // (plan["vec_bytes"] // d.element_size()) / plan["tile"])
        assert plan["grid"] == tiles * plan["splits"]


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


# mesh_corr_500's MLP (dim 64, width 32): D = 2,410, the shape the
# distributed slice's mesh scenario gives the fused kernel
@pytest.mark.parametrize("layout", ["contiguous", "row_slice", "elem_offset"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_at_the_mesh_scenario_shape(dev, dtype, layout):
    A, c, d = _inputs(10, 2_410, dtype, dev, layout)
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(k.relay_mix_2d(A, d).float(),
                               ref.relay_mix_2d(A.to(dtype), d).float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(k.fused_aggregate_2d(c, d).float(),
                               ref.fused_aggregate_2d(c.to(dtype), d).float(),
                               atol=atol, rtol=rtol)
    if layout == "contiguous":
        assert torch.equal(k.relay_mix_2d(A, d), ref.relay_mix_2d(A.to(dtype), d))
        assert torch.equal(k.fused_aggregate_2d(c, d), ref.fused_aggregate_2d(c.to(dtype), d))


@pytest.mark.parametrize("n", [6, 64])
def test_relay_mix_backward_on_card(dev, n):
    """dΔ = Aᵀ·g through the kernel (its stream path at n = 6, its slab path
    at 64) against the plain chain's; dA = g·Δᵀ, an
    f32 product of length D, within the standard forward-error bound of
    such a product around the f64 product, γ_D·(|g|·|Δ|ᵀ) with γ_D =
    D·u/(1 − D·u), u = 2⁻²⁴ (any correct f32 summation order meets it,
    the plain chain's included), and equal to ``g @ Δᵀ`` in f32 bit for
    bit (the same call)."""
    D = 3001
    A, _, d = _inputs(n, D, torch.float32, dev)
    cot = torch.randn_like(d)
    grads = []
    for fn in (k.relay_mix_2d, ref.relay_mix_2d):
        A_ = A.clone().requires_grad_(True)
        d_ = d.clone().requires_grad_(True)
        (fn(A_, d_) * cot).sum().backward()
        grads.append((A_.grad, d_.grad))
    torch.testing.assert_close(grads[0][1], grads[1][1], atol=1e-5, rtol=1e-5)
    u = 2.0**-24
    gamma = D * u / (1 - D * u)
    exact = cot.double() @ d.double().t()
    bound = gamma * (cot.double().abs() @ d.double().abs().t())
    for dA, _ in grads:
        assert bool(((dA.double() - exact).abs() <= bound).all())
    assert torch.equal(grads[0][0], cot @ d.t())


# the mix on both sides of its paths: n = 32 (the stream path's largest), 33
# (the slab path's smallest), 64 (64-row blocks), 127 and 128 (one 128-row
# tile), 129 and 300 (two and three, each reading Δ); D at mesh_corr_500's
# width, the main width and one past it (an odd pitch: one-element vectors)
@pytest.mark.parametrize("layout", ["contiguous", "row_slice"])
@pytest.mark.parametrize("n", [32, 33, 64, 127, 128, 129, 300])
@pytest.mark.parametrize("D", [2_410, 272_282, 272_283])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_relay_mix_bitwise_equal_to_plain_version_across_paths(dev, n, D, dtype, layout):
    A, _, d = _inputs(n, D, dtype, dev, layout)
    got = k.relay_mix_2d(A, d)
    assert torch.equal(got, ref.relay_mix_2d(A.to(dtype), d))
    assert torch.equal(k.relay_mix_2d(A, d), got)


def test_relay_mix_plan_switches_paths_and_vectors(dev):
    """n ≤ 32 streams, n > 32 takes the slab path; both take the widest
    vector that Δ's base address and pitch allow, so a Δ off 16 bytes (8) or
    off one element (4) takes narrower ones than an aligned Δ (16) at a
    16-byte pitch; the main shape runs in one wave of 128-thread blocks, and
    at mesh_corr_500's width, with fewer column tiles than SMs, the row
    passes spread over more blocks."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert k.relay_mix_plan(torch.empty(32, 4096, device=dev))["path"] == "stream"
    assert k.relay_mix_plan(torch.empty(33, 4096, device=dev))["path"] == "slab"
    for n in (8, 64):
        flat = torch.empty(n * 4096 + 4, device=dev)
        for off, vec_bytes in ((0, 16), (2, 8), (1, 4)):
            d = flat[off:off + n * 4096].view(n, 4096)
            assert k.relay_mix_plan(d)["vec_bytes"] == vec_bytes
    main = k.relay_mix_plan(torch.empty(10, 272_282, device=dev))
    tiles = math.ceil(272_282 // 2 / 128)
    assert (main["path"], main["vec_bytes"], main["threads"]) == ("stream", 8, 128)
    assert main["grid"] == tiles <= sms * main["blocks_per_sm"]
    mesh = k.relay_mix_plan(torch.empty(10, 2_410, device=dev))
    assert mesh["grid"] == math.ceil(2_410 // 2 / 128) * 3  # 3 passes of 4 rows


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


@pytest.mark.parametrize("engine", ["scan", "pipelined_inline", "pipelined_thread"])
@pytest.mark.parametrize("strategy,backend", [("colrel", "hopper"),
                                              ("colrel_fused", "hopper_fused")])
def test_captured_engines_bitwise_equal_to_loop_on_card(dev, strategy, backend, engine):
    """Each engine with its full chunks replayed as CUDA graphs against the
    same engine eager and the loop: bitwise equal params, server state,
    metrics and generator state; at most 2 captures; every chunk replayed
    or eager (the remainders); the kernel counted once a round, replays
    included."""
    import numpy as np

    from repro_torch import channels
    from repro_torch.core.aggregation import ServerOpt
    from repro_torch.fl.engine import EpochScanEngine, PipelinedScanEngine, run_rounds_loop
    from repro_torch.fl.simulator import FLSimulator

    n, rounds, dim, chunk = 6, 17, 4097, 2
    schedule = functools.partial(_churn_schedule, n)
    lengths = [s.n_rounds for s in schedule().segments(rounds)]
    chunks, full = sum(-(-x // chunk) for x in lengths), sum(x // chunk for x in lengths)
    assert 0 < full < chunks

    def loss_fn(params, batch):
        diff = params["x"][None, :] - batch["c"]
        return 0.5 * torch.mean(torch.sum(diff**2, dim=-1))

    def run(name, capture=True):
        rng = np.random.default_rng(42)
        sim = FLSimulator(loss_fn, n_clients=n, strategy=strategy, local_steps=2,
                          relay_backend=backend, server_opt=ServerOpt(momentum=0.5))
        params = {"x": torch.ones(dim, device=dev)}
        kw = dict(schedule=schedule(), rounds=rounds, lr=0.1,
                  policy=channels.AdaptiveOptAlpha(sweeps=20, warm_sweeps=8),
                  next_batch=lambda: {"c": rng.standard_normal((n, 2, 4, dim))
                                      .astype(np.float32)})
        gen = torch.Generator(device=dev).manual_seed(7)
        k.reset_launches()
        eng = None
        if name == "loop":
            out = run_rounds_loop(sim, gen, params, sim.init_server_state(params), **kw)
        elif name == "scan":
            eng = EpochScanEngine(sim, chunk=chunk, capture=capture)
        else:
            eng = PipelinedScanEngine(sim, chunk=chunk, prefetch=name.split("_")[1],
                                      capture=capture)
        if eng is not None:
            out = eng.run_schedule(gen, params, sim.init_server_state(params), **kw)
        torch.cuda.synchronize()
        return out, dict(k.LAUNCHES), eng

    (lp, ls, lm, lg), _, _ = run("loop")
    kernel = "relay_mix_2d" if backend == "hopper" else "fused_aggregate_2d"
    for capture in (True, False):
        (ep, es, em, eg), launches, eng = run(engine, capture)
        assert launches == {name: rounds if name == kernel else 0 for name in launches}
        assert torch.equal(ep["x"], lp["x"]) and torch.equal(es["x"], ls["x"])
        for name in ("loss", "tau", "delta_norm"):
            assert torch.equal(em[name], lm[name])
        assert torch.equal(eg.get_state(), lg.get_state())
        if capture:
            assert 1 <= eng.trace_count <= 2 and (eng.replays, eng.eager_chunks) == (
                full, chunks - full)
        else:
            assert (eng.trace_count, eng.replays, eng.eager_chunks) == (0, 0, chunks)


def test_captured_sharded_engine_bitwise_on_a_one_rank_nccl_world(dev, tmp_path):
    """ShardedScanEngine captured against uncaptured over an NCCL world of
    one rank: bitwise params, losses and generator state, one capture per
    (epoch length, masked) pair."""
    import numpy as np
    import torch.distributed as dist

    from repro_torch import channels
    from repro_torch.fl.distributed import build_sharded_scan_round_step
    from repro_torch.fl.engine import ShardedScanEngine
    from repro_torch.launch.mesh import make_client_mesh

    n, rounds, dim = 6, 17, 4097

    def loss_fn(params, batch):
        diff = params["x"][None, :] - batch["c"]
        return 0.5 * torch.mean(torch.sum(diff**2, dim=-1))

    segs = list(_churn_schedule(n).segments(rounds))
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store", world_size=1,
                            rank=0)
    try:
        mesh = make_client_mesh()
        step = build_sharded_scan_round_step(loss_fn, n_clients=n, local_steps=2, mesh=mesh,
                                             relay_backend="hopper_fused")
        outs = []
        for capture in (True, False):
            rng = np.random.default_rng(42)
            eng = ShardedScanEngine(step, mesh=mesh, capture=capture)
            params = {"x": torch.ones(dim, device=dev)}
            out = eng.run_schedule(
                torch.Generator(device=dev).manual_seed(7), params, None,
                schedule=_churn_schedule(n), rounds=rounds, lr=0.1,
                policy=channels.AdaptiveOptAlpha(sweeps=20, warm_sweeps=8),
                next_batch=lambda rng=rng: {"c": rng.standard_normal((n, 2, 4, dim))
                                            .astype(np.float32)})
            torch.cuda.synchronize()
            outs.append((out, eng.trace_count, eng.replays))
    finally:
        dist.destroy_process_group()
    ((cp, _, cm, cg), count, replays), ((up, _, um, ug), zero, _) = outs
    assert count == len({(s.n_rounds, s.active is None) for s in segs}) and zero == 0
    assert replays == len(segs)
    assert torch.equal(cp["x"], up["x"]) and torch.equal(cm["loss"], um["loss"])
    assert torch.equal(cg.get_state(), ug.get_state())


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


# the sample sweeps' n at D = 698 and at mesh_corr_500's width, all with
# S > 1 origin ranges, in the three layouts (vectors of 16, 8 or 4 bytes,
# and single elements)
@pytest.mark.parametrize("layout", ["contiguous", "row_slice", "elem_offset"])
@pytest.mark.parametrize("n", [256, 1_000, 1_025, 10_000])
@pytest.mark.parametrize("D", [698, 2_410])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_split_kernel_bitwise_equal_to_plain_version(dev, n, D, dtype, layout):
    _, c, d = _inputs(n, D, dtype, dev, layout)
    assert k.fused_splits(n, D) > 1
    before = k.LAUNCHES["fused_aggregate_2d"]
    u = k.fused_aggregate_2d(c, d)
    assert torch.equal(u, ref.fused_aggregate_2d(c.to(dtype), d))
    assert torch.equal(k.fused_aggregate_2d(c, d), u)
    assert k.LAUNCHES["fused_aggregate_2d"] == before + 2  # one a call


@pytest.mark.parametrize("n", [1_000, 10_000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_split_kernel_graph_replay_equals_eager(dev, n, dtype):
    """A CUDA graph of a call with S > 1 (workspace from the graph's pool,
    the tile counters zeroed inside the graph at each replay) gives the
    eager call's bits on each of 3 replays, Δ rewritten in between."""
    _, c, d = _inputs(n, 698, dtype, dev)
    d2 = torch.randn(d.shape, device=dev).to(dtype)
    static = d.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        k.fused_aggregate_2d(c, static)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = k.fused_aggregate_2d(c, static)
    for src in (d, d2, d):
        static.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, k.fused_aggregate_2d(c, src))
        assert torch.equal(got, ref.fused_aggregate_2d(c.to(dtype), src))


def test_fused_split_counters_never_shared(dev):
    """The split kernel's tile counters: one zeroed buffer a stream for eager
    calls, reused on that stream and left at zero; the calls of one capture
    share a buffer of their own, which the graph's replays leave at zero."""
    _, c, d = _inputs(1_000, 698, torch.float32, dev)
    want = ref.fused_aggregate_2d(c, d)
    side = torch.cuda.Stream()
    bufs = []
    for stream in (torch.cuda.current_stream(), side, torch.cuda.current_stream()):
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            assert torch.equal(k.fused_aggregate_2d(c, d), want)
            bufs.append(k._counters(d.device, 1))
    torch.cuda.synchronize()
    assert bufs[0] is bufs[2] and bufs[0] is not bufs[1]
    assert not bufs[0].any() and not bufs[1].any()
    static = d.clone()
    with torch.cuda.stream(side):
        k.fused_aggregate_2d(c, static)
    torch.cuda.synchronize()
    before = set(map(id, k._counter_buffers.values()))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = [k.fused_aggregate_2d(c, static) for _ in range(3)]
    captured = [b for b in k._counter_buffers.values() if id(b) not in before]
    assert len(captured) == 1  # one buffer for the capture's three calls
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(g, want) for g in got) and not captured[0].any()


def test_fused_aggregate_plan_reports_splits(dev):
    """The sample sweeps' top shape takes fused_splits ranges and a block a
    (column tile, range), not the 3 blocks of the single chain; the main
    shape keeps the single chain's one wave."""
    big = k.fused_aggregate_plan(torch.empty(10_000, 698, device=dev))
    assert (big["splits"], big["vec_bytes"]) == (157, 8)
    assert big["grid"] == math.ceil(349 / big["tile"]) * 157 > 3
    main = k.fused_aggregate_plan(torch.empty(10, 272_282, device=dev))
    assert (main["splits"], main["vec_bytes"], main["threads"], main["tile"]) == (1, 8, 128, 128)


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


# -- the continuous-training service on the card ------------------------------


@pytest.mark.parametrize("engine", ["loop", "scan", "pipelined"])
@pytest.mark.parametrize("strategy,backend", [("colrel", "hopper"),
                                              ("colrel_fused", "hopper_fused")])
def test_trainer_publish_and_resume_bitwise_on_card(dev, tmp_path, strategy, backend, engine):
    """ContinuousTrainer on a kernel backend under churn, fading and drift:
    bursts of 4 published on the card equal one uninterrupted run, and a
    trainer rebuilt from seeds that restores the round-8 snapshot (params
    and the CUDA generator back on the card) and replays the stream equals
    its rounds 9–12; one kernel launch a round."""
    import numpy as np

    from repro_torch import channels
    from repro_torch.core.aggregation import ServerOpt
    from repro_torch.fl.simulator import FLSimulator
    from repro_torch.launch.serve import SnapshotEvalLoop
    from repro_torch.launch.train import ContinuousTrainer

    n, rounds, dim = 6, 12, 4097

    def loss_fn(params, batch):
        diff = params["x"][None, :] - batch["c"]
        return 0.5 * torch.mean(torch.sum(diff**2, dim=-1))

    def trainer(**kw):
        rng = np.random.default_rng(42)
        sim = FLSimulator(loss_fn, n_clients=n, strategy=strategy, local_steps=2,
                          relay_backend=backend, server_opt=ServerOpt(momentum=0.9))
        t = ContinuousTrainer(
            sim, schedule=_churn_schedule(n), lr=0.1, engine=engine, chunk=4,
            policy=channels.AdaptiveOptAlpha(sweeps=20, warm_sweeps=8),
            next_batch=lambda: {"c": rng.standard_normal((n, 2, 4, dim)).astype(np.float32)},
            **kw)
        t.init({"x": torch.ones(dim, device=dev)}, torch.Generator(device=dev).manual_seed(7))
        return t

    d = str(tmp_path / "ckpts")
    ref = trainer()
    ref_m = ref.run(rounds)
    k.reset_launches()
    burst = trainer(ckpt_dir=d, publish_every=4, keep=0)
    burst_m = burst.run(rounds)
    torch.cuda.synchronize()
    kernel = "relay_mix_2d" if backend == "hopper" else "fused_aggregate_2d"
    assert dict(k.LAUNCHES) == {name: rounds if name == kernel else 0 for name in k.LAUNCHES}
    assert torch.equal(burst.params["x"], ref.params["x"])
    assert torch.equal(burst.server_state["x"], ref.server_state["x"])
    assert all(np.array_equal(burst_m[key], ref_m[key]) for key in ref_m)
    assert burst.generator.device.type == dev.type
    assert torch.equal(burst.generator.get_state(), ref.generator.get_state())

    # a second trainer runs 8 rounds and is dropped (a crash); a third,
    # rebuilt from seeds, restores its round-8 snapshot and runs on
    d2 = str(tmp_path / "crashed")
    trainer(ckpt_dir=d2, publish_every=4).run(8)
    resumed = trainer(ckpt_dir=d2, publish_every=4)
    assert resumed.restore_latest() and resumed.round == 8
    assert resumed.params["x"].device.type == dev.type
    resumed.advance_stream()
    got_m = resumed.run(rounds - 8)
    assert torch.equal(resumed.params["x"], ref.params["x"])
    assert torch.equal(resumed.server_state["x"], ref.server_state["x"])
    assert all(np.array_equal(got_m[key], ref_m[key][8:]) for key in ref_m)
    assert torch.equal(resumed.generator.get_state(), ref.generator.get_state())

    # the eval loop on the card loads the newest snapshot: the trainer's params
    loop = SnapshotEvalLoop(d, params_like={"x": torch.zeros(dim, device=dev)},
                            eval_fn=loss_fn)
    assert loop.poll() and loop.round == rounds
    batch = {"c": np.zeros((n, 2, 4, dim), np.float32)}
    want = float(loss_fn(ref.params, {"c": torch.zeros(n, 2, 4, dim, device=dev)}))
    assert abs(loop.eval_batch(batch) - want) <= 1e-6


def test_async_trainer_bursts_equal_one_call_on_card(dev):
    """The async engine in bursts of 4 on hopper_fused under Poisson(1.0)
    delays equals one uninterrupted 12-round call, bitwise."""
    import numpy as np

    from repro_torch import channels
    from repro_torch.channels import PoissonDelays
    from repro_torch.core.aggregation import ServerOpt
    from repro_torch.fl.simulator import FLSimulator
    from repro_torch.launch.train import ContinuousTrainer

    n, rounds, dim = 6, 12, 4097

    def loss_fn(params, batch):
        diff = params["x"][None, :] - batch["c"]
        return 0.5 * torch.mean(torch.sum(diff**2, dim=-1))

    def run(publish_every):
        rng = np.random.default_rng(42)
        sim = FLSimulator(loss_fn, n_clients=n, strategy="colrel_fused", local_steps=2,
                          relay_backend="hopper_fused", server_opt=ServerOpt(momentum=0.9))
        t = ContinuousTrainer(
            sim, schedule=_churn_schedule(n), lr=0.1, engine="async",
            delays=PoissonDelays(n, rate=1.0, max_delay=8, seed=11),
            policy=channels.AdaptiveOptAlpha(sweeps=20, warm_sweeps=8),
            next_batch=lambda: {"c": rng.standard_normal((n, 2, 4, dim)).astype(np.float32)},
            publish_every=publish_every)
        t.init({"x": torch.ones(dim, device=dev)}, torch.Generator(device=dev).manual_seed(7))
        return t, t.run(rounds)

    (one, m1), (burst, m2) = run(0), run(4)
    assert torch.equal(one.params["x"], burst.params["x"])
    assert all(np.array_equal(m1[key], m2[key]) for key in m1)
    assert torch.equal(one.generator.get_state(), burst.generator.get_state())


def test_sharded_step_over_nccl_on_card(dev, tmp_path):
    """The sharded step over an NCCL world of one rank: the gather exchange
    on hopper_fused bitwise equal to the fused scan step (the kernel runs
    once a round), the ring within 1e-5, the same generator state."""
    import numpy as np
    import torch.distributed as dist

    from repro_torch.fl import distributed
    from repro_torch.launch.mesh import make_client_mesh

    n, T, R, dim = 8, 2, 3, 4097
    rng = np.random.default_rng(0)
    batches = {"c": rng.standard_normal((R, n, T, 4, dim)).astype(np.float32)}
    A = rng.uniform(0.0, 1.0, (n, n)) / n + np.eye(n) * 0.5
    p = rng.uniform(0.3, 0.9, n)

    def loss_fn(params, batch):
        diff = params["x"][None, :] - batch["c"]
        return 0.5 * torch.mean(torch.sum(diff**2, dim=-1))

    def run(step):
        gen = torch.Generator(device=dev).manual_seed(3)
        return step(gen, {"x": torch.ones(dim, device=dev)}, None, batches, p, 0.1, A=A)

    kw = dict(n_clients=n, local_steps=T, relay_mode="fused")
    ref = run(distributed.build_fused_scan_round_step(loss_fn, relay_backend="hopper_fused",
                                                      **kw))
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store", world_size=1,
                            rank=0)
    try:
        mesh = make_client_mesh()
        k.reset_launches()
        gather = run(distributed.build_sharded_scan_round_step(
            loss_fn, mesh=mesh, relay_backend="hopper_fused", **kw))
        assert k.LAUNCHES["fused_aggregate_2d"] == R
        ring = run(distributed.build_sharded_scan_round_step(
            loss_fn, mesh=mesh, exchange="ring", **kw))
    finally:
        dist.destroy_process_group()
    assert torch.equal(gather[1]["x"], ref[1]["x"]) and torch.equal(gather[3], ref[3])
    torch.testing.assert_close(ring[1]["x"], ref[1]["x"], atol=1e-5, rtol=1e-5)
    for out in (gather, ring):
        assert torch.equal(out[0].get_state(), ref[0].get_state())


# ------------------------------------------------------------- the LM zoo

LM_ARCHS = ["qwen3-14b", "recurrentgemma-9b", "mixtral-8x22b", "qwen2.5-32b", "whisper-tiny",
            "falcon-mamba-7b", "grok-1-314b", "qwen1.5-32b", "glm4-9b",
            "llama-3.2-vision-11b"]


def _lm_data(cfg, B=2, S=96, seed=0):
    import numpy as np

    rng = np.random.default_rng(seed)
    out = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32))}
    if cfg.family == "audio":
        out["frame_embeds"] = torch.from_numpy(
            rng.standard_normal((B, cfg.enc_frames, cfg.d_model)).astype(np.float32))
    if cfg.family == "vlm":
        out["img_embeds"] = torch.from_numpy(
            rng.standard_normal((B, cfg.n_image_tokens, cfg.d_model)).astype(np.float32))
    return out


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_reduced_on_card_matches_cpu_and_teacher_forcing(dev, arch):
    """reduced() on the card: prefill logits and loss within atol 1e-5 +
    rtol 1e-5 of the CPU run for the same parameters; decode within the
    reference's 2e-3 of teacher forcing (MoE at capacity factor 8); 8
    greedy decode steps finite."""
    import dataclasses

    from repro_torch.configs import registry as creg
    from repro_torch.models import get_model
    from repro_torch.utils import tree_map

    cfg = creg.get_config(arch, reduced=True)
    md = get_model(cfg)
    host = md.init(0, device="cpu")
    params = tree_map(lambda x: x.to(dev), host)
    data = _lm_data(cfg)
    rest = {key: v for key, v in data.items() if key != "tokens"}
    tk = data["tokens"]
    outs = []
    with torch.no_grad():
        for p_, where in ((host, "cpu"), (params, dev)):
            ex = {key: v.to(where) for key, v in rest.items()}
            t_ = tk.to(where)
            logits, _ = md.prefill(p_, {"tokens": t_[:, :-1], **ex})
            loss = md.loss(p_, {"tokens": t_[:, :-1], "labels": t_[:, 1:], **ex})
            outs.append((logits.cpu(), loss.cpu()))
    for got, want in zip(outs[1], outs[0]):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    if cfg.family == "moe":
        md = get_model(dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0)))
    ex = {key: v.to(dev) for key, v in rest.items()}
    tk = tk.to(dev)
    with torch.no_grad():
        full, _ = md.prefill(params, {"tokens": tk, **ex})
        _, cache = md.prefill(params, {"tokens": tk[:, :-1], **ex})
        dec, cache = md.decode(params, cache, tk[:, -1:])
        rel = (full - dec).abs().max() / full.abs().max()
        assert rel < 2e-3
        tok = dec[:, -1].argmax(-1)[:, None]
        for _ in range(8):
            dec, cache = md.decode(params, cache, tok)
            assert torch.isfinite(dec).all()
            tok = dec[:, -1].argmax(-1)[:, None]


@pytest.mark.parametrize("arch", ["glm4-9b", "mixtral-8x22b"])
def test_lm_colrel_rounds_kernels_match_einsum_on_card(dev, arch):
    """Two ColRel rounds of the LM at reduced() (n = 10, T = 2): each kernel
    backend within 1e-5 of einsum on the same τ and batches, its kernel
    launched once a round."""
    import numpy as np

    from repro_torch.configs import registry as creg
    from repro_torch.core import connectivity, opt_alpha, topology
    from repro_torch.data.loader import FederatedLoader
    from repro_torch.data.partition import iid_partition
    from repro_torch.data.synthetic import lm_tokens
    from repro_torch.fl.simulator import FLSimulator
    from repro_torch.models import get_model
    from repro_torch.utils import tree_flatten

    n, T, rounds = 10, 2, 2
    cfg = creg.get_config(arch, reduced=True)
    md = get_model(cfg)
    conn = connectivity.heterogeneous_profile(n)
    A = opt_alpha.optimize(conn.p, topology.ring(n, 1), sweeps=50).A
    ds = lm_tokens(512, 64, vocab=cfg.vocab, seed=0)
    loader = FederatedLoader(ds, iid_partition(ds, n, seed=0), seed=0)
    batches = [loader.round_batch(T, 4, lm=True) for _ in range(rounds)]
    runs = {}
    for strategy, backend in (("colrel", "hopper"), ("colrel", "einsum"),
                              ("colrel_fused", "hopper_fused"), ("colrel_fused", "einsum")):
        sim = FLSimulator(md.loss, n_clients=n, strategy=strategy, A=A, p=conn.p,
                          local_steps=T, relay_backend=backend, device=dev)
        params = md.init(0, device=dev)
        state = sim.init_server_state(params)
        gen = torch.Generator(device=dev).manual_seed(42)
        k.reset_launches()
        for b in batches:
            params, state, m = sim.run_round(gen, params, state, b, 0.1)
            assert np.isfinite(float(m["loss"]))
        kernel = {"hopper": "relay_mix_2d", "hopper_fused": "fused_aggregate_2d"}.get(backend)
        assert k.LAUNCHES == {kn: rounds if kn == kernel else 0 for kn in k.LAUNCHES}
        runs[strategy, backend] = tree_flatten(params)[0]
    for strategy, backend in (("colrel", "hopper"), ("colrel_fused", "hopper_fused")):
        for x, y in zip(runs[strategy, backend], runs[strategy, "einsum"]):
            torch.testing.assert_close(x, y, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_decode_graph_matches_eager_on_card(dev, arch):
    """The serving demo's decode step captured as a CUDA graph: 4 replays
    give the eager step's logits and cache (atol 1e-5 + rtol 1e-5), fed
    back step to step as the demo feeds them."""
    from repro_torch.configs import registry as creg
    from repro_torch.launch.serve import _DecodeGraph
    from repro_torch.models import get_model
    from repro_torch.utils import tree_flatten

    cfg = creg.get_config(arch, reduced=True)
    md = get_model(cfg)
    params = md.init(0, device=dev)
    data = {key: v.to(dev) for key, v in _lm_data(cfg, S=40).items()}
    with torch.no_grad():
        _, cache = md.prefill(params, {**data, "tokens": data["tokens"][:, :-1]})
        tok = data["tokens"][:, -1:].long()
        graph = _DecodeGraph(md, params, cache, tok)
        eager_cache, graph_cache, eager_tok, graph_tok = cache, cache, tok, tok
        for _ in range(4):
            want, eager_cache = md.decode(params, eager_cache, eager_tok)
            got, graph_cache = graph(graph_cache, graph_tok)
            torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
            for x, y in zip(tree_flatten(graph_cache)[0], tree_flatten(eager_cache)[0]):
                torch.testing.assert_close(x, y, atol=1e-5, rtol=1e-5)
            eager_tok = want[:, -1].argmax(-1)[:, None]
            graph_tok = got[:, -1].argmax(-1)[:, None]


def test_device_span_is_the_devices_work_on_the_tracers_clock(dev):
    """A device span around ``torch.cuda._sleep``: it starts no earlier than
    0.2 ms before the host enqueued the sleep and ends no later than 0.2 ms
    after ``synchronize`` returned, at several lengths, one anchor for all;
    a span enqueued behind a sleep already in flight starts after it."""
    from repro_torch.obs import Tracer
    from repro_torch.obs.device import device_span, take_anchor

    tracer = Tracer()
    torch.cuda._sleep(1_000)  # load the kernel
    torch.cuda.synchronize()
    take_anchor(tracer, dev)
    for cycles in (100_000, 2_000_000, 50_000_000, 2_000_000):
        t_enqueue = tracer.now()
        with device_span(tracer, "sleep", dev, cycles=cycles):
            torch.cuda._sleep(cycles)
        torch.cuda.synchronize()
        t_done = tracer.now()
        span = tracer.spans[-1]
        assert span.clock == "device" and span.attrs == {"cycles": cycles}
        assert t_enqueue - 200_000 <= span.t0_ns < span.t1_ns <= t_done + 200_000
    # behind queued work: the span starts when the device reaches it
    with device_span(tracer, "first", dev):
        torch.cuda._sleep(20_000_000)
    with device_span(tracer, "second", dev):
        torch.cuda._sleep(1_000)
    torch.cuda.synchronize()
    first, second = tracer.spans[-2:]
    assert (first.name, second.name) == ("first", "second")
    assert second.t0_ns >= first.t1_ns - 1_000 and first.dur_ns > 5e6


@pytest.mark.parametrize("engine", ["loop", "scan", "pipelined_inline", "pipelined_thread"])
def test_traced_captured_engines_time_the_device_on_card(dev, engine):
    """A traced run on the card, its full chunks captured and replayed, is
    bitwise the untraced run; each chunk's device span (device-timed) starts
    no earlier than 0.2 ms before its dispatch span, each copy's before its
    ``prefetch.h2d``, and the chunks' rounds sum to the run's."""
    import numpy as np

    from repro_torch import channels
    from repro_torch.fl.engine import EpochScanEngine, PipelinedScanEngine, run_rounds_loop
    from repro_torch.fl.simulator import FLSimulator
    from repro_torch.obs import Tracer

    n, rounds, dim, chunk = 6, 17, 4097, 2

    def loss_fn(params, batch):
        diff = params["x"][None, :] - batch["c"]
        return 0.5 * torch.mean(torch.sum(diff**2, dim=-1))

    def run(tracer):
        rng = np.random.default_rng(42)
        sim = FLSimulator(loss_fn, n_clients=n, strategy="colrel_fused", local_steps=2,
                          relay_backend="hopper_fused")
        params = {"x": torch.ones(dim, device=dev)}
        kw = dict(schedule=_churn_schedule(n), rounds=rounds, lr=0.1,
                  policy=channels.AdaptiveOptAlpha(sweeps=20, warm_sweeps=8),
                  next_batch=lambda: {"c": rng.standard_normal((n, 2, 4, dim))
                                      .astype(np.float32)})
        gen = torch.Generator(device=dev).manual_seed(7)
        state = sim.init_server_state(params)
        if engine == "loop":
            out = run_rounds_loop(sim, gen, params, state, tracer=tracer, **kw)
        elif engine == "scan":
            out = EpochScanEngine(sim, chunk=chunk, tracer=tracer).run_schedule(
                gen, params, state, **kw)
        else:
            out = PipelinedScanEngine(sim, chunk=chunk, prefetch=engine.split("_")[1],
                                      tracer=tracer).run_schedule(gen, params, state, **kw)
        torch.cuda.synchronize()
        return out

    base, tracer = run(None), Tracer()
    traced = run(tracer)
    assert torch.equal(base[0]["x"], traced[0]["x"]) and torch.equal(base[2]["loss"],
                                                                    traced[2]["loss"])
    name = engine.split("_")[0]
    host = [s for s in tracer.spans if s.name == ("loop.round" if name == "loop"
                                                  else f"{name}.chunk")]
    device = [s for s in tracer.spans if s.name == f"{name}.device"]
    assert len(device) == len(host) and {s.clock for s in device} == {"device"}
    assert sum(s.attrs.get("rounds", 1) for s in device) == rounds
    for h, d in zip(host, sorted(device, key=lambda s: s.t0_ns)):
        assert d.t0_ns >= h.t0_ns - 200_000 and d.t1_ns > d.t0_ns
    if name == "pipelined":
        h2d = [s for s in tracer.spans if s.name == "prefetch.h2d"]
        copies = sorted((s for s in tracer.spans if s.name == "prefetch.copy"),
                        key=lambda s: s.t0_ns)
        assert len(copies) == len(h2d) == len(device)
        for h, c in zip(h2d, copies):
            assert c.t0_ns >= h.t0_ns - 200_000 and c.attrs["bytes"] > 0


def test_traced_mesh_scenario_records_its_copies_on_card(deterministic, tmp_path):
    """mesh_corr_500 (cut to 50 rounds) with a trace: the pipelined mesh
    pass calls no engine, so its prefetcher anchors the tracer itself, and
    each staged segment's copy is a device-timed ``prefetch.copy`` span."""
    import dataclasses
    import json

    from repro_torch.bench import harness, scenarios

    spec = dataclasses.replace(scenarios.get_scenario("mesh_corr_500"), rounds=50)
    result = harness.run_scenario(spec, trace_dir=tmp_path)
    assert result["bitwise_match"] is True
    events = json.loads(
        (tmp_path / "TRACE_mesh_corr_500_pipelined.json").read_text())["traceEvents"]
    copies = [e for e in events if e.get("name") == "prefetch.copy"]
    assert {"mesh.fused", "mesh.device"} <= {e.get("name") for e in events}
    assert len(copies) == result["runs"]["pipelined"].chunks_staged > 0
    assert all(e["args"]["bytes"] > 0 for e in copies)


def test_traced_pipelined_engine_waits_for_room_outside_its_dispatch_spans(dev, monkeypatch):
    """Chunks of ~60 ms of device work, all replayed from one graph, and a
    host that stages in microseconds, so the host runs ahead of the card.
    Traced, the engine keeps at most two chunks queued (``_TRACED_QUEUE``):
    before each later chunk it waits for the older in a ``pipelined.wait``
    span, no replay blocks, and each ``pipelined.chunk`` span is a small part
    of its chunk's device time; the trajectory is bitwise the untraced one."""
    import time

    import numpy as np

    from repro_torch import channels
    from repro_torch.core import topology
    from repro_torch.fl.engine import PipelinedScanEngine
    from repro_torch.fl.simulator import FLSimulator
    from repro_torch.obs import Tracer

    n, chunk, rounds, dim = 4, 2, 16, 64

    def loss_fn(params, batch):
        torch.cuda._sleep(30_000_000)  # >= 15 ms of the card's time a local step
        diff = params["x"][None, :] - batch["c"]
        return 0.5 * torch.mean(torch.sum(diff**2, dim=-1))

    replay, in_replay = torch.cuda.CUDAGraph.replay, []

    def timed_replay(graph):
        t0 = time.perf_counter_ns()
        replay(graph)
        in_replay.append(time.perf_counter_ns() - t0)

    monkeypatch.setattr(torch.cuda.CUDAGraph, "replay", timed_replay)

    def run(tracer):
        rng = np.random.default_rng(0)
        sim = FLSimulator(loss_fn, n_clients=n, strategy="fedavg_blind", local_steps=2)
        engine = PipelinedScanEngine(sim, chunk=chunk, tracer=tracer)
        params = {"x": torch.ones(dim, device=dev)}
        schedule = channels.StaticChannel(topology.ring(n), np.full(n, 0.9, np.float32))
        out = engine.run_schedule(
            torch.Generator(device=dev).manual_seed(1), params, sim.init_server_state(params),
            schedule=schedule, rounds=rounds, lr=0.1,
            next_batch=lambda: {"c": rng.standard_normal((n, 2, 4, dim)).astype(np.float32)})
        torch.cuda.synchronize()
        assert engine.replays == rounds // chunk
        blocked = in_replay[:]
        in_replay.clear()
        return out, blocked

    (base, _), tracer = run(None), Tracer()
    traced, traced_blocked = run(tracer)
    assert torch.equal(base[0]["x"], traced[0]["x"])
    assert torch.equal(base[2]["loss"], traced[2]["loss"])
    assert max(traced_blocked) < 5e6
    waits = [s for s in tracer.spans if s.name == "pipelined.wait"]
    device = [s for s in tracer.spans if s.name == "pipelined.device"]
    dispatch = [s for s in tracer.spans if s.name == "pipelined.chunk"]
    assert len(waits) >= 3 and {s.cat for s in waits} == {"wait"}
    assert len(dispatch) == len(device) == rounds // chunk
    shortest = min(s.dur_ns for s in device)
    assert shortest > 40e6 and max(s.dur_ns for s in dispatch[1:]) < shortest / 4
    # the card never waits for the host: a chunk is queued at every launch
    device.sort(key=lambda s: s.t0_ns)
    assert max(b.t0_ns - a.t1_ns for a, b in zip(device[1:], device[2:])) < 2e6


# -- ResNet-20/GN's convolutions (kernels/conv.py) ----------------------------

# every convolution of ResNet-20/GN: (Cin, Cout, kernel, stride, map side)
RESNET_CONVS = [(3, 16, 3, 1, 32), (16, 16, 3, 1, 32), (16, 32, 3, 2, 32), (16, 32, 1, 2, 32),
                (32, 32, 3, 1, 16), (32, 64, 3, 2, 16), (32, 64, 1, 2, 16), (64, 64, 3, 1, 8)]


def _conv_inputs(dev, n, B, cin, cout, ksize, stride, side):
    gen = torch.Generator(device=dev).manual_seed(cin * 1009 + cout * 31 + ksize * 7 + stride)
    out = -(-side // stride)
    x = torch.randn(n, B, side, side, cin, generator=gen, device=dev)
    w = torch.randn(n, ksize, ksize, cin, cout, generator=gen, device=dev)
    dy = torch.randn(n, B, out, out, cout, generator=gen, device=dev)
    return x, w * (2.0 / (ksize * ksize * cin)) ** 0.5, dy


def _conv_all(x, w, dy, stride, *, ref=False):
    """fprop, dgrad (None for the stem: the images need no gradient) and
    wgrad, through the kernels or the plain versions."""
    from repro_torch.kernels import conv

    side, ksize = x.shape[2], w.shape[1]
    f, d, g = ((conv.conv2d_fprop_ref, conv.conv2d_dgrad_ref, conv.conv2d_wgrad_ref) if ref
               else (conv.conv2d_fprop, conv.conv2d_dgrad, conv.conv2d_wgrad))
    return (f(x, w, stride), None if x.shape[-1] % 8 else d(dy, w, side, side, stride),
            g(dy, x, ksize, ksize, stride))


@pytest.mark.parametrize("cin,cout,ksize,stride,side", RESNET_CONVS)
def test_conv_kernels_match_plain_versions(dev, cin, cout, ksize, stride, side):
    """Each kernel at the cell's shapes (10 clients of 64 images) against its
    plain version in f64.  The kernels sum up to 576 (fprop, dgrad) or
    65,536 (wgrad) f32 products in their own order, so each output is held
    within 1e-5 of the largest magnitude of its tensor: the f32 sums' error
    is a few ulps of that scale, TF32 products miss it about 100-fold."""
    from repro_torch.kernels import conv

    x, w, dy = _conv_inputs(dev, 10, 64, cin, cout, ksize, stride, side)
    conv.reset_launches()
    got = _conv_all(x, w, dy, stride)
    torch.cuda.synchronize()
    assert conv.LAUNCHES == {"conv2d_fprop": 1, "conv2d_dgrad": int(cin % 8 == 0),
                             "conv2d_wgrad": 1}
    want = _conv_all(x.double(), w.double(), dy.double(), stride, ref=True)
    for g, ref_ in zip(got, want):
        if ref_ is not None:
            assert g.dtype == torch.float32 and g.shape == ref_.shape
            torch.testing.assert_close(g.double(), ref_, atol=1e-5 * float(ref_.abs().max()),
                                       rtol=0)


@pytest.mark.parametrize("cin,cout,ksize,stride,side", RESNET_CONVS)
def test_conv_kernels_bitwise_deterministic_and_client_independent(dev, cin, cout, ksize,
                                                                   stride, side):
    """Two calls are bitwise equal, and a client's output and gradients are
    bitwise the same alone, among 10, and in a block of 4 (a sharded
    rank's): no tile or split depends on the client count."""
    x, w, dy = _conv_inputs(dev, 10, 64, cin, cout, ksize, stride, side)
    first = _conv_all(x, w, dy, stride)
    again = _conv_all(x, w, dy, stride)
    alone = _conv_all(x[3:4], w[3:4], dy[3:4], stride)
    block = _conv_all(x[4:8], w[4:8], dy[4:8], stride)
    for a, b, one, four in zip(first, again, alone, block):
        if a is not None:
            assert torch.equal(a, b)
            assert torch.equal(a[3:4], one)
            assert torch.equal(a[4:8], four)


def test_conv_graph_replay_equals_eager(dev):
    """The three kernels captured in a CUDA graph (wgrad's partials from the
    graph's pool): a replay on fresh inputs equals the eager calls bitwise,
    and the capture records one launch of each."""
    from repro_torch.kernels import conv

    x, w, dy = _conv_inputs(dev, 10, 64, 16, 32, 3, 2, 32)
    eager = _conv_all(x, w, dy, 2)
    static = [torch.zeros_like(t) for t in (x, w, dy)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _conv_all(*static, 2)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    conv.reset_launches()
    with torch.cuda.graph(graph):
        out = _conv_all(*static, 2)
    assert conv.LAUNCHES == {"conv2d_fprop": 1, "conv2d_dgrad": 1, "conv2d_wgrad": 1}
    for dst, src in zip(static, (x, w, dy)):
        dst.copy_(src)
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(out, eager):
        assert torch.equal(a, b)


def test_conv_refuses_what_the_kernels_do_not_take(dev):
    from repro_torch.kernels import conv

    x, w, _ = _conv_inputs(dev, 2, 2, 16, 16, 3, 1, 8)
    with pytest.raises(TypeError, match="float32"):
        conv.conv2d_fprop(x.double(), w.double(), 1)
    with pytest.raises(ValueError, match="output channels"):
        conv.conv2d_fprop(x, torch.zeros(2, 3, 3, 16, 24, device=dev), 1)
    with pytest.raises(ValueError, match="contiguous"):
        conv.conv2d_fprop(x.transpose(2, 3), w, 1)


def test_resnet_grads_through_the_kernels_match_the_cpu(dev):
    """vmap(grad_and_value(ResNet-20/GN's loss)) on the card, through the
    kernels and their vmap rules, against the same on the CPU (the plain
    versions): the losses within 1e-5 and the gradients within 1e-4, the
    tolerance the JAX package's gradients get on the CPU."""
    from repro_torch.configs.resnet20_cifar import CONFIG
    from repro_torch.kernels import conv
    from repro_torch.models import resnet
    from repro_torch.utils import tree_flatten, tree_map

    n, b = 3, 4
    params = resnet.init_resnet20(0, CONFIG, device="cpu")
    gen = torch.Generator().manual_seed(5)
    batch = {"images": torch.randn(n, b, 32, 32, 3, generator=gen),
             "labels": torch.randint(0, 10, (n, b), generator=gen)}
    stacked = tree_map(lambda p: p.unsqueeze(0).expand(n, *p.shape).contiguous(), params)
    fn = torch.func.vmap(torch.func.grad_and_value(
        lambda p, mb: resnet.resnet20_loss(p, CONFIG, mb)))
    conv.reset_launches()
    g_dev, l_dev = fn(tree_map(lambda t: t.to(dev), stacked),
                      tree_map(lambda t: t.to(dev), batch))
    torch.cuda.synchronize()
    # 21 convolutions forward, 21 weight gradients, 20 input gradients
    assert conv.LAUNCHES == {"conv2d_fprop": 21, "conv2d_dgrad": 20, "conv2d_wgrad": 21}
    g_cpu, l_cpu = fn(stacked, batch)
    torch.testing.assert_close(l_dev.cpu(), l_cpu, atol=1e-5, rtol=1e-5)
    for a, c in zip(tree_flatten(g_dev)[0], tree_flatten(g_cpu)[0]):
        torch.testing.assert_close(a.cpu(), c, atol=1e-4, rtol=0)


def test_captured_resnet_chunk_runs_the_conv_kernels_and_no_cudnn(dev):
    """ResNet-20/GN rounds through the pipelined engine, full chunks replayed
    as CUDA graphs, against the loop: bitwise equal params and losses; every
    round's convolutions counted on the kernels, replays included; and the
    profiler sees the new kernels and no cuDNN convolution kernel (the
    final linear layer's cuBLAS GEMMs stay)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import channels
    from repro_torch.configs.resnet20_cifar import CONFIG
    from repro_torch.fl.engine import PipelinedScanEngine, run_rounds_loop
    from repro_torch.fl.simulator import FLSimulator
    from repro_torch.kernels import conv
    from repro_torch.models import resnet

    n, b, steps, rounds, chunk = 4, 8, 2, 4, 2

    def loss_fn(params, batch):
        return resnet.resnet20_loss(params, CONFIG, batch)

    def run(name):
        rng = np.random.default_rng(11)
        sim = FLSimulator(loss_fn, n_clients=n, strategy="colrel_fused", local_steps=steps,
                          relay_backend="hopper_fused")
        params = resnet.init_resnet20(0, CONFIG, device=dev)
        kw = dict(schedule=_churn_schedule(n), rounds=rounds, lr=0.1,
                  policy=channels.AdaptiveOptAlpha(sweeps=20, warm_sweeps=8),
                  next_batch=lambda: {
                      "images": rng.standard_normal((n, steps, b, 32, 32, 3)).astype(np.float32),
                      "labels": rng.integers(0, 10, (n, steps, b)).astype(np.int32)})
        gen = torch.Generator(device=dev).manual_seed(7)
        conv.reset_launches()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            if name == "loop":
                out = run_rounds_loop(sim, gen, params, sim.init_server_state(params), **kw)
                eng = None
            else:
                eng = PipelinedScanEngine(sim, chunk=chunk, prefetch="inline")
                out = eng.run_schedule(gen, params, sim.init_server_state(params), **kw)
            torch.cuda.synchronize()
        names = {e.key for e in prof.key_averages()}
        return out, dict(conv.LAUNCHES), eng, names

    (lp, _, lm, _), loop_launches, _, _ = run("loop")
    (ep, _, em, _), launches, eng, names = run("pipelined")
    per_round = {"conv2d_fprop": 21 * steps, "conv2d_dgrad": 20 * steps,
                 "conv2d_wgrad": 21 * steps}
    want = {key: rounds * v for key, v in per_round.items()}
    assert loop_launches == launches == want
    assert eng.replays >= 1
    for key in lp:
        assert all(torch.equal(a, c) for a, c in zip(
            torch.utils._pytree.tree_leaves(ep[key]), torch.utils._pytree.tree_leaves(lp[key])))
    assert torch.equal(em["loss"], lm["loss"])
    assert any("conv_gemm_kernel" in name for name in names)
    assert any("conv_wgrad_kernel" in name for name in names)
    banned = ("cudnn", "convolve", "genericTranspose", "winograd", "fprop", "dgrad_")
    assert not [name for name in names if any(b_ in name for b_ in banned)]
