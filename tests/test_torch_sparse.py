"""The port's sparse path against the JAX package's: the ``EdgeRelay``
operand and the ``segment`` backend, the sparse OPT-α solver, cohort
sampling and ``SparseOptAlpha``.  Oracles: ``tests/test_segment_backend.py``
and ``tests/test_sampling.py``.

* Host streams, equal: ``CohortSampler`` masks (every strategy, with and
  without a churn base, redrawn every round or every third);
  ``optimize_sparse`` values and ``warm_start_vals``; ``SparseOptAlpha``'s
  EdgeRelay stream and stats over a cohort-sampled schedule.
* Device math within a stated tolerance of the JAX package: EdgeRelay
  ``fused_coefficients`` 1e-6 (a sum of a few products, in another order);
  ``segment_mix``, ``mix_flat``/``reduce_flat`` and the increments on
  ``segment`` 1e-5; one ``FLSimulator`` round on ``segment`` under churn,
  with τ and params handed over, 1e-5.
* The port's own contracts: the segment layout's order, an inactive slot
  adding exactly zero, an all-inactive cohort giving the exact-zero
  increment, the dense backends densifying an EdgeRelay, the loop, scan and
  pipelined engines bitwise equal on ``segment``, and ``sample_sweep_smoke``
  through ``run_scenario`` on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import channels as jax_channels
from repro.core import aggregation as jax_agg
from repro.core import opt_alpha as jax_opt
from repro.core import relay as jax_relay
from repro.core import topology as jax_topology
from repro.fl.simulator import FLSimulator as JaxSimulator
from repro.kernels import ops as jax_ops
from repro_torch import channels
from repro_torch.channels.scheduler import _to_device
from repro_torch.core import aggregation, opt_alpha, topology
from repro_torch.core import relay as relay_lib
from repro_torch.core.aggregation import ServerOpt
from repro_torch.fl.engine import EpochScanEngine, PipelinedScanEngine, run_rounds_loop
from repro_torch.fl.simulator import FLSimulator
from repro_torch.kernels import ops
from repro_torch.utils import tree_map

BACKENDS = ("einsum", "hopper", "hopper_fused", "segment")


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    # the suite runs several test processes side by side
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _setting(seed=0, n=12, D=37):
    """A converged sparse OPT-α solve on a random geometric graph, with a
    τ, a churn mask and a buffer, from one seed (numpy)."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(0.05, 0.95, n)
    adj = topology.random_geometric(n, 0.5, seed=seed)
    res = opt_alpha.optimize_sparse(p, adj, sweeps=200)
    tau = (rng.random(n) < p).astype(np.float32)
    act = rng.random(n) < 0.6
    act[0] = True
    buf = rng.standard_normal((n, D)).astype(np.float32)
    return res, p, adj, tau, act.astype(np.float32), buf


def _jax_er(er):
    return jax_relay.EdgeRelay(rows=jnp.asarray(er.rows), cols=jnp.asarray(er.cols),
                               vals=jnp.asarray(er.vals))


# ------------------------------------------------------------- the operand


def test_edge_relay_from_dense_and_todense_match_jax():
    res, *_ = _setting(1)
    A = res.todense().astype(np.float32)
    er, jer = relay_lib.edge_relay_from_dense(A), jax_relay.edge_relay_from_dense(A)
    for got, want in zip(er[:3], jer):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert torch.equal(er.todense(A.shape[0]), torch.from_numpy(A))
    assert np.array_equal(er.todense(A.shape[0]).numpy(), np.asarray(jer.todense(A.shape[0])))


@pytest.mark.parametrize("seed", [0, 3])
def test_segment_layout_lists_each_edge_once_in_edge_order(seed):
    res, *_ = _setting(seed, n=20)
    er = res.edge_relay()
    n, E = res.graph.n, er.rows.size
    for slots, seg in ((er.layout.by_row, er.rows), (er.layout.by_col, er.cols)):
        assert slots.dtype == np.int32 and slots.shape[0] == n
        for j in range(n):
            live = slots[j][slots[j] < E]
            assert np.array_equal(live, np.nonzero(seg == j)[0])  # ascending edge order
            assert np.all(slots[j][live.size:] == E)  # then padding only
    # the layout of an edge list is a function of it: built again, the same
    assert all(np.array_equal(a, b)
               for a, b in zip(relay_lib.segment_layout(er.rows, er.cols, n), er.layout))
    with pytest.raises(ValueError, match="out of range"):
        relay_lib.segment_layout(er.rows, er.cols, n - 1)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fused_coefficients_edge_relay_match_jax(seed, masked):
    res, _, _, tau, act, _ = _setting(seed)
    er, jer = res.edge_relay(), _jax_er(res.edge_relay())
    if masked:
        er = relay_lib.mask_relay_matrix(er, torch.from_numpy(act))
        jer = jax_relay.mask_relay_matrix(jer, jnp.asarray(act))
        np.testing.assert_array_equal(er.vals.numpy(), np.asarray(jer.vals))
    got = relay_lib.fused_coefficients(er, torch.from_numpy(tau))
    want = jax_relay.fused_coefficients(jer, jnp.asarray(tau))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 4])
def test_segment_mix_matches_jax(seed):
    res, *_, buf = _setting(seed, n=16, D=53)
    got = relay_lib.segment_mix(res.edge_relay(), torch.from_numpy(buf))
    want = jax_relay.segment_mix(_jax_er(res.edge_relay()), jnp.asarray(buf))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    with pytest.raises(TypeError, match="EdgeRelay"):
        relay_lib.segment_mix(torch.eye(16), torch.from_numpy(buf))


@pytest.mark.parametrize("masked", [False, True])
def test_flat_dispatch_on_segment_matches_jax(masked):
    res, _, _, tau, act, buf = _setting(5)
    active = act if masked else None
    er = res.edge_relay()
    got = ops.mix_flat(er, torch.from_numpy(buf), backend="segment",
                       active=None if active is None else torch.from_numpy(active))
    want = jax_ops.mix_flat(_jax_er(er), jnp.asarray(buf), backend="segment",
                            active=None if active is None else jnp.asarray(active))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    c = np.random.default_rng(5).standard_normal(buf.shape[0]).astype(np.float32)
    got_u = ops.reduce_flat(torch.from_numpy(c), torch.from_numpy(buf), backend="segment")
    want_u = jax_ops.reduce_flat(jnp.asarray(c), jnp.asarray(buf), backend="segment")
    np.testing.assert_allclose(got_u.numpy(), np.asarray(want_u), atol=1e-5, rtol=1e-5)
    # segment's dense reduce is the fused kernel's wrapper: on a CPU buffer
    # its plain version, the same chain as the einsum reduce
    assert torch.equal(got_u, ops.reduce_flat(torch.from_numpy(c), torch.from_numpy(buf)))


@pytest.mark.parametrize("churn", [False, True])
@pytest.mark.parametrize("strategy", ["colrel", "colrel_fused"])
def test_segment_increment_matches_jax_and_einsum(strategy, churn):
    res, _, _, tau, act, buf = _setting(6)
    n = res.graph.n
    active = act if churn else None
    er = res.edge_relay()
    t_act = None if active is None else torch.from_numpy(active)
    got = aggregation.make_aggregator(strategy, n=n, A=er, relay_backend="segment").flat_fn(
        torch.from_numpy(tau), torch.from_numpy(buf), None, t_act)
    want = jax_agg.make_aggregator(strategy, n=n, A=_jax_er(er), relay_backend="segment").flat_fn(
        jnp.asarray(tau), jnp.asarray(buf), None,
        None if active is None else jnp.asarray(active))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    dense = aggregation.make_aggregator(strategy, n=n, A=res.todense().astype(np.float32)
                                        ).flat_fn(torch.from_numpy(tau), torch.from_numpy(buf),
                                                  None, t_act)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("backend", ["einsum", "hopper", "hopper_fused"])
def test_dense_backends_densify_edge_relay_operands(backend):
    res, _, _, tau, act, buf = _setting(9)
    n = res.graph.n
    A = res.todense().astype(np.float32)
    args = (torch.from_numpy(tau), torch.from_numpy(buf), None, torch.from_numpy(act))
    for strategy in ("colrel", "colrel_fused"):
        from_er = aggregation.make_aggregator(strategy, n=n, A=res.edge_relay(),
                                              relay_backend=backend).flat_fn(*args)
        from_dense = aggregation.make_aggregator(strategy, n=n, A=A,
                                                 relay_backend=backend).flat_fn(*args)
        assert torch.equal(from_er, from_dense)
    assert torch.equal(ops.mix_flat(res.edge_relay(), torch.from_numpy(buf), backend=backend),
                       ops.mix_flat(torch.from_numpy(A), torch.from_numpy(buf),
                                    backend=backend))


def test_segment_refuses_dense_matrix_with_the_jax_message():
    res, _, _, tau, _, buf = _setting(2)
    A = res.todense().astype(np.float32)
    agg = aggregation.make_aggregator("colrel_fused", n=A.shape[0], A=A, relay_backend="segment")
    with pytest.raises(ValueError, match="needs an EdgeRelay operand"):
        agg.flat_fn(torch.from_numpy(tau), torch.from_numpy(buf))
    with pytest.raises(ValueError, match="needs an EdgeRelay operand"):
        ops.mix_flat(torch.from_numpy(A), torch.from_numpy(buf), backend="segment")


def test_segment_churn_contributes_exactly_zero():
    """Poisoned inactive rows (large but finite) cancel to exact zeros: the
    mask multiplies edge values, not the buffer."""
    res, _, _, tau, act, buf = _setting(7)
    n = res.graph.n
    poisoned = np.where(act[:, None] > 0, buf, np.float32(1e30))
    clean = buf * act[:, None]
    for strategy in ("colrel", "colrel_fused"):
        agg = aggregation.make_aggregator(strategy, n=n, A=res.edge_relay(),
                                          relay_backend="segment")
        got_p = agg.flat_fn(torch.from_numpy(tau), torch.from_numpy(poisoned), None,
                            torch.from_numpy(act))
        got_c = agg.flat_fn(torch.from_numpy(tau), torch.from_numpy(clean), None,
                            torch.from_numpy(act))
        assert torch.isfinite(got_p).all() and torch.equal(got_p, got_c), strategy


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("strategy", ["colrel", "colrel_fused", "fedavg_blind",
                                      "fedavg_nonblind", "no_dropout"])
def test_all_inactive_cohort_yields_exact_zero_increment(backend, strategy):
    res, _, _, tau, _, buf = _setting(8)
    n = res.graph.n
    operand = res.edge_relay() if backend == "segment" else res.todense().astype(np.float32)
    agg = aggregation.make_aggregator(
        strategy, n=n, A=operand if strategy.startswith("colrel") else None,
        relay_backend=backend)
    got = agg.flat_fn(torch.from_numpy(tau), torch.from_numpy(buf), None, torch.zeros(n))
    assert torch.all(got == 0.0), (backend, strategy)


def test_edge_relay_keeps_its_type_and_dtypes_through_staging():
    res, *_ = _setting(3)
    er = res.edge_relay()
    for x in (er.rows, er.cols, er.vals, *er.layout):
        x.setflags(write=False)  # as SparseOptAlpha hands them out
    staged = _to_device(er, device=torch.device("cpu"))
    assert type(staged) is relay_lib.EdgeRelay and type(staged.layout) is relay_lib.SegmentLayout
    assert staged.rows.dtype == torch.int32 and staged.vals.dtype == torch.float32
    assert staged.layout.by_col.dtype == torch.int32
    assert type(tree_map(lambda x: x, er)) is relay_lib.EdgeRelay
    on = relay_lib.as_relay_operand(er, n=res.graph.n, backend="segment", device="cpu")
    assert type(on) is relay_lib.EdgeRelay and on.rows.dtype == torch.int32
    dense = relay_lib.as_relay_operand(er, n=res.graph.n, backend="einsum", device="cpu")
    assert torch.equal(dense, torch.from_numpy(res.todense().astype(np.float32)))
    # an EdgeRelay without a layout gets one
    bare = relay_lib.EdgeRelay(er.rows, er.cols, er.vals)
    built = relay_lib.as_relay_operand(bare, n=res.graph.n, backend="segment", device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(built.layout, on.layout))


# ------------------------------------------------------------ sparse OPT-α


@pytest.mark.parametrize("method", ["bisect", "exact"])
@pytest.mark.parametrize("seed", [0, 1])
def test_optimize_sparse_equals_jax(method, seed):
    rng = np.random.default_rng(seed)
    n = 24
    p = rng.uniform(0.05, 0.95, n)
    adj = topology.random_geometric(n, 0.35, seed=seed)
    active = rng.random(n) < 0.7
    got = opt_alpha.optimize_sparse(p, adj, active, sweeps=30, method=method)
    want = jax_opt.optimize_sparse(p, adj, active, sweeps=30, method=method)
    assert np.array_equal(got.vals, want.vals)
    assert np.array_equal(got.S_history, want.S_history)
    assert np.array_equal(got.feasible_columns, want.feasible_columns)
    assert (got.sweeps, got.bisection_iters_total) == (want.sweeps, want.bisection_iters_total)
    assert np.array_equal(got.todense(), want.todense())
    for a, b in zip(got.edge_relay()[:3], want.edge_relay()):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_warm_start_vals_and_coverage_equal_jax():
    rng = np.random.default_rng(11)
    n = 30
    p = rng.uniform(0.1, 0.9, n)
    adj = topology.random_geometric(n, 0.3, seed=11)
    g, jg = topology.closed_csc(adj), jax_topology.closed_csc(adj)
    first = opt_alpha.optimize_sparse(p, active=rng.random(n) < 0.5, graph=g).vals
    active = rng.random(n) < 0.5
    p2 = np.clip(p + rng.normal(0, 0.05, n), 0.05, 0.95)
    got = opt_alpha.warm_start_vals(p2, g, first, active)
    assert np.array_equal(got, jax_opt.warm_start_vals(p2, jg, first, active))
    assert np.array_equal(opt_alpha.warm_start_vals(p2, g, first),
                          jax_opt.warm_start_vals(p2, jg, first))
    seeded = opt_alpha.optimize_sparse(p2, active=active, graph=g, vals0=got, sweeps=10)
    assert np.array_equal(seeded.vals, jax_opt.optimize_sparse(
        p2, active=active, graph=jg, vals0=got, sweeps=10).vals)
    assert np.array_equal(opt_alpha.colrel_expected_coverage(p, adj),
                          jax_opt.colrel_expected_coverage(p, adj))
    with pytest.raises(ValueError, match="adj or graph"):
        opt_alpha.optimize_sparse(p)


# ----------------------------------------------------------- cohort sampling


def _sampler(ch, strategy, base, every, n=40):
    kw = dict(k=9) if strategy != "uniform" else dict(rate=0.3)
    member = None
    if base == "churn":
        member = ch.MarkovChurn(n, p_leave=0.2, p_join=0.4, seed=5)
    return ch.CohortSampler(n, strategy=strategy, base=member, resample_every=every,
                            seed=13, **kw)


@pytest.mark.parametrize("every", [1, 3])
@pytest.mark.parametrize("base", ["none", "churn"])
@pytest.mark.parametrize("strategy", ["uniform", "fixed_k", "expander"])
def test_cohort_sampler_masks_equal_jax(strategy, base, every):
    got, want = _sampler(channels, strategy, base, every), _sampler(jax_channels, strategy,
                                                                    base, every)
    assert np.array_equal(got.value(), want.value())
    for _ in range(25):
        a, b = got.step(), want.step()
        assert a.dtype == b.dtype and np.array_equal(a, b)
        assert a.any()  # never an empty cohort


def test_cohort_sampler_rejects_what_jax_rejects():
    for kw in (dict(strategy="poisson", k=2), dict(strategy="uniform"),
               dict(strategy="fixed_k", k=0), dict(strategy="fixed_k", k=2,
                                                   resample_every=0)):
        with pytest.raises(ValueError):
            channels.CohortSampler(8, **kw)
        with pytest.raises(ValueError):
            jax_channels.CohortSampler(8, **kw)


def _sampled_schedule(ch, top, n=48, seed=4):
    member = ch.CohortSampler(n, strategy="fixed_k", k=10,
                              base=ch.RotatingCohorts(n, n_cohorts=3, hold=4), seed=seed)
    link = ch.MarkovLinkProcess(top.random_geometric(n, 0.3, seed=seed), p_up_to_down=0.2,
                                p_down_to_up=0.5, seed=seed + 1)
    return ch.ChurnSchedule(membership=member, link_process=link,
                            p=np.linspace(0.2, 0.9, n), adj_every=5)


def test_sparse_policy_stream_and_stats_equal_jax():
    """SparseOptAlpha over a cohort-sampled, fading schedule: the same
    EdgeRelay (indices, values) every round, the same counters, and the
    layout of each graph shared by its rounds."""
    sched, jsched = _sampled_schedule(channels, topology), _sampled_schedule(jax_channels,
                                                                             jax_topology)
    pol = channels.SparseOptAlpha(sweeps=30, warm_sweeps=8, cache_size=4)
    jpol = jax_channels.SparseOptAlpha(sweeps=30, warm_sweeps=8, cache_size=4)
    layouts = set()
    for st, jst in zip(sched.rounds(20), jsched.rounds(20), strict=True):
        assert st.key() == jst.key()
        er, jer = pol.relay_matrix(st), jpol.relay_matrix(jst)
        for a, b in zip(er[:3], jer):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert not er.vals.flags.writeable and not er.layout.by_row.flags.writeable
        layouts.add(id(er.layout))
    assert dataclasses.asdict(pol.stats) == dataclasses.asdict(jpol.stats)
    assert pol.stats.evictions > 0 and pol.stats.warm_solves > 0
    assert len(layouts) == 4  # one layout per graph (adj changes every 5 rounds)


def test_sparse_policy_caches_and_warm_starts_across_cohorts():
    n = 16
    p = np.random.default_rng(19).uniform(0.2, 0.9, n).astype(np.float32)
    adj = topology.ring(n, 2)
    m1, m2 = np.arange(n) < 8, np.arange(n) >= 8
    pol = channels.SparseOptAlpha(sweeps=40, warm_sweeps=10)
    A1 = pol.relay_matrix(channels.ChannelState(0, 0, adj, p, m1))
    A2 = pol.relay_matrix(channels.ChannelState(1, 1, adj, p, m2))
    A1_again = pol.relay_matrix(channels.ChannelState(2, 0, adj, p, m1))
    assert pol.stats.solves == 2 and pol.stats.cache_hits == 1
    assert A1_again is A1
    dead = ~m1[A1.rows] | ~m1[A1.cols]
    assert np.all(A1.vals[dead] == 0.0) and not np.array_equal(A1.vals, A2.vals)


# --------------------------------------------------------- the round, engines


def quad_loss(params, batch):
    diff = params["x"][None, :] - batch["c"]
    return 0.5 * torch.mean(torch.sum(diff**2, dim=-1))


def jax_quad_loss(params, batch):
    diff = params["x"][None, :] - batch["c"]
    return 0.5 * jnp.mean(jnp.sum(diff**2, axis=-1))


@pytest.mark.parametrize("strategy", ["colrel", "colrel_fused"])
def test_simulator_round_on_segment_matches_jax(strategy):
    """One FLSimulator round on ``segment`` under churn, τ, params, batch
    and the EdgeRelay handed over from numpy: within 1e-5 of the JAX
    package's round (params and metrics)."""
    res, p, _, tau, act, _ = _setting(10, n=12)
    n, dim, T = 12, 5, 2
    rng = np.random.default_rng(10)
    x0 = rng.standard_normal(dim).astype(np.float32)
    batch = {"c": rng.standard_normal((n, T, 3, dim)).astype(np.float32)}
    er = res.edge_relay()
    sim = FLSimulator(quad_loss, n_clients=n, strategy=strategy, p=p, local_steps=T,
                      relay_backend="segment", server_opt=ServerOpt(momentum=0.5),
                      device="cpu")
    jsim = JaxSimulator(jax_quad_loss, n_clients=n, strategy=strategy, p=p, local_steps=T,
                        relay_backend="segment",
                        server_opt=jax_agg.ServerOpt(momentum=0.5))
    params, jparams = {"x": torch.from_numpy(x0)}, {"x": jnp.asarray(x0)}
    state, jstate = sim.init_server_state(params), jsim.init_server_state(jparams)
    got, _, m = sim.run_round(None, params, state, batch, 0.1, A=er, active=act, tau=tau)
    jax_round = jax.jit(jsim._round_math)
    want, _, jm = jax_round(jparams, jstate, jax.tree.map(jnp.asarray, batch),
                            jnp.asarray(tau), _jax_er(er), 0.1, jnp.asarray(act))
    np.testing.assert_allclose(got["x"].numpy(), np.asarray(want["x"]), atol=1e-5, rtol=1e-5)
    for key in ("loss", "tau", "delta_norm"):
        np.testing.assert_allclose(m[key].numpy(), np.asarray(jm[key]), atol=1e-5, rtol=1e-5)


def _run_segment_engine(engine):
    n, dim, T = 24, 4, 2
    rng = np.random.default_rng(42)
    sim = FLSimulator(quad_loss, n_clients=n, strategy="colrel_fused", local_steps=T,
                      relay_backend="segment", server_opt=ServerOpt(momentum=0.5),
                      device="cpu")
    params = {"x": torch.ones(dim)}
    kw = dict(schedule=_sampled_schedule(channels, topology, n=n), rounds=11, lr=0.1,
              policy=channels.SparseOptAlpha(sweeps=20, warm_sweeps=6),
              next_batch=lambda: {"c": rng.standard_normal((n, T, 3, dim)).astype(np.float32)})
    gen = torch.Generator().manual_seed(7)
    state = sim.init_server_state(params)
    if engine == "loop":
        out = run_rounds_loop(sim, gen, params, state, **kw)
    elif engine == "scan":
        out = EpochScanEngine(sim, chunk=3).run_schedule(gen, params, state, **kw)
    else:
        out = PipelinedScanEngine(sim, chunk=3, prefetch=engine.split("_")[1]).run_schedule(
            gen, params, state, **kw)
    params, state, metrics, gen = out
    return params, state, metrics, gen.get_state()


@pytest.mark.parametrize("engine", ["scan", "pipelined_inline", "pipelined_thread"])
def test_engines_bitwise_equal_to_loop_on_segment(engine):
    lp, ls, lm, lg = _run_segment_engine("loop")
    ep, es, em, eg = _run_segment_engine(engine)
    assert torch.equal(ep["x"], lp["x"]) and torch.equal(es["x"], ls["x"])
    for key in ("loss", "tau", "delta_norm"):
        assert torch.equal(em[key], lm[key])
    assert torch.equal(eg, lg)
    assert torch.isfinite(lm["loss"]).all()


def test_sample_sweep_smoke_through_run_scenario_on_cpu():
    from repro_torch.bench import harness, scenarios

    spec = dataclasses.replace(scenarios.get_scenario("sample_sweep_smoke"), rounds=3)
    result = harness.run_scenario(spec, device="cpu")
    assert result["bitwise_match"] is True
    check = result["kernel_check"]
    assert check["backend"] == "einsum" and check["reference_backend"] == "segment"
    assert check["allclose"] and check["max_abs_diff"] <= 1e-5
    assert set(result["runs"]) == {"loop", "scan", "pipelined", "scan_einsum"}
    assert result["model_params"] == 698
