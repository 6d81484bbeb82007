"""The port's arrival delays and asynchronous round engine
(``repro_torch.channels.delay``, ``repro_torch.fl.async_engine``) against the
JAX package's.  Oracle: ``tests/test_async_engine.py``.

* Host streams, equal: every delay process and ``make_delays`` (with
  ``reset``), ``staleness_discounts`` and ``select_freshest``.
* Device math within a stated tolerance of the JAX package:
  ``staleness_weights`` and ``async_coefficients`` 1e-6 (a handful of f32
  products and one sum); several delayed rounds through both packages'
  ``AsyncRoundEngine._round_step`` with the same τ, batches, relay operand,
  churn mask and delay stream, 1e-5 on params and metrics (on ``einsum``,
  the fused kernel's wrapper against ``pallas_fused`` in interpret mode, and
  ``segment``).
* The port's own contracts: at delay 0 the engine is bitwise equal to the
  port's ``run_rounds_loop`` (params, server state, metrics, generator
  state) for every supported strategy, under churn and on a static channel
  (the full-sync path), and on ``segment``; the newest arrival wins;
  never-arrived slots add zero; ``reset=False`` bursts equal one
  uninterrupted run; ``colrel`` and ``fedavg_nonblind`` are refused; the
  tracer is a pure observer; ``async_smoke`` passes through
  ``run_scenario`` on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import channels as jax_channels
from repro.core import aggregation as jax_agg
from repro.core import relay as jax_relay
from repro.core import topology as jax_topology
from repro.fl import async_engine as jax_async
from repro.fl.simulator import FLSimulator as JaxSimulator
from repro.utils import tree_spec as jax_tree_spec
from repro_torch import channels
from repro_torch.channels.delay import (
    DelayProcess,
    GeometricDelays,
    PoissonDelays,
    ZeroDelays,
    make_delays,
)
from repro_torch.core import aggregation, opt_alpha, topology
from repro_torch.core import relay as relay_lib
from repro_torch.core.aggregation import ServerOpt
from repro_torch.fl import async_engine
from repro_torch.fl.async_engine import AsyncRoundEngine, select_freshest
from repro_torch.fl.engine import run_rounds_loop
from repro_torch.fl.simulator import FLSimulator
from repro_torch.obs import Tracer
from repro_torch.utils import tree_spec

N, DIM, T = 6, 4, 2


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    # the suite runs several test processes side by side
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def quad_loss(params, batch):
    diff = params["x"][None, :] - batch["c"]
    return 0.5 * torch.mean(torch.sum(diff**2, dim=-1))


def jax_quad_loss(params, batch):
    diff = params["x"][None, :] - batch["c"]
    return 0.5 * jnp.mean(jnp.sum(diff**2, axis=-1))


def _batch_stream(seed=42, n=N):
    rng = np.random.default_rng(seed)
    return lambda: {"c": rng.standard_normal((n, T, 4, DIM)).astype(np.float32)}


def _churn_shadow_schedule(ch=channels, top=topology, seed=3):
    """Rotating-cohort churn over a correlated-shadowing D2D graph (either
    package's modules)."""
    field = ch.ShadowingField(ch.circle_positions(N), corr_length=0.4, rho=0.9, sigma=1.0,
                              seed=seed)
    link = ch.ShadowedLinkProcess(top.ring(N, 2), field, threshold=1.0)
    member = ch.RotatingCohorts(N, n_cohorts=3, hold=5)
    return ch.ChurnSchedule(membership=member, link_process=link,
                            p=np.linspace(0.3, 0.9, N), adj_every=3, p_every=4)


def _static_schedule():
    return channels.StaticChannel(topology.ring(N, 2), np.linspace(0.3, 0.9, N))


def _equal(a, b) -> bool:
    from repro_torch.utils import tree_flatten

    la = [] if a is None else tree_flatten(a)[0]
    lb = [] if b is None else tree_flatten(b)[0]
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def _run(engine_kind, *, rounds=17, delays=None, schedule_fn=_churn_shadow_schedule,
         strategy="colrel_fused", backend="einsum", momentum=0.5, seed=42, tracer=None,
         **engine_kw):
    next_batch = _batch_stream(seed)
    sim = FLSimulator(quad_loss, n_clients=N, strategy=strategy, local_steps=T,
                      relay_backend=backend, server_opt=ServerOpt(momentum=momentum),
                      device="cpu")
    params = {"x": torch.ones(DIM)}
    state = sim.init_server_state(params)
    gen = torch.Generator().manual_seed(7)
    policy = (channels.AdaptiveOptAlpha(sweeps=20, warm_sweeps=8)
              if strategy == "colrel_fused" else None)
    kw = dict(schedule=schedule_fn(), rounds=rounds, next_batch=next_batch, lr=0.1,
              policy=policy)
    if engine_kind == "loop":
        out = run_rounds_loop(sim, gen, params, state, **kw)
    else:
        engine = AsyncRoundEngine(sim, delays=delays, tracer=tracer, **engine_kw)
        out = engine.run_schedule(gen, params, state, **kw)
    params, state, metrics, gen = out
    return params, state, metrics, gen.get_state()


# ---------------------------------------------------------- delay streams


def _delay_pair(kind, **kw):
    return getattr(channels, kind)(**kw), getattr(jax_channels, kind)(**kw)


@pytest.mark.parametrize("kind,kw", [
    ("ZeroDelays", dict(n=7, seed=1)),
    ("PoissonDelays", dict(n=9, rate=1.5, max_delay=4, seed=4)),
    ("PoissonDelays", dict(n=16, rate=50.0, max_delay=3, seed=0)),
    ("GeometricDelays", dict(n=9, mean=2.0, max_delay=8, seed=4)),
    ("GeometricDelays", dict(n=5, mean=0.0, seed=2)),
], ids=lambda x: str(x))
def test_delay_streams_equal_jax_and_replay_after_reset(kind, kw):
    got, want = _delay_pair(kind, **kw)
    first = [got.sample() for _ in range(6)]
    for d in first:
        w = want.sample()
        assert d.dtype == w.dtype == np.int64 and np.array_equal(d, w)
        assert d.min() >= 0 and d.max() <= got.max_delay
    assert got.round == want.round == 6
    got.reset()
    assert got.round == 0
    assert all(np.array_equal(a, got.sample()) for a in first)


@pytest.mark.parametrize("kind", ["none", "poisson", "geometric"])
def test_make_delays_equals_jax(kind):
    got = make_delays(kind, 8, rate=1.2, max_delay=5, seed=3)
    want = jax_channels.make_delays(kind, 8, rate=1.2, max_delay=5, seed=3)
    assert type(got).__name__ == type(want).__name__
    for _ in range(5):
        assert np.array_equal(got.sample(), want.sample())


def test_delay_validation_and_support():
    with pytest.raises(ValueError, match="unknown delay process"):
        make_delays("uniform", 5)
    for bad in (dict(n=0), dict(n=3, max_delay=-1)):
        with pytest.raises(ValueError):
            PoissonDelays(**bad)
    with pytest.raises(ValueError, match="rate"):
        PoissonDelays(3, rate=-1.0)
    with pytest.raises(ValueError, match="mean"):
        GeometricDelays(3, mean=-1.0)
    d = np.concatenate([GeometricDelays(64, mean=0.5, seed=1).sample() for _ in range(8)])
    assert d.min() == 0  # support {0, 1, ...}, not the raw geometric {1, ...}
    with pytest.raises(NotImplementedError):
        DelayProcess(3).sample()


# -------------------------------------------------- staleness-weight math


@pytest.mark.parametrize("decay", [0.8, 1.0, 0.37])
def test_staleness_discounts_equal_jax(decay):
    s = np.array([0, 1, 2, 5, 0, 8, 3])
    got = async_engine.staleness_discounts(s, decay=decay)
    want = jax_async.staleness_discounts(s, decay=decay)
    assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want)
    assert np.all(got[s == 0] == np.float32(1.0))


@pytest.mark.parametrize("seed", range(4))
def test_select_freshest_equals_jax(seed):
    rng = np.random.default_rng(seed)
    stale = rng.integers(0, 6, 12)
    elig = rng.random(12) < 0.7
    for k in (0, 1, 3, 5, 12, 99):
        got = select_freshest(stale, elig, k)
        assert np.array_equal(got, jax_async.select_freshest(stale, elig, k))
        assert not np.any(got & ~elig)


def test_select_freshest_caps_and_orders():
    stale = np.array([3, 0, 2, 0, 5, 1])
    elig = np.ones(6, bool)
    assert np.array_equal(select_freshest(stale, elig, 3),
                          [False, True, False, True, False, True])
    assert np.array_equal(select_freshest(stale, elig, 0), elig)
    elig2 = np.array([True, False, True, True, True, True])
    assert not select_freshest(stale, elig2, 3)[1]


@pytest.mark.parametrize("case", ["mixed", "all_fresh", "empty"])
def test_staleness_weights_match_jax(case):
    m = {"mixed": np.array([1.0, 0.8, 0.0, 0.64, 1.0, 0.0], np.float32),
         "all_fresh": np.array([1.0, 1.0, 0.0, 1.0, 1.0, 1.0], np.float32),
         "empty": np.zeros(6, np.float32)}[case]
    got = async_engine.staleness_weights(torch.from_numpy(m))
    want = jax_async.staleness_weights(jnp.asarray(m))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)
    if case == "empty":
        assert torch.all(got == 0)
    else:
        assert abs(float(got.sum()) - 1.0) < 1e-6
    if case == "all_fresh":
        # the live weights are the synchronous 1/n_active exactly
        assert torch.all(got[m > 0] == 1.0 / torch.clamp(torch.tensor(5.0), min=1.0))


def _sparse_operand(n=N, seed=0):
    rng = np.random.default_rng(seed)
    p = rng.uniform(0.2, 0.9, n)
    res = opt_alpha.optimize_sparse(p, topology.ring(n, 2), sweeps=50)
    return res


@pytest.mark.parametrize("backend", ["einsum", "segment"])
@pytest.mark.parametrize("churn", [False, True])
def test_async_coefficients_and_increment_match_jax(backend, churn):
    rng = np.random.default_rng(3)
    res = _sparse_operand(seed=3)
    tau = (rng.random(N) < 0.6).astype(np.float32)
    act = np.array([1, 1, 0, 1, 1, 0], np.float32) if churn else None
    m = np.array([1.0, 0.8, 0.0, 0.64, 1.0, 0.5], np.float32)
    buf = rng.standard_normal((N, 11)).astype(np.float32)
    if backend == "segment":
        A, jA = res.edge_relay(), jax_relay.EdgeRelay(*map(jnp.asarray, res.edge_relay()[:3]))
    else:
        A = jA = res.todense().astype(np.float32)
    t_act = None if act is None else torch.from_numpy(act)
    j_act = None if act is None else jnp.asarray(act)
    got = async_engine.async_coefficients(A, torch.from_numpy(tau), torch.from_numpy(m), n=N,
                                          active=t_act, backend=backend)
    want = jax_async.async_coefficients(jA, jnp.asarray(tau), jnp.asarray(m), n=N,
                                        active=j_act, backend=backend)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)
    inc = async_engine.async_increment_flat(A, torch.from_numpy(tau), torch.from_numpy(m),
                                            torch.from_numpy(buf), n=N, active=t_act,
                                            backend=backend)
    jinc = jax_async.async_increment_flat(jA, jnp.asarray(tau), jnp.asarray(m),
                                          jnp.asarray(buf), n=N, active=j_act, backend=backend)
    np.testing.assert_allclose(inc.numpy(), np.asarray(jinc), atol=1e-5, rtol=1e-5)
    # at m = active (all fresh) the coefficients are the synchronous w·τᵀA bits
    a = torch.ones(N) if act is None else torch.from_numpy(act)
    sync = aggregation.active_weight(a, n=N) * relay_lib.fused_coefficients(
        relay_lib.mask_relay_matrix(relay_lib.as_relay_operand(A, n=N, backend=backend), a),
        torch.from_numpy(tau) * a)
    assert torch.equal(async_engine.async_coefficients(A, torch.from_numpy(tau), a, n=N,
                                                       active=a, backend=backend), sync)
    if backend == "segment":
        with pytest.raises(ValueError, match="EdgeRelay"):
            async_engine.async_coefficients(res.todense(), torch.from_numpy(tau),
                                            torch.from_numpy(m), n=N, backend="segment")


# ------------------------------------------- rounds against the JAX engine


def _geometric_sampled_schedule(ch, top, n=12, seed=5):
    member = ch.CohortSampler(n, strategy="fixed_k", k=7, seed=seed)
    return ch.ChurnSchedule(membership=member, adj=top.random_geometric(n, 0.45, seed=seed),
                            p=np.linspace(0.3, 0.9, n))


@pytest.mark.parametrize("backend,buffer_k", [("einsum", 0), ("einsum", 3),
                                              ("hopper_fused", 2), ("segment", 0)])
def test_delayed_rounds_match_jax_round_step(backend, buffer_k):
    """Several delayed rounds through each package's
    ``_round_step(t, state, params, server_state, batch, tau, A, lr,
    active)``, with the same τ, batches, relay operand, churn mask and delay
    stream: params, per-round metrics and the buffers' bookkeeping within
    1e-5 / equal."""
    n = 12 if backend == "segment" else N
    rounds = 9
    jbackend = {"hopper_fused": "pallas_fused"}.get(backend, backend)
    if backend == "segment":
        sched = _geometric_sampled_schedule(channels, topology)
        jsched = _geometric_sampled_schedule(jax_channels, jax_topology)
        pol, jpol = channels.SparseOptAlpha(sweeps=20), jax_channels.SparseOptAlpha(sweeps=20)
    else:
        sched = _churn_shadow_schedule()
        jsched = _churn_shadow_schedule(jax_channels, jax_topology)
        pol, jpol = channels.AdaptiveOptAlpha(sweeps=20), jax_channels.AdaptiveOptAlpha(sweeps=20)
    sim = FLSimulator(quad_loss, n_clients=n, strategy="colrel_fused", local_steps=T,
                      relay_backend=backend, server_opt=ServerOpt(momentum=0.5),
                      device="cpu")
    jsim = JaxSimulator(jax_quad_loss, n_clients=n, strategy="colrel_fused", local_steps=T,
                        relay_backend=jbackend,
                        server_opt=jax_agg.ServerOpt(momentum=0.5))
    delays = dict(rate=1.0, max_delay=3, seed=9)
    eng = AsyncRoundEngine(sim, delays=PoissonDelays(n, **delays), buffer_k=buffer_k)
    jeng = jax_async.AsyncRoundEngine(jsim, delays=jax_channels.PoissonDelays(n, **delays),
                                      buffer_k=buffer_k, interpret=True)
    x0 = np.full(DIM, 1.0, np.float32)
    params, jparams = {"x": torch.from_numpy(x0.copy())}, {"x": jnp.asarray(x0)}
    state, jstate = sim.init_server_state(params), jsim.init_server_state(jparams)
    eng._spec, jeng._spec = tree_spec(params), jax_tree_spec(jparams)
    eng._held_buf, jeng._held_buf = torch.zeros(n, DIM), jnp.zeros((n, DIM), jnp.float32)
    eng._held_coeffs, jeng._held_coeffs = torch.zeros(n), jnp.zeros((n,), jnp.float32)
    rng = np.random.default_rng(1)
    next_batch = _batch_stream(2, n)
    superseded = 0
    for t, (st, jst) in enumerate(zip(sched.rounds(rounds), jsched.rounds(rounds),
                                      strict=True)):
        A, jA = pol.relay_matrix(st), jpol.relay_matrix(jst)
        batch = next_batch()
        tau = (rng.random(n) < st.p).astype(np.float32)
        act = None if st.active is None else st.active.astype(np.float32)
        A_t = relay_lib.as_relay_operand(A, n=n, backend=backend, device="cpu")
        (params, state, m), stats = eng._round_step(
            t, st, params, state, sim._to_device(batch), torch.from_numpy(tau), A_t, 0.1,
            None if act is None else torch.from_numpy(act))
        (jparams, jstate, jm), jstats = jeng._round_step(
            t, jst, jparams, jstate, jax.tree.map(jnp.asarray, batch), jnp.asarray(tau),
            jax_relay.as_relay_operand(jA, n=n, backend=jbackend), 0.1,
            None if act is None else jnp.asarray(act))
        assert stats == jstats
        superseded += stats["superseded"]
        np.testing.assert_allclose(params["x"].numpy(), np.asarray(jparams["x"]),
                                   atol=1e-5, rtol=1e-5)
        for key in ("loss", "tau", "delta_norm"):
            np.testing.assert_allclose(m[key].numpy(), np.asarray(jm[key]), atol=1e-5,
                                       rtol=1e-5)
        assert np.array_equal(eng._held_round, jeng._held_round)
    assert superseded > 0 or backend == "segment"


# ---------------------------------------------- delay 0 equals the loop


@pytest.mark.parametrize("strategy", ["colrel_fused", "fedavg_blind", "no_dropout"])
def test_delay0_bitwise_identical_to_loop_under_churn_shadowing(strategy):
    lp, ls, lm, lg = _run("loop", strategy=strategy)
    ap, as_, am, ag = _run("async", delays=ZeroDelays(N), strategy=strategy)
    assert _equal(lp, ap) and _equal(ls, as_) and _equal(lm, am)
    assert torch.equal(lg, ag)


@pytest.mark.parametrize("strategy", ["colrel_fused", "fedavg_blind", "no_dropout"])
def test_delay0_bitwise_on_static_channel_full_sync_path(strategy):
    lp, ls, lm, lg = _run("loop", schedule_fn=_static_schedule, strategy=strategy)
    ap, as_, am, ag = _run("async", schedule_fn=_static_schedule, strategy=strategy)
    assert _equal(lp, ap) and _equal(ls, as_) and _equal(lm, am)
    assert torch.equal(lg, ag)


@pytest.mark.parametrize("backend", ["hopper_fused", "segment"])
def test_delay0_bitwise_on_kernel_and_segment_backends(backend):
    """On ``hopper_fused`` (the fused kernel's wrapper; its plain version on
    the CPU) and on ``segment`` (EdgeRelays from SparseOptAlpha over a
    cohort-sampled graph) the engine at delay 0 is the loop, bit for bit."""
    n = 12

    def run(kind):
        next_batch = _batch_stream(4, n)
        sim = FLSimulator(quad_loss, n_clients=n, strategy="colrel_fused", local_steps=T,
                          relay_backend=backend, server_opt=ServerOpt(momentum=0.5),
                          device="cpu")
        params = {"x": torch.ones(DIM)}
        gen = torch.Generator().manual_seed(3)
        pol = (channels.SparseOptAlpha(sweeps=20) if backend == "segment"
               else channels.AdaptiveOptAlpha(sweeps=20))
        kw = dict(schedule=_geometric_sampled_schedule(channels, topology, n=n), rounds=10,
                  next_batch=next_batch, lr=0.1, policy=pol)
        state = sim.init_server_state(params)
        if kind == "loop":
            return run_rounds_loop(sim, gen, params, state, **kw)
        return AsyncRoundEngine(sim).run_schedule(gen, params, state, **kw)

    lp, ls, lm, lg = run("loop")
    ap, as_, am, ag = run("async")
    assert _equal(lp, ap) and _equal(ls, as_) and _equal(lm, am)
    assert torch.equal(lg.get_state(), ag.get_state())


# ------------------------------------------------------------ delayed runs


def test_nonzero_delay_diverges_but_stays_finite():
    lp, *_ = _run("loop", schedule_fn=_static_schedule)
    ap, _, am, _ = _run("async", delays=PoissonDelays(N, rate=1.0, seed=5),
                        schedule_fn=_static_schedule)
    assert not _equal(lp, ap)
    assert torch.isfinite(am["loss"]).all() and torch.isfinite(ap["x"]).all()


def test_buffer_k_truncates_even_at_delay0():
    full = _run("async", delays=ZeroDelays(N), schedule_fn=_static_schedule)
    capped = _run("async", delays=ZeroDelays(N), schedule_fn=_static_schedule, buffer_k=3)
    assert not _equal(full[0], capped[0])


def test_never_arrived_rounds_apply_zero_increment():
    class FixedDelay(DelayProcess):
        def _draw(self, rng):
            return np.full(self.n, 3)

    sim = FLSimulator(quad_loss, n_clients=N, strategy="fedavg_blind", local_steps=T,
                      device="cpu")
    params = {"x": torch.ones(DIM)}
    engine = AsyncRoundEngine(sim, delays=FixedDelay(N, max_delay=8))
    seen = []
    engine.run_schedule(torch.Generator().manual_seed(0), params,
                        sim.init_server_state(params), schedule=_static_schedule(),
                        rounds=5, next_batch=_batch_stream(), lr=0.1,
                        on_round=lambda r, p: seen.append(p["x"].clone()))
    for r in range(3):  # the first arrivals land at t = 3
        assert torch.equal(seen[r], params["x"])
    assert not torch.equal(seen[3], params["x"])


def test_newest_arrival_supersedes_older_in_flight():
    class TwoThenOne(DelayProcess):
        def _draw(self, rng):
            return np.full(self.n, 2 if self.round == 0 else 1)

    sim = FLSimulator(quad_loss, n_clients=N, strategy="fedavg_blind", local_steps=T,
                      device="cpu")
    params = {"x": torch.ones(DIM)}
    tracer = Tracer()
    engine = AsyncRoundEngine(sim, delays=TwoThenOne(N), tracer=tracer)
    engine.run_schedule(torch.Generator().manual_seed(0), params,
                        sim.init_server_state(params), schedule=_static_schedule(),
                        rounds=3, next_batch=_batch_stream(), lr=0.1)
    # rounds 0 and 1 both land at t = 2, oldest first: round 1 overwrites
    assert np.array_equal(engine._held_round, np.full(N, 1))
    assert tracer.counters["async.arrivals"] == 2 * N
    assert "async.superseded" not in tracer.counters

    class TwoThenZero(DelayProcess):
        def _draw(self, rng):
            return np.full(self.n, 2 if self.round == 0 else 0)

    tracer = Tracer()
    engine = AsyncRoundEngine(sim, delays=TwoThenZero(N), tracer=tracer)
    engine.run_schedule(torch.Generator().manual_seed(0), params,
                        sim.init_server_state(params), schedule=_static_schedule(),
                        rounds=3, next_batch=_batch_stream(), lr=0.1)
    # round 0 lands at t = 2, after round 1 (t = 1): superseded, dropped
    assert np.array_equal(engine._held_round, np.full(N, 2))
    assert tracer.counters["async.superseded"] == N


def test_held_buffers_are_their_own_tensors():
    """A merge returns new tensors: the pending round buffers and the held
    buffer never alias, so a later round cannot overwrite a buffered row."""
    src = torch.arange(12.0).reshape(3, 4)
    held = torch.zeros(3, 4)
    new_buf, new_c = AsyncRoundEngine._merge(torch.tensor([1.0, 0.0, 1.0]), src,
                                             torch.ones(3), held, torch.zeros(3))
    assert torch.equal(new_buf[0], src[0]) and torch.equal(new_buf[1], held[1])
    assert new_buf.data_ptr() not in (src.data_ptr(), held.data_ptr())
    assert torch.equal(new_c, torch.tensor([1.0, 0.0, 1.0]))


# ------------------------------------------------------------- validation


@pytest.mark.parametrize("strategy", ["colrel", "fedavg_nonblind"])
def test_unsupported_strategies_refused(strategy):
    sim = FLSimulator(quad_loss, n_clients=N, strategy=strategy, device="cpu")
    with pytest.raises(ValueError, match="supports strategies"):
        AsyncRoundEngine(sim)


def test_constructor_validation():
    sim = FLSimulator(quad_loss, n_clients=N, strategy="colrel_fused", device="cpu")
    with pytest.raises(ValueError, match="staleness_decay"):
        AsyncRoundEngine(sim, staleness_decay=0.0)
    with pytest.raises(ValueError, match="buffer_k"):
        AsyncRoundEngine(sim, buffer_k=-1)
    with pytest.raises(ValueError, match="delay process"):
        AsyncRoundEngine(sim, delays=ZeroDelays(N + 1))


# ------------------------------------------------------------ continuation


def test_burst_continuation_matches_uninterrupted_run():
    rounds = 12

    def run_bursts(splits):
        next_batch = _batch_stream()
        sim = FLSimulator(quad_loss, n_clients=N, strategy="colrel_fused", local_steps=T,
                          server_opt=ServerOpt(momentum=0.5), device="cpu")
        params = {"x": torch.ones(DIM)}
        state = sim.init_server_state(params)
        gen = torch.Generator().manual_seed(7)
        policy = channels.AdaptiveOptAlpha(sweeps=20, warm_sweeps=8)
        schedule = _churn_shadow_schedule()
        engine = AsyncRoundEngine(sim, delays=PoissonDelays(N, rate=1.0, seed=5))
        for i, r in enumerate(splits):
            params, state, _, gen = engine.run_schedule(
                gen, params, state, schedule=schedule, rounds=r, next_batch=next_batch,
                lr=0.1, policy=policy, reset=i == 0)
        return params, state, gen.get_state()

    p1, s1, g1 = run_bursts([rounds])
    p2, s2, g2 = run_bursts([5, rounds - 5])
    assert _equal(p1, p2) and _equal(s1, s2) and torch.equal(g1, g2)


def test_tracing_is_a_pure_observer():
    tracer = Tracer()
    plain = _run("async", delays=GeometricDelays(N, mean=1.0, seed=2), buffer_k=4)
    traced = _run("async", delays=GeometricDelays(N, mean=1.0, seed=2), buffer_k=4,
                  tracer=tracer)
    assert _equal(plain[0], traced[0]) and _equal(plain[2], traced[2])
    assert tracer.counters["async.rounds"] == 17
    assert tracer.counters["async.selected"] <= 17 * 4
    buffers = [e for e in tracer.instants if e.name == "async.buffer"]
    assert len(buffers) == 17 and all(b.attrs["selected"] <= 4 for b in buffers)
    assert len([s for s in tracer.spans if s.name == "async.round"]) == 17


def test_async_smoke_through_run_scenario_on_cpu():
    from repro_torch.bench import harness, scenarios

    spec = dataclasses.replace(scenarios.get_scenario("async_smoke"), rounds=12)
    result = harness.run_scenario(spec, device="cpu")
    check = result["async_check"]
    assert check == {"reference": "loop", "bitwise": True, "recorded_delay": "geometric",
                     "rounds_per_sec": result["runs"]["async_delay0"].rounds_per_sec}
    assert set(result["runs"]) == {"loop", "async", "async_delay0"}
    assert set(result["ttac"]["engines"]) == {"loop", "async", "async_delay0"}
    assert result["bitwise_match"] is None  # the delayed run stays out of the gate
    assert all(np.isfinite(r.losses).all() for r in result["runs"].values())
