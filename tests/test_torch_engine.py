"""The port's round engines (``repro_torch.fl.engine``).

* Within the port, bitwise: ``run_rounds_loop``, ``EpochScanEngine`` and
  ``PipelinedScanEngine`` (inline and threaded prefetch) give the same
  params, server state, per-round metrics and generator state, for every
  strategy, over a schedule whose adjacency, p and membership all change
  and whose segments vary in length (``_churn_drift_schedule`` of
  ``tests/test_scan_engine.py``).  Also ``on_segment``, an enabled tracer
  and the engines' errors.
* Across packages, 1e-5: the same schedule walked segment by segment through
  each package's ``EpochScanEngine.run_segment``, with A from each package's
  ``AdaptiveOptAlpha``, τ from the JAX engine's ``sample_taus`` handed over
  as arrays (torch cannot draw threefry's numbers) and batches from numpy,
  for the quadratic model of ``tests/test_scan_engine.py`` and for
  ResNet-20/GN at a small size.  ResNet runs at lr 1e-3: the two packages'
  convolutions round differently (~1e-7), and at a larger lr a ReLU that
  flips on that noise moves a gradient by ~3e-3 (``ROADMAP.md`` §3).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import channels as jax_channels
from repro.configs.resnet20_cifar import CONFIG as JAX_CONFIG
from repro.core import topology as jax_topology
from repro.core.aggregation import ServerOpt as JaxServerOpt
from repro.fl.engine import EpochScanEngine as JaxEpochScanEngine
from repro.fl.simulator import FLSimulator as JaxSimulator
from repro.models.resnet import init_resnet20 as jax_init_resnet20
from repro.models.resnet import resnet20_loss as jax_resnet20_loss
from repro_torch import channels
from repro_torch.configs.resnet20_cifar import CONFIG
from repro_torch.core import topology
from repro_torch.core.aggregation import ServerOpt
from repro_torch.fl.engine import EpochScanEngine, PipelinedScanEngine, run_rounds_loop
from repro_torch.fl.simulator import FLSimulator
from repro_torch.models.resnet import resnet20_loss
from repro_torch.obs import Tracer
from repro_torch.utils import from_jax_params, tree_flatten

STRATEGIES = ["colrel", "colrel_fused", "fedavg_blind", "fedavg_nonblind", "no_dropout"]
ENGINES = ["scan", "pipelined_inline", "pipelined_thread"]
N, T, B, DIM, ROUNDS, CHUNK, LR = 6, 2, 4, 4, 17, 4, 0.1


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    # the suite runs several test processes side by side
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _churn_drift_schedule(ch, top, n=N, seed=3):
    """Multi-epoch: Markov fading + piecewise p-drift + rotating churn, with
    misaligned periods so segment lengths vary (either package's modules)."""
    link = ch.MarkovLinkProcess(top.ring(n, 2), p_up_to_down=0.4, p_down_to_up=0.6,
                                seed=seed)
    drift = ch.PiecewiseConstantDrift(np.linspace(0.2, 0.9, n), hold=1, low=0.1, high=0.9,
                                      seed=seed + 1)
    member = ch.RotatingCohorts(n, n_cohorts=3, hold=5)
    return ch.ChurnSchedule(membership=member, link_process=link, p_process=drift,
                            adj_every=3, p_every=4)


def quad_loss(params, batch):
    diff = params["x"][None, :] - batch["c"]
    return 0.5 * torch.mean(torch.sum(diff**2, dim=-1))


def jax_quad_loss(params, batch):
    diff = params["x"][None, :] - batch["c"]
    return 0.5 * jnp.mean(jnp.sum(diff**2, axis=-1))


def _equal(a, b) -> bool:
    la = [] if a is None else tree_flatten(a)[0]
    lb = [] if b is None else tree_flatten(b)[0]
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def _run(strategy, engine, *, tracer=None, on_segment=None, on_round=None):
    """One run of the port on the churn/drift schedule: returns
    (params, server_state, metrics, generator state, policy, engine)."""
    rng = np.random.default_rng(42)
    sim = FLSimulator(quad_loss, n_clients=N, strategy=strategy, local_steps=T,
                      server_opt=ServerOpt(momentum=0.5), device="cpu")
    params = {"x": torch.ones(DIM)}
    schedule = _churn_drift_schedule(channels, topology)
    if tracer is not None:
        schedule.tracer = tracer
    policy = (None if strategy not in ("colrel", "colrel_fused")
              else channels.AdaptiveOptAlpha(sweeps=20, warm_sweeps=8, tracer=tracer))
    kw = dict(schedule=schedule, rounds=ROUNDS, lr=LR, policy=policy,
              next_batch=lambda: {"c": rng.standard_normal((N, T, B, DIM)).astype(np.float32)})
    gen = torch.Generator().manual_seed(7)
    state = sim.init_server_state(params)
    eng = None
    if engine == "loop":
        out = run_rounds_loop(sim, gen, params, state, tracer=tracer, on_round=on_round, **kw)
    elif engine == "scan":
        eng = EpochScanEngine(sim, chunk=CHUNK, tracer=tracer)
        out = eng.run_schedule(gen, params, state, on_segment=on_segment, **kw)
    else:
        eng = PipelinedScanEngine(sim, chunk=CHUNK, prefetch=engine.split("_")[1],
                                  tracer=tracer)
        out = eng.run_schedule(gen, params, state, on_segment=on_segment, **kw)
    params, state, metrics, gen = out
    return params, state, metrics, gen.get_state(), policy, eng


@functools.cache
def _loop(strategy):
    return _run(strategy, "loop")


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_engine_bitwise_equal_to_loop(strategy, engine):
    lp, ls, lm, lg, lpol, _ = _loop(strategy)
    ep, es, em, eg, epol, eng = _run(strategy, engine)
    assert _equal(ep, lp) and _equal(es, ls) and es is not None
    assert set(em) == {"loss", "tau", "delta_norm"} and _equal(em, lm)
    assert em["loss"].shape == (ROUNDS,) and em["tau"].shape == (ROUNDS, N)
    assert torch.equal(eg, lg)
    if lpol is not None:
        # one policy call a segment against one a round: the same solves
        n_segs = len(list(_churn_drift_schedule(channels, topology).segments(ROUNDS)))
        assert epol.stats.solves == lpol.stats.solves and epol.stats.rounds == n_segs
        assert lpol.stats.cache_hits - epol.stats.cache_hits == ROUNDS - n_segs
    if engine.startswith("pipelined"):
        segs = list(_churn_drift_schedule(channels, topology).segments(ROUNDS))
        assert eng.dispatches == sum(-(-s.n_rounds // CHUNK) for s in segs)
        assert eng.prefetch_stats.chunks == eng.dispatches


def test_schedule_has_unequal_epochs_and_churn():
    segs = list(_churn_drift_schedule(channels, topology).segments(ROUNDS))
    lengths = [s.n_rounds for s in segs]
    assert len(segs) > 4 and len(set(lengths)) > 1
    assert any(n > CHUNK for n in lengths) or any(n % CHUNK for n in lengths)
    # churned rounds report an inactive client's τ as 0
    lm = _loop("colrel_fused")[2]
    states = [s for seg in segs for s in seg.states]
    assert any(not s.active.all() for s in states)
    for s, tau in zip(states, lm["tau"]):
        assert tau[~torch.as_tensor(s.active)].eq(0).all()


@pytest.mark.parametrize("engine", ENGINES)
def test_on_segment_hands_over_each_epoch(engine):
    per_round = {}
    _run("colrel_fused", "loop", on_round=lambda r, p: per_round.__setitem__(r, p["x"].clone()))
    seen = []

    def on_segment(seg, params, metrics):
        seen.append((seg.start_round, seg.n_rounds, params["x"].clone(), metrics["loss"]))

    _, _, em, _, _, _ = _run("colrel_fused", engine, on_segment=on_segment)
    segs = list(_churn_drift_schedule(channels, topology).segments(ROUNDS))
    assert [(s, n) for s, n, _, _ in seen] == [(s.start_round, s.n_rounds) for s in segs]
    for start, n, x, loss in seen:
        assert torch.equal(x, per_round[start + n - 1])
        assert torch.equal(loss, em["loss"][start:start + n])


@pytest.mark.parametrize("engine", ["loop"] + ENGINES)
def test_tracing_is_a_pure_observer(engine):
    base = _run("colrel_fused", engine)
    tracer = Tracer()
    traced = _run("colrel_fused", engine, tracer=tracer)
    for a, b in zip(base[:3], traced[:3]):
        assert _equal(a, b)
    assert torch.equal(base[3], traced[3])
    cats = {s.cat for s in tracer.spans}
    assert {"solve", "dispatch", "device"} <= cats
    assert tracer.counters["opt_alpha.solves"] == traced[4].stats.solves
    if engine != "loop":
        assert any(i.name == "segment" for i in tracer.instants)
    if engine.startswith("pipelined"):
        assert {"stage", "h2d"} <= cats
        n = tracer.counters["pipelined.dispatches"]
        assert n == traced[5].dispatches
        assert tracer.counters["prefetch.chunks"] == tracer.counters["prefetch.chunks_staged"] == n
        assert "prefetcher" in {s.track for s in tracer.spans if s.track}


def test_engine_errors():
    sim = FLSimulator(quad_loss, n_clients=N, strategy="colrel_fused", local_steps=T,
                      device="cpu")
    eng = EpochScanEngine(sim, chunk=CHUNK)
    params = {"x": torch.ones(DIM)}
    with pytest.raises(ValueError, match="empty segment"):
        eng.run_segment(params, None, {"c": np.zeros((0, N, T, B, DIM), np.float32)},
                        np.zeros((0, N), np.float32), LR, A=np.eye(N))
    with pytest.raises(ValueError, match="need a relay matrix"):
        eng.run_segment(params, None, {"c": np.zeros((1, N, T, B, DIM), np.float32)},
                        np.ones((1, N), np.float32), LR)
    with pytest.raises(ValueError, match="chunk"):
        EpochScanEngine(sim, chunk=0)
    with pytest.raises(ValueError, match="prefetch mode"):
        PipelinedScanEngine(sim, prefetch="process")


def test_sample_taus_are_the_loops_draws():
    sim = FLSimulator(quad_loss, n_clients=N, strategy="fedavg_blind", device="cpu")
    p = np.linspace(0.2, 0.9, N).astype(np.float32)
    g, taus = EpochScanEngine(sim, chunk=4).sample_taus(torch.Generator().manual_seed(3), p, 10)
    ref = torch.Generator().manual_seed(3)
    assert torch.equal(taus, torch.stack([sim.sample_tau(ref, p) for _ in range(10)]))
    assert torch.equal(g.get_state(), ref.get_state())
    nodrop = FLSimulator(quad_loss, n_clients=N, strategy="no_dropout", device="cpu")
    _, ones = EpochScanEngine(nodrop).sample_taus(torch.Generator(), p, 6)
    assert ones.eq(1).all()


# ------------------------------------------- against the JAX package, 1e-5


def _resnet_batch(rng, n, T, b):
    return {"images": rng.standard_normal((n, T, b, 8, 8, 3)).astype(np.float32),
            "labels": rng.integers(0, 10, (n, T, b)).astype(np.int32)}


MODELS = {
    # (port loss, JAX loss, initial params (JAX), batch maker, n, T, b, lr, rounds)
    "quadratic": (quad_loss, jax_quad_loss, lambda: {"x": jnp.ones((DIM,))},
                  lambda rng, n, T, b: {"c": rng.standard_normal((n, T, b, DIM))
                                        .astype(np.float32)},
                  N, T, B, LR, ROUNDS),
    "resnet20": (lambda p, b: resnet20_loss(p, CONFIG, b),
                 lambda p, b: jax_resnet20_loss(p, JAX_CONFIG, b),
                 lambda: jax_init_resnet20(jax.random.key(0), JAX_CONFIG),
                 _resnet_batch, 4, 2, 2, 1e-3, 8),
}
BACKEND = {"colrel": "hopper", "colrel_fused": "hopper_fused"}


@pytest.mark.parametrize("model,strategy", [("quadratic", "colrel"),
                                            ("quadratic", "colrel_fused"),
                                            ("resnet20", "colrel_fused")])
def test_run_segment_matches_jax_over_a_churn_schedule(model, strategy):
    loss, jax_loss, init, make_batch, n, steps, b, lr, rounds = MODELS[model]
    server = dict(momentum=0.5)
    jsim = JaxSimulator(jax_loss, n_clients=n, strategy=strategy, local_steps=steps,
                        server_opt=JaxServerOpt(**server))
    tsim = FLSimulator(loss, n_clients=n, strategy=strategy, local_steps=steps,
                       server_opt=ServerOpt(**server), relay_backend=BACKEND[strategy],
                       device="cpu")
    jeng, teng = JaxEpochScanEngine(jsim, chunk=3), EpochScanEngine(tsim, chunk=3)
    jpol = jax_channels.AdaptiveOptAlpha(sweeps=20, warm_sweeps=8)
    tpol = channels.AdaptiveOptAlpha(sweeps=20, warm_sweeps=8)
    jparams = init()
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
    js, ts = jsim.init_server_state(jparams), tsim.init_server_state(tparams)
    key, rng = jax.random.key(0), np.random.default_rng(1)
    segs = zip(_churn_drift_schedule(jax_channels, jax_topology, n=n).segments(rounds),
               _churn_drift_schedule(channels, topology, n=n).segments(rounds), strict=True)
    n_segs = 0
    for jseg, tseg in segs:
        A, tA = jpol.relay_matrix(jseg.state), tpol.relay_matrix(tseg.state)
        assert np.array_equal(A, tA)
        key, taus = jeng.sample_taus(key, jseg.p, jseg.n_rounds)
        stacked = [make_batch(rng, n, steps, b) for _ in range(jseg.n_rounds)]
        stacked = {k: np.stack([x[k] for x in stacked]) for k in stacked[0]}
        jparams, js, jm = jeng.run_segment(jparams, js, jax.tree.map(jnp.asarray, stacked),
                                           taus, lr, A=A, active=jseg.active)
        tparams, ts, tm = teng.run_segment(tparams, ts, stacked, np.array(taus), lr,
                                           A=tA, active=tseg.active)
        for want, got in ((jparams, tparams), (js, ts), (jm, tm)):
            for w, g in zip(jax.tree.leaves(want), tree_flatten(got)[0], strict=True):
                np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)
        n_segs += 1
    assert n_segs >= 3
