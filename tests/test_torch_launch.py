"""The port's continuous-training service (``repro_torch.launch``): the
:class:`ContinuousTrainer` in bursts, publish and resume, and the
:class:`SnapshotEvalLoop`, on the CPU.  It mirrors the JAX package's
``tests/test_launch.py`` and ``tests/test_resume.py`` and adds the two
packages side by side.

* On the port, bitwise: bursts of 5 over 15 rounds equal one
  ``run_rounds_loop`` call (params, server state, metrics, generator state)
  on loop, scan and pipelined (inline and threaded prefetch);
  ``restore_latest`` + ``advance_stream`` resume bitwise under the churned
  ``AdaptiveOptAlpha`` stream of ``tests/test_resume.py``; the async engine
  in bursts equals one call.
* Across packages, at rtol 1e-5 / atol 1e-6: the two trainers on
  ``colrel_fused`` and ``no_dropout`` with server momentum 0.9 over a ring
  with OPT-α A and p ≡ 1 (τ ≡ 1 whatever the RNG, since torch cannot draw
  threefry's numbers), 3 bursts of 4; and each package's
  ``SnapshotEvalLoop`` follows the other's published snapshots.
* The eval loop's loss is compared at 1e-6, not with ``==`` (the JAX
  package's ``==`` between a jitted and an eager loss is its known
  failure).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import channels as jax_channels
from repro import checkpoint as jax_checkpoint
from repro.core import topology as jax_topology
from repro.core.aggregation import ServerOpt as JaxServerOpt
from repro.fl.simulator import FLSimulator as JaxSimulator
from repro.launch import serve as jax_serve
from repro.launch import train as jax_train
from repro_torch import channels, checkpoint
from repro_torch.channels.delay import GeometricDelays
from repro_torch.core import opt_alpha, topology
from repro_torch.core.aggregation import ServerOpt
from repro_torch.fl.engine import run_rounds_loop
from repro_torch.fl.simulator import FLSimulator
from repro_torch.launch.serve import SnapshotEvalLoop
from repro_torch.launch.train import ContinuousTrainer, build_connectivity, build_topology
from repro_torch.utils import tree_flatten

N, DIM, T = 6, 4, 2
HALF = 9  # rounds per half of the resume test: several channel epochs
SYNC_ENGINES = ["loop", "scan", "pipelined", "pipelined_thread"]


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    # the suite runs several test processes side by side
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _loss_fn(params, batch):
    diff = params["x"][None, :] - batch["c"]
    return 0.5 * torch.mean(torch.sum(diff**2, dim=-1))


def _jax_loss_fn(params, batch):
    diff = params["x"][None, :] - batch["c"]
    return 0.5 * jnp.mean(jnp.sum(diff**2, axis=-1))


def _stream(seed=42):
    rng = np.random.default_rng(seed)

    def next_batch():
        return {"c": rng.standard_normal((N, T, 4, DIM)).astype(np.float32)}

    return next_batch


def _static(ch=channels, top=topology, p=0.8):
    return ch.StaticChannel(top.ring(N, 2), np.full(N, p, np.float32))


def _churn_schedule(seed=3):
    """``tests/test_resume.py``'s stream: Markov fading, rotating cohorts,
    a fixed p, epochs of 3 rounds."""
    link = channels.MarkovLinkProcess(topology.ring(N, 2), p_up_to_down=0.4,
                                      p_down_to_up=0.6, seed=seed)
    member = channels.RotatingCohorts(N, n_cohorts=3, hold=5)
    return channels.ChurnSchedule(membership=member, link_process=link,
                                  p=np.linspace(0.3, 0.9, N), adj_every=3, p_every=3)


def _sim(strategy="fedavg_blind", momentum=0.9):
    return FLSimulator(_loss_fn, n_clients=N, strategy=strategy, local_steps=T,
                       server_opt=ServerOpt(momentum=momentum), device="cpu")


def _params0():
    return {"x": torch.ones(DIM)}


def _gen(seed=1):
    return torch.Generator().manual_seed(seed)


def _trainer(sim, engine="loop", **kw):
    kw.setdefault("schedule", _static())
    kw.setdefault("next_batch", _stream())
    kw.setdefault("lr", 0.1)
    kw.setdefault("chunk", 4)
    t = ContinuousTrainer(sim, engine=engine.removesuffix("_thread"), **kw)
    if engine == "pipelined_thread":
        t._engine.prefetch = "thread"
    return t


def _tree_equal(a, b) -> bool:
    la = [] if a is None else tree_flatten(a)[0]
    lb = [] if b is None else tree_flatten(b)[0]
    return len(la) == len(lb) and all(torch.equal(torch.as_tensor(x), torch.as_tensor(y))
                                      for x, y in zip(la, lb))


def _metrics_equal(host: dict, ref: dict) -> bool:
    return sorted(host) == sorted(ref) and all(
        np.array_equal(host[k], ref[k].numpy()) for k in host)


@pytest.mark.parametrize("engine", SYNC_ENGINES)
def test_trainer_bursts_match_one_uninterrupted_run(engine, tmp_path):
    """15 rounds in publish-sized bursts of 5 ≡ one 15-round loop call,
    bitwise — and each burst published a snapshot."""
    sim = _sim()
    ref_p, ref_ss, ref_metrics, ref_gen = run_rounds_loop(
        sim, _gen(), _params0(), sim.init_server_state(_params0()),
        schedule=_static(), rounds=15, next_batch=_stream(), lr=0.1)

    d = str(tmp_path / "ckpts")
    published = []
    trainer = _trainer(_sim(), engine, ckpt_dir=d, publish_every=5, keep=0)
    trainer.init(_params0(), _gen())
    metrics = trainer.run(15, on_publish=lambda p, r: published.append((p, r)))

    assert trainer.round == 15
    assert _tree_equal(ref_p, trainer.params)
    assert _tree_equal(ref_ss, trainer.server_state)
    assert _metrics_equal(metrics, ref_metrics)
    assert torch.equal(ref_gen.get_state(), trainer.generator.get_state())
    assert [r for _, r in published] == [5, 10, 15]
    assert checkpoint.latest_checkpoint(d).endswith("ckpt_00000015.npz")
    meta = checkpoint.load_metadata(checkpoint.latest_checkpoint(d))
    assert meta["round"] == 15 and meta["engine"] == engine.removesuffix("_thread")
    # the published round-10 snapshot holds the state after round 10
    _, _, gen10, rnd = checkpoint.restore_training_state(
        os.path.join(d, "ckpt_00000010.npz"), params_like=_params0(),
        server_state_like=_sim().init_server_state(_params0()))
    assert rnd == 10


@pytest.mark.parametrize("engine", SYNC_ENGINES)
def test_trainer_restore_latest_resumes_bitwise(engine, tmp_path):
    """A crash after the round-9 snapshot; a trainer rebuilt from seeds
    restores it, replays the stream and runs on: bitwise the uninterrupted
    run's rounds 10–18, under churn, fading and adaptive OPT-α, with server
    momentum."""
    def trainer(**kw):
        return _trainer(_sim("colrel_fused"), engine, schedule=_churn_schedule(),
                        policy=channels.AdaptiveOptAlpha(sweeps=15, warm_sweeps=6), **kw)

    ref = trainer()
    ref.init(_params0(), _gen(7))
    ref_metrics = ref.run(2 * HALF)

    d = str(tmp_path / "ckpts")
    first = trainer(ckpt_dir=d, publish_every=HALF)
    first.init(_params0(), _gen(7))
    first.run(HALF)  # "crash" after the round-9 snapshot

    resumed = trainer(ckpt_dir=d, publish_every=HALF)
    resumed.init(_params0(), _gen(7))
    assert resumed.restore_latest()
    assert resumed.round == HALF
    resumed.advance_stream()  # fast-forward the fresh schedule/policy/batches
    got_metrics = resumed.run(HALF)

    assert resumed.round == 2 * HALF
    assert _tree_equal(ref.params, resumed.params)
    assert _tree_equal(ref.server_state, resumed.server_state)  # momentum included
    assert sorted(got_metrics) == sorted(ref_metrics)
    for k in ref_metrics:
        assert np.array_equal(got_metrics[k], ref_metrics[k][HALF:]), k
    assert torch.equal(ref.generator.get_state(), resumed.generator.get_state())
    # churn reached the run: some round had an inactive client
    assert (ref_metrics["tau"] == 0).any()


def test_trainer_restore_latest_edge_cases(tmp_path):
    t = _trainer(_sim())
    with pytest.raises(RuntimeError, match="init"):
        t.restore_latest()
    with pytest.raises(RuntimeError, match="init"):
        t.run(1)
    t.init(_params0(), _gen(0))
    assert not t.restore_latest()  # no ckpt_dir configured
    t2 = _trainer(_sim(), ckpt_dir=str(tmp_path / "empty"))
    t2.init(_params0(), _gen(0))
    assert not t2.restore_latest()  # dir has no snapshot
    with pytest.raises(ValueError, match="unknown engine"):
        _trainer(_sim(), engine="warp")


def test_trainer_async_engine_streams_across_bursts(tmp_path):
    """The async engine keeps its arrival buffer across bursts (reset only
    on the first) — bursting equals one uninterrupted run_schedule call."""
    one = _trainer(_sim(momentum=0.0), engine="async",
                   delays=GeometricDelays(N, mean=1.0, max_delay=4, seed=5),
                   staleness_decay=0.7)
    one.init(_params0(), _gen())
    m_one = one.run(12)

    burst = _trainer(_sim(momentum=0.0), engine="async",
                     delays=GeometricDelays(N, mean=1.0, max_delay=4, seed=5),
                     staleness_decay=0.7, ckpt_dir=str(tmp_path / "c"), publish_every=4)
    burst.init(_params0(), _gen())
    m_burst = burst.run(12)

    assert m_one["loss"].shape == (12,)
    assert _tree_equal(one.params, burst.params)
    assert sorted(m_one) == sorted(m_burst)
    assert all(np.array_equal(m_one[k], m_burst[k]) for k in m_one)
    assert torch.equal(one.generator.get_state(), burst.generator.get_state())
    assert checkpoint.latest_checkpoint(str(tmp_path / "c")) is not None


def test_trainer_async_restore_drops_the_arrival_buffer(tmp_path):
    """After a restore the async engine starts with an empty arrival buffer
    (in-flight updates are lost, as on a crash): a restore in the live
    process continues exactly as a restore in a fresh one."""
    d = str(tmp_path / "c")

    def trainer():
        return _trainer(_sim(momentum=0.0), engine="async",
                        delays=GeometricDelays(N, mean=2.0, max_delay=4, seed=5),
                        ckpt_dir=d, publish_every=4)

    live = trainer()
    live.init(_params0(), _gen())
    live.run(4)
    assert live._engine._pending  # updates in flight at the snapshot
    assert live.restore_latest() and live.round == 4
    fresh = trainer()
    fresh.init(_params0(), _gen())
    assert fresh.restore_latest() and fresh.round == 4
    m_live = live.run(4)
    fresh.advance_stream()
    m_fresh = fresh.run(4)

    assert _tree_equal(live.params, fresh.params)
    assert all(np.array_equal(m_live[k], m_fresh[k]) for k in m_live)
    assert torch.equal(live.generator.get_state(), fresh.generator.get_state())


def test_trainer_stop_callback_halts_between_bursts():
    t = _trainer(_sim(), publish_every=3)
    t.init(_params0(), _gen(0))
    calls = []

    def stop():
        calls.append(len(calls))
        return len(calls) >= 2  # allow two bursts, then halt

    metrics = t.run(30, stop=stop)
    assert t.round == 6
    assert metrics["loss"].shape == (6,)


@pytest.mark.parametrize("engine", ["scan", "pipelined"])
def test_trainer_scan_engines_run_and_publish(engine, tmp_path):
    d = str(tmp_path / "ckpts")
    t = _trainer(_sim(), engine=engine, ckpt_dir=d)
    t.init(_params0(), _gen())
    metrics = t.run(8)  # publish_every=0 → one final snapshot
    assert metrics["loss"].shape == (8,)
    latest = checkpoint.latest_checkpoint(d)
    assert latest is not None and latest.endswith("ckpt_00000008.npz")
    assert checkpoint.load_metadata(latest)["engine"] == engine


def test_trainer_run_zero_rounds_returns_empty():
    t = _trainer(_sim())
    t.init(_params0(), _gen(0))
    assert t.run(0) == {}


def test_snapshot_eval_loop_follows_published_snapshots(tmp_path):
    """The live-eval side: every new snapshot is reloaded and scored, an
    unchanged pointer is a no-op, and the watch() history tracks the
    published rounds in order."""
    d = str(tmp_path / "ckpts")
    trainer = _trainer(_sim(), ckpt_dir=d, publish_every=4)
    trainer.init(_params0(), _gen())

    eval_batch = {"c": np.zeros((N, T, 4, DIM), np.float32)}
    loop = SnapshotEvalLoop(d, params_like=_params0(), eval_fn=_loss_fn)

    with pytest.raises(RuntimeError, match="poll"):
        loop.eval_batch(eval_batch)
    assert not loop.poll()  # nothing published yet

    trainer.run(4)
    assert loop.poll() and loop.round == 4
    assert not loop.poll()  # pointer unchanged → no reload
    assert _tree_equal(loop.params, trainer.params)
    direct = float(_loss_fn(trainer.params, {"c": torch.from_numpy(eval_batch["c"])}))
    assert loop.eval_batch(eval_batch) == pytest.approx(direct, abs=1e-6)

    # watch(): train between polls via the injectable sleep
    def sleep(_interval):
        trainer.run(4)

    history = loop.watch(eval_batch, max_polls=3, interval=0.0, sleep=sleep)
    assert [rnd for rnd, _ in history] == [8, 12]
    assert all(np.isfinite(loss) for _, loss in history)
    # training reduces the quadratic eval loss round over round
    assert history[-1][1] < direct


def test_snapshot_eval_loop_requires_eval_fn(tmp_path):
    d = str(tmp_path / "ckpts")
    checkpoint.publish(d, params=_params0(), server_state=None, generator=_gen(0), round=1)
    loop = SnapshotEvalLoop(d, params_like=_params0())
    assert loop.poll()
    with pytest.raises(RuntimeError, match="eval_fn"):
        loop.eval_batch({"c": np.zeros((N, T, 4, DIM), np.float32)})


@pytest.mark.parametrize("name, n, k", [("ring", 8, 2), ("fct", 5, 1), ("disconnected", 4, 1),
                                        ("clusters", 8, 1), ("ring", 10, 1)])
def test_build_topology_equals_jax(name, n, k):
    got = build_topology(name, n, k)
    want = jax_train.build_topology(name, n, k)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("profile, n, p", [("homogeneous", 6, 0.3), ("paper", 10, 0.2),
                                           ("paper", 7, 0.2), ("heterogeneous", 7, 0.2),
                                           ("heterogeneous", 13, 0.2)])
def test_build_connectivity_equals_jax(profile, n, p):
    got = build_connectivity(profile, n, p).p
    want = np.asarray(jax_train.build_connectivity(profile, n, p).p)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_build_helpers_reject_unknown_topology():
    with pytest.raises(ValueError):
        build_topology("moebius", 4, 1)


# --------------------------------------------------------------------------
# Across packages
# --------------------------------------------------------------------------

BURST, BURSTS = 4, 3


def _ring_opt_alpha():
    # host numpy, equal in both packages (tests/test_torch_opt_alpha.py)
    return opt_alpha.optimize(np.linspace(0.3, 0.9, N).astype(np.float32),
                              topology.ring(N, 1), sweeps=20).A


def _pair(strategy, tmp_path, publish_every=BURST):
    """The JAX and the port trainer on the same A, stream and initial
    params, p ≡ 1 (τ ≡ 1), server momentum 0.9, publishing every burst."""
    A = _ring_opt_alpha()
    jsim = JaxSimulator(_jax_loss_fn, n_clients=N, strategy=strategy, A=A, local_steps=T,
                        server_opt=JaxServerOpt(momentum=0.9))
    tsim = FLSimulator(_loss_fn, n_clients=N, strategy=strategy, A=A, local_steps=T,
                       server_opt=ServerOpt(momentum=0.9), device="cpu")
    jt = jax_train.ContinuousTrainer(
        jsim, schedule=_static(jax_channels, jax_topology, p=1.0), next_batch=_stream(),
        lr=0.1, ckpt_dir=str(tmp_path / "jax"), publish_every=publish_every, keep=0)
    tt = ContinuousTrainer(
        tsim, schedule=_static(p=1.0), next_batch=_stream(), lr=0.1,
        ckpt_dir=str(tmp_path / "port"), publish_every=publish_every, keep=0)
    x0 = np.linspace(-1.0, 1.0, DIM).astype(np.float32)
    jt.init({"x": jnp.asarray(x0)}, jax.random.key(1))
    tt.init({"x": torch.from_numpy(x0.copy())}, _gen())
    return jt, tt


@pytest.mark.parametrize("strategy", ["colrel_fused", "no_dropout"])
def test_trainers_agree_across_packages(strategy, tmp_path):
    jt, tt = _pair(strategy, tmp_path)
    jm, tm = jt.run(BURST * BURSTS), tt.run(BURST * BURSTS)
    assert tm["loss"].shape == (BURST * BURSTS,)
    np.testing.assert_array_equal(tm["tau"], np.ones((BURST * BURSTS, N), np.float32))
    np.testing.assert_allclose(tm["loss"], np.asarray(jm["loss"]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tt.params["x"].numpy(), np.asarray(jt.params["x"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tt.server_state["x"].numpy(),
                               np.asarray(jt.server_state["x"]), rtol=1e-5, atol=1e-6)
    assert tt.round == jt.round == BURST * BURSTS
    names = [f"ckpt_{r:08d}.npz" for r in (4, 8, 12)]
    for sub in ("jax", "port"):
        assert sorted(f for f in os.listdir(tmp_path / sub) if f.endswith(".npz")) == names


@pytest.mark.parametrize("follower", ["jax", "port"])
def test_snapshot_eval_loop_follows_the_other_package(follower, tmp_path):
    """The JAX loop follows the port trainer's directory and the port loop
    the JAX trainer's: the same rounds, in order, with the loss the
    trainer's own package computes on its params (within 1e-6)."""
    jt, tt = _pair("colrel_fused", tmp_path)
    eval_c = np.random.default_rng(3).standard_normal((N, T, 4, DIM)).astype(np.float32)
    if follower == "jax":
        trainer, d = tt, str(tmp_path / "port")
        loop = jax_serve.SnapshotEvalLoop(d, params_like={"x": jnp.zeros(DIM)},
                                          eval_fn=jax.jit(_jax_loss_fn))

        def direct():
            return float(_loss_fn(tt.params, {"c": torch.from_numpy(eval_c)}))
    else:
        trainer, d = jt, str(tmp_path / "jax")
        loop = SnapshotEvalLoop(d, params_like={"x": torch.zeros(DIM)}, eval_fn=_loss_fn)

        def direct():
            return float(_jax_loss_fn(jt.params, {"c": jnp.asarray(eval_c)}))

    assert not loop.poll()
    wants = []

    def sleep(_interval):
        trainer.run(BURST)
        wants.append((trainer.round, direct()))

    history = loop.watch({"c": eval_c}, max_polls=BURSTS + 1, interval=0.0, sleep=sleep)
    assert [r for r, _ in history] == [r for r, _ in wants] == [4, 8, 12]
    for (_, got), (_, want) in zip(history, wants):
        assert abs(got - want) <= 1e-6
    # the params the follower loaded are the trainer's, bit for bit
    np.testing.assert_array_equal(np.asarray(loop.params["x"]),
                                  np.asarray(trainer.params["x"]))
    assert jax_checkpoint.latest_checkpoint(d) == checkpoint.latest_checkpoint(d)
