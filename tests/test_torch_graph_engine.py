"""The engines' capture bookkeeping (``repro_torch.fl.engine``, step 9a),
with the CUDA graph capture stubbed so it runs on the CPU: a stub "graph"
clones the first call's inputs into static buffers and replays by running
the chunk on them.  Only full-length chunks are captured, one graph per
(chunk length, churn mask present or not), so ``trace_count`` ≤ 2 over
the reference's varying-epoch schedules (``tests/test_scan_engine.py:210``,
``tests/test_pipelined_engine.py:365``); remainder chunks, the ``segment``
backend and ``capture=False`` run eagerly and are counted in
``eager_chunks``; the trajectory, run with a 0-d learning-rate tensor in
the "graph", stays bitwise the loop's.  Without the stub, nothing is
captured on the CPU."""
import numpy as np
import pytest
import torch

from repro_torch import channels
from repro_torch.core import topology
from repro_torch.core.aggregation import ServerOpt
from repro_torch.fl import engine as engine_mod
from repro_torch.fl.engine import (
    EpochScanEngine,
    PipelinedScanEngine,
    ShardedScanEngine,
    run_rounds_loop,
)
from repro_torch.fl.simulator import FLSimulator
from repro_torch.kernels import relay_mix
from repro_torch.utils import tree_flatten, tree_map

N, T, B, DIM, ROUNDS, CHUNK, LR = 6, 2, 4, 4, 29, 2, 0.1


class _StubGraph:
    """The capture stubbed: static input buffers, and a replay that runs the
    chunk on them (the lr among them a 0-d tensor, as in a real graph)."""

    def __init__(self, fn, inputs, *, generator=None):
        self.fn = fn
        self.static = tree_map(torch.clone, inputs)
        assert isinstance(inputs[-1], torch.Tensor) and inputs[-1].dim() == 0  # lr

    def __call__(self, generator, *inputs):
        tree_map(lambda dst, src: dst.copy_(src), self.static, inputs)
        return tree_map(torch.clone, self.fn(generator, *self.static))


@pytest.fixture
def stub_capture(monkeypatch):
    monkeypatch.setattr(engine_mod, "_ChunkGraph", _StubGraph)
    monkeypatch.setattr(engine_mod, "_captures",
                        lambda capture, device, backend=None: capture and backend != "segment")


def _schedule(seed=9):
    link = channels.MarkovLinkProcess(topology.ring(N, 2), p_up_to_down=0.4,
                                      p_down_to_up=0.6, seed=seed)
    drift = channels.PiecewiseConstantDrift(np.linspace(0.2, 0.9, N), hold=1, low=0.1,
                                            high=0.9, seed=seed + 1)
    member = channels.RotatingCohorts(N, n_cohorts=3, hold=5)
    return channels.ChurnSchedule(membership=member, link_process=link, p_process=drift,
                                  adj_every=3, p_every=4)


def _loss(params, batch):
    diff = params["x"][None, :] - batch["c"]
    return 0.5 * torch.mean(torch.sum(diff**2, dim=-1))


def _run(engine, *, capture=True, strategy="colrel_fused", client_opt="sgd"):
    from repro_torch.optim.sgd import ClientOpt

    rng = np.random.default_rng(42)
    sim = FLSimulator(_loss, n_clients=N, strategy=strategy, local_steps=T,
                      client_opt=ClientOpt(kind=client_opt),
                      server_opt=ServerOpt(momentum=0.5), device="cpu")
    params = {"x": torch.ones(DIM)}
    kw = dict(schedule=_schedule(), rounds=ROUNDS, lr=LR,
              policy=channels.AdaptiveOptAlpha(sweeps=10),
              next_batch=lambda: {"c": rng.standard_normal((N, T, B, DIM)).astype(np.float32)})
    gen = torch.Generator().manual_seed(7)
    state = sim.init_server_state(params)
    if engine == "loop":
        return run_rounds_loop(sim, gen, params, state, **kw), None
    if engine == "scan":
        eng = EpochScanEngine(sim, chunk=CHUNK, capture=capture)
    else:
        eng = PipelinedScanEngine(sim, chunk=CHUNK, prefetch=engine.split("_")[1],
                                  capture=capture)
    return eng.run_schedule(gen, params, state, **kw), eng


def _chunks():
    lengths = [s.n_rounds for s in _schedule().segments(ROUNDS)]
    full = sum(n // CHUNK for n in lengths)
    return lengths, full, sum(-(-n // CHUNK) for n in lengths)


def _same(a, b) -> bool:
    la = [] if a is None else tree_flatten(a)[0]
    lb = [] if b is None else tree_flatten(b)[0]
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


@pytest.mark.parametrize("client_opt", ["sgd", "adam"])
@pytest.mark.parametrize("engine", ["scan", "pipelined_inline", "pipelined_thread"])
def test_full_chunks_captured_and_trace_count_bounded(stub_capture, engine, client_opt):
    lengths, full, total = _chunks()
    assert len(lengths) > 4 and full and total > full  # epochs vary; remainders exist
    (lp, ls, lm, lg), _ = _run("loop", client_opt=client_opt)
    (ep, es, em, eg), eng = _run(engine, client_opt=client_opt)
    assert 1 <= eng.trace_count <= 2
    assert eng.trace_count == len({(CHUNK, s.active is None)
                                   for s in _schedule().segments(ROUNDS) if s.n_rounds >= CHUNK})
    assert (eng.replays, eng.eager_chunks) == (full, total - full)
    if engine != "scan":
        assert eng.dispatches == total
    assert _same(ep, lp) and _same(es, ls) and _same(em, lm)
    assert torch.equal(eg.get_state(), lg.get_state())


@pytest.mark.parametrize("engine", ["scan", "pipelined_inline"])
def test_captures_cached_across_runs_and_uncaptured_runs_eager(stub_capture, engine):
    _, full, total = _chunks()
    (p1, *_), eng = _run(engine)
    count = eng.trace_count
    (p0, *_), off = _run(engine, capture=False)
    assert (off.trace_count, off.replays, off.eager_chunks) == (0, 0, total)
    assert _same(p0, p1)
    # a second run on the same engine replays the cached graphs
    sim = eng.sim
    rng = np.random.default_rng(42)
    params = {"x": torch.ones(DIM)}
    eng.run_schedule(torch.Generator().manual_seed(7), params, sim.init_server_state(params),
                     schedule=_schedule(), rounds=ROUNDS, lr=LR,
                     policy=channels.AdaptiveOptAlpha(sweeps=10),
                     next_batch=lambda: {"c": rng.standard_normal((N, T, B, DIM))
                                         .astype(np.float32)})
    assert eng.trace_count == count and (eng.replays, eng.eager_chunks) == (full, total - full)


@pytest.mark.parametrize("engine", ["scan", "pipelined_inline"])
def test_nothing_captured_on_the_cpu(engine):
    _, _, total = _chunks()
    _, eng = _run(engine)
    assert (eng.trace_count, eng.replays, eng.eager_chunks) == (0, 0, total)


def test_segment_backend_runs_eagerly(stub_capture):
    """The segment backend's EdgeRelay changes its edge count per epoch:
    its chunks run eagerly even with capture on."""
    n, rounds = 16, 12
    graph = topology.random_geometric(n, 0.5, seed=1)
    sim = FLSimulator(_loss, n_clients=n, strategy="colrel_fused", local_steps=1,
                      relay_backend="segment", device="cpu")
    link = channels.MarkovLinkProcess(graph, p_up_to_down=0.3, p_down_to_up=0.5, seed=2)
    schedule = channels.ChurnSchedule(
        membership=channels.RotatingCohorts(n, n_cohorts=2, hold=4), link_process=link,
        p=np.full(n, 0.6), adj_every=4)
    rng = np.random.default_rng(0)
    eng = PipelinedScanEngine(sim, chunk=CHUNK)
    params = {"x": torch.ones(DIM)}
    eng.run_schedule(torch.Generator().manual_seed(0), params, None, schedule=schedule,
                     rounds=rounds, lr=LR, policy=channels.SparseOptAlpha(sweeps=5),
                     next_batch=lambda: {"c": rng.standard_normal((n, 1, 2, DIM))
                                         .astype(np.float32)})
    assert eng.trace_count == 0 and eng.replays == 0 and eng.eager_chunks == eng.dispatches > 0


def _sharded_run(capture):
    from repro_torch.fl.distributed import build_sharded_scan_round_step
    from repro_torch.launch.mesh import make_client_mesh

    mesh = make_client_mesh()
    step = build_sharded_scan_round_step(_loss, n_clients=N, local_steps=T, mesh=mesh)
    eng = ShardedScanEngine(step, mesh=mesh, prefetch="inline", device="cpu", capture=capture)
    rng = np.random.default_rng(42)
    params = {"x": torch.ones(DIM)}
    out = eng.run_schedule(torch.Generator().manual_seed(7), params, None, schedule=_schedule(),
                           rounds=ROUNDS, lr=LR, policy=channels.AdaptiveOptAlpha(sweeps=10),
                           next_batch=lambda: {"c": rng.standard_normal((N, T, B, DIM))
                                               .astype(np.float32)})
    return out, eng


def test_sharded_engine_captures_one_epoch_per_length(stub_capture):
    segs = list(_schedule().segments(ROUNDS))
    (p1, _, m1, g1), eng = _sharded_run(True)
    (p0, _, m0, g0), off = _sharded_run(False)
    assert eng.trace_count == len({(s.n_rounds, s.active is None) for s in segs})
    assert (eng.replays, eng.eager_chunks, eng.dispatches) == (len(segs), 0, len(segs))
    assert (off.trace_count, off.eager_chunks) == (0, len(segs))
    assert _same(p1, p0) and torch.equal(m1["loss"], m0["loss"])
    assert torch.equal(g1.get_state(), g0.get_state())


def test_sharded_engine_on_the_cpu_captures_nothing():
    segs = list(_schedule().segments(ROUNDS))
    _, eng = _sharded_run(True)
    assert (eng.trace_count, eng.replays) == (0, 0)
    assert eng.eager_chunks == eng.dispatches == len(segs)


def test_replayed_launches_are_counted():
    relay_mix.reset_launches()
    relay_mix.count_launches({"relay_mix_2d": 4, "fused_aggregate_2d": 0})
    relay_mix.count_launches({"relay_mix_2d": 4, "fused_aggregate_2d": 0})
    assert relay_mix.LAUNCHES == {"relay_mix_2d": 8, "fused_aggregate_2d": 0}
    relay_mix.reset_launches()
