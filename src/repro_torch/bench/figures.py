"""The paper's Figs. 2–4 and the beyond-paper channel figures on the port.

The counterpart of the JAX package's ``benchmarks/common.py``, of the
settings in ``benchmarks/fig2_homogeneous.py``, ``fig3_ring.py`` and
``fig4_noniid.py``, of the three channel studies ``fig5_timevarying.py``,
``fig6_churn.py`` and ``fig_correlated.py``, and of ``benchmarks/run.py``'s
figure loop.  Each figure trains the same model under several aggregation
strategies over identical data and τ randomness and reports final losses
and accuracies.  Models: ``resnet20`` (the paper's, ResNet-20 with
GroupNorm) or ``mlp`` (CIFAR-shaped data flattened; fast, the same
protocol behaviour).  The channel figures are MLP-only, as in the
reference: each runs three relay policies (blind FedAvg, the round-0 A kept
stale, OPT-α re-solved per channel epoch) over a time-varying channel
(Fig. 5), the same with client churn (Fig. 6) or correlated shadowing at
four correlation lengths ℓ (``fig_corr``), through the per-round loop or
the scan or pipelined engine.

    PYTHONPATH=src python -m repro_torch.bench.figures --figure fig4 \\
        --model mlp --rounds 30 [--device cpu] [--relay-backend hopper_fused] \\
        [--seed S]
    PYTHONPATH=src python -m repro_torch.bench.figures --figure fig5 \\
        --engine pipelined --rounds 30 [--device cpu]   # or fig6, fig_corr, all

The host data (``cifar_like``, the partitions, ``FederatedLoader``) is the
reference's numpy, so the same seed gives the same batches.  Torch cannot
draw the reference's threefry numbers: ``run_figure(init_params=, taus=)``
takes its initial parameters and τ as arrays (the cross-package tests hand
them over); without them the port draws its own, the parameters from
``seed`` and τ from a generator on the device seeded ``seed + 1``, the same
stream for every strategy.  The channel figures take the same two through
``run_channel_figure``; there τ follows the round's drifting p, so the
hand-over goes to the per-round loop only (the engines are held bitwise to
the port's own loop instead).  Runs on the GPU unless ``device="cpu"``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import time

import numpy as np
import torch

from repro_torch import channels
from repro_torch.configs.resnet20_cifar import CONFIG as RESNET20_CONFIG
from repro_torch.core import connectivity, opt_alpha, topology
from repro_torch.core.aggregation import ServerOpt
from repro_torch.data.loader import FederatedLoader
from repro_torch.data.partition import iid_partition, sort_and_partition
from repro_torch.data.synthetic import cifar_like
from repro_torch.fl.engine import EpochScanEngine, PipelinedScanEngine, run_rounds_loop
from repro_torch.fl.simulator import FLSimulator
from repro_torch.kernels.ops import RELAY_BACKENDS
from repro_torch.models.resnet import init_resnet20, resnet20_logits, resnet20_loss
from repro_torch.optim.sgd import ClientOpt
from repro_torch.utils import from_jax_params, resolve_device

# the paper's figures, each a figure_setting of run_figure
FIGURES = ("fig2", "fig3", "fig4")
# the beyond-paper channel studies, each run through run_channel_figure
CHANNEL_FIGURES = ("fig5", "fig6", "fig_corr")
# every figure of the reference's benchmarks/run.py, in the order it runs them
ALL_FIGURES = FIGURES + CHANNEL_FIGURES
ENGINES = ("loop", "scan", "pipelined")
# fig_corr's correlation lengths: independent → bursts → fully blocked
CORR_SWEEP = (0.0, 0.2, 0.5, np.inf)
# the channel's coherence time in rounds (Figs. 5 and 6 redraw the links
# every 2 rounds; fig_corr holds its field 2 rounds): the engines' chunk
HOLD = 2


@dataclasses.dataclass
class FigureResult:
    strategy: str
    losses: list
    accs: list
    seconds: float
    # host ms of each round, to the read of its loss (an engine's: its
    # epoch's mean, to the device's end); evaluations excluded
    round_ms: list = dataclasses.field(default_factory=list)
    params: object = None  # the parameters after the last round
    # a channel figure's scan or pipelined run: the engine's trace_count,
    # replays and eager_chunks (and a pipelined engine's dispatches and
    # prefetch_stats) after it
    engine_counts: dict | None = None
    policy: object = None  # a channel figure's relay policy


def make_mlp(dim=3072, width=256, n_classes=10, *, device=None):
    """The reference's 3,072 → 256 → 10 MLP: ``init(seed)`` draws on the CPU
    and moves the leaves to ``device``; the dict's sorted keys give the
    ``jax.tree.flatten`` order, so the (n, D) buffers line up column for
    column."""

    def init(seed: int):
        gen = torch.Generator().manual_seed(seed)
        params = {
            "w1": torch.randn((dim, width), generator=gen) * dim**-0.5,
            "b1": torch.zeros((width,)),
            "w2": torch.randn((width, n_classes), generator=gen) * width**-0.5,
            "b2": torch.zeros((n_classes,)),
        }
        return {k: v.to(device) for k, v in params.items()}

    def logits(params, images):
        x = images.reshape(images.shape[0], -1)
        h = torch.relu(x @ params["w1"] + params["b1"])
        return h @ params["w2"] + params["b2"]

    def loss(params, batch):
        lg = logits(params, batch["images"]).float()
        logz = torch.logsumexp(lg, dim=-1)
        gold = torch.gather(lg, 1, batch["labels"].long()[:, None])[:, 0]
        return torch.mean(logz - gold)

    return init, logits, loss


def _make_model(model: str, device):
    if model == "resnet20":
        def init(seed):
            return init_resnet20(seed, RESNET20_CONFIG, device=device)

        def logits_fn(params, images):
            return resnet20_logits(params, RESNET20_CONFIG, images)

        def loss(params, batch):
            return resnet20_loss(params, RESNET20_CONFIG, batch)

        return init, logits_fn, loss
    if model == "mlp":
        return make_mlp(device=device)
    raise ValueError(f"unknown model {model!r} (known: mlp, resnet20)")


def _figure_data(model: str, n: int, n_train: int, seed: int, dev, non_iid: bool = False):
    """A figure's training set, its n client partitions, the model's
    ``init`` and ``loss``, and ``accuracy(params)`` on the 1,000 held-out
    images, as the reference's figure scripts build them."""
    ds = cifar_like(n_train, snr=0.5, seed=seed)
    test = cifar_like(1000, snr=0.5, seed=seed + 99)
    parts = (sort_and_partition(ds, n, shards_per_client=1, seed=seed)
             if non_iid else iid_partition(ds, n, seed=seed))
    init, logits_fn, loss = _make_model(model, dev)
    test_x = torch.as_tensor(test.inputs, device=dev)
    test_y = torch.as_tensor(test.labels, device=dev).long()

    @torch.no_grad()
    def accuracy(params):
        return float((logits_fn(params, test_x).argmax(-1) == test_y).float().mean())

    return ds, parts, init, loss, accuracy


def _checked_taus(taus, rounds: int, n: int):
    if taus is None:
        return None
    taus = np.asarray(taus, np.float32)
    if taus.shape != (rounds, n):
        raise ValueError(f"taus shape {taus.shape} != (rounds, n) = {(rounds, n)}")
    return taus


@contextlib.contextmanager
def _repeatable_f32(dev: torch.device):
    """On the GPU, for the block: TF32 off for matmuls and cuDNN
    convolutions (full f32, the reference's HIGHEST) and deterministic
    cuDNN (one seed, one result); the caller's settings after."""
    if dev.type != "cuda":
        yield
        return
    b = torch.backends
    flags = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32, b.cudnn.deterministic,
             b.cudnn.benchmark)
    b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32 = False, False
    b.cudnn.deterministic, b.cudnn.benchmark = True, False
    try:
        yield
    finally:
        (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32, b.cudnn.deterministic,
         b.cudnn.benchmark) = flags


def run_figure(
    *,
    p: np.ndarray,
    adj: np.ndarray,
    strategies: dict,
    non_iid: bool = False,
    server_momentum: float = 0.0,
    model: str = "mlp",
    rounds: int = 30,
    local_steps: int = 8,
    local_batch: int = 64,
    lr: float = 0.1,
    n_train: int = 4000,
    seed: int = 0,
    eval_every: int = 2,
    device=None,
    relay_backend: str = "einsum",
    init_params=None,
    taus=None,
) -> dict[str, FigureResult]:
    """Train under each of ``strategies`` (name → (strategy, A)) on the same
    data, batches and τ stream; the reference's ``run_figure``.

    ``init_params``: a pytree of arrays (the reference's ``init(key(seed))``
    through ``np.asarray``) used instead of the port's draw.  ``taus``: a
    (rounds, n) array of uplink masks used instead of the port's draws (the
    reference's ``sample_tau`` stream), for every strategy.
    """
    dev = resolve_device(device)
    with _repeatable_f32(dev):
        n = len(p)
        ds, parts, init, loss, accuracy = _figure_data(model, n, n_train, seed, dev, non_iid)
        taus = _checked_taus(taus, rounds, n)
        results = {}
        for name, (strategy, A) in strategies.items():
            loader = FederatedLoader(ds, parts, seed=seed)  # same data order per strategy
            sim = FLSimulator(
                loss, n_clients=n, strategy=strategy, A=A, p=p,
                local_steps=local_steps,
                client_opt=ClientOpt(kind="sgd", weight_decay=1e-4),
                server_opt=ServerOpt(momentum=server_momentum),
                relay_backend=relay_backend, device=dev,
            )
            params = init(seed) if init_params is None else from_jax_params(init_params, device=dev)
            ss = sim.init_server_state(params)
            gen = torch.Generator(device=dev).manual_seed(seed + 1)  # same τ stream per strategy
            losses, accs, round_ms = [], [], []
            t0 = time.time()
            for r in range(rounds):
                t_round = time.perf_counter()
                batch = loader.round_batch(local_steps, local_batch)
                tau = None if taus is None else taus[r]
                params, ss, m = sim.run_round(gen, params, ss, batch, lr, tau=tau)
                losses.append(float(m["loss"]))
                round_ms.append((time.perf_counter() - t_round) * 1e3)
                if r % eval_every == 0 or r == rounds - 1:
                    accs.append((r, accuracy(params)))
            results[name] = FigureResult(name, losses, accs, time.time() - t0, round_ms, params)
        return results


def rounds_to(res: FigureResult, threshold: float):
    for r, a in res.accs:
        if a >= threshold:
            return r
    return None


def print_figure_csv(figure: str, results: dict[str, FigureResult]):
    """The paper's Figs. 2-4 are accuracy-vs-round curves; the derived column
    carries the curve summary (early accuracy, rounds-to-90%, final loss —
    convergence *rate* is the claim under test)."""
    for name, res in results.items():
        final_acc = res.accs[-1][1]
        early = res.accs[1][1] if len(res.accs) > 1 else res.accs[0][1]
        r90 = rounds_to(res, 0.90)
        us = 1e6 * res.seconds / max(1, len(res.losses))
        print(f"{figure}/{name},{us:.0f},acc_early={early:.3f};"
              f"rounds_to_90pct={r90};final_acc={final_acc:.3f};"
              f"final_loss={res.losses[-1]:.4f}")


def figure_setting(figure: str, *, n: int = 10, p_val: float = 0.2) -> dict:
    """The channel, topology, strategies and data options of one of the
    paper's figures, as the reference's scripts set them: ``run_figure``'s
    keyword arguments.  ``n`` and ``p_val`` apply to fig2 only.

    fig2: homogeneous p_i = 0.2 on a fully connected graph.  Claims: ColRel ≈
    no-dropout, both ahead of FedAvg-dropout (blind and non-blind); Alg. 3's
    initial weights are already optimal here.
    fig3: the paper's heterogeneous p on ring(10, 1), optimized against
    unoptimized relay weights (with heterogeneous connectivity, Alg. 3
    matters).
    fig4: non-IID sort-and-partition data and global momentum 0.9 at the PS
    on ring(10, 2) (4 nearest neighbours).  Claim: FedAvg-dropout collapses
    (low-connectivity clients own whole classes that never reach the PS),
    while ColRel stays close to no-dropout.
    """
    baselines = {
        "no_dropout": ("no_dropout", None),
        "fedavg_dropout_blind": ("fedavg_blind", None),
        "fedavg_dropout_nonblind": ("fedavg_nonblind", None),
    }
    if figure == "fig2":
        p = np.full(n, p_val)
        adj = topology.fully_connected(n)
        res = opt_alpha.optimize(p, adj, sweeps=40)
        return dict(p=p, adj=adj, strategies={**baselines, "colrel": ("colrel_fused", res.A)})
    if figure == "fig3":
        p = connectivity.paper_heterogeneous().p
        adj = topology.ring(10, k=1)
        opt = opt_alpha.optimize(p, adj, sweeps=60)
        A0 = opt_alpha.initial_weights(p, adj)
        return dict(p=p, adj=adj, strategies={
            **baselines,
            "colrel_unoptimized": ("colrel_fused", A0),
            "colrel_optimized": ("colrel_fused", opt.A),
        })
    if figure == "fig4":
        p = connectivity.paper_heterogeneous().p
        adj = topology.ring(10, k=2)  # 4 nearest neighbors (paper Fig. 4)
        opt = opt_alpha.optimize(p, adj, sweeps=60)
        return dict(p=p, adj=adj, strategies={**baselines,
                                             "colrel_optimized": ("colrel_fused", opt.A)},
                    non_iid=True, server_momentum=0.9)
    raise ValueError(f"unknown figure {figure!r} (known: {FIGURES})")


def fig2(rounds: int = 30, model: str = "mlp", n: int = 10, p_val: float = 0.2, **kw):
    """Paper Fig. 2 (``benchmarks/fig2_homogeneous.py``); ``kw`` goes to
    :func:`run_figure`."""
    results = run_figure(**figure_setting("fig2", n=n, p_val=p_val), rounds=rounds,
                         model=model, **kw)
    print_figure_csv("fig2", results)
    return results


def fig3_variance_line(setting: dict) -> str:
    """Fig. 3's S(p, A) at Alg. 3's initial and at the optimized A, as the
    reference's script prints it."""
    p, strategies = setting["p"], setting["strategies"]
    s0 = opt_alpha.variance_proxy(p, strategies["colrel_unoptimized"][1])
    s1 = opt_alpha.variance_proxy(p, strategies["colrel_optimized"][1])
    return f"# fig3 S(p,A): init={s0:.3f} optimized={s1:.3f}"


def fig3(rounds: int = 30, model: str = "mlp", **kw):
    """Paper Fig. 3 (``benchmarks/fig3_ring.py``), with its S(p, A) line."""
    setting = figure_setting("fig3")
    print(fig3_variance_line(setting))
    results = run_figure(**setting, rounds=rounds, model=model, **kw)
    print_figure_csv("fig3", results)
    return results


def fig4(rounds: int = 30, model: str = "mlp", **kw):
    """Paper Fig. 4 (``benchmarks/fig4_noniid.py``)."""
    results = run_figure(**figure_setting("fig4"), rounds=rounds, model=model, **kw)
    print_figure_csv("fig4", results)
    return results


def channel_policies() -> dict:
    """The channel figures' three policies: name → (strategy, a factory of
    a fresh relay policy, or None for none), as the reference builds them.
    Each run needs its own policy: they keep state (an LRU cache of solves,
    the round-0 A)."""
    return {
        "fedavg_dropout_blind": ("fedavg_blind", None),
        "colrel_stale": ("colrel_fused", lambda: channels.StaleOptAlpha(sweeps=40)),
        "colrel_adaptive": ("colrel_fused",
                            lambda: channels.AdaptiveOptAlpha(sweeps=40, warm_sweeps=12)),
    }


def fig5_schedule(n: int, *, seed: int = 0) -> channels.TimeVaryingChannel:
    """Fig. 5's channel (``benchmarks/fig5_timevarying.py``): ring(n, 2)
    with bursty Markov fading redrawn every 2 rounds, and p re-estimated
    (piecewise-constant) every 5 rounds."""
    link = channels.MarkovLinkProcess(
        topology.ring(n, 2), p_up_to_down=0.3, p_down_to_up=0.5, seed=seed)
    p_drift = channels.PiecewiseConstantDrift(
        connectivity.heterogeneous_profile(n).p, hold=5, low=0.1, high=0.9, seed=seed + 1)
    return channels.TimeVaryingChannel(link_process=link, p_process=p_drift, adj_every=HOLD)


def fig6_schedule(n: int, *, seed: int = 0) -> channels.ChurnSchedule:
    """Fig. 6's channel (``benchmarks/fig6_churn.py``): Fig. 5's, with one
    of 5 client cohorts offline per 4-round shift."""
    link = channels.MarkovLinkProcess(
        topology.ring(n, 2), p_up_to_down=0.3, p_down_to_up=0.5, seed=seed)
    p_drift = channels.PiecewiseConstantDrift(
        connectivity.heterogeneous_profile(n).p, hold=5, low=0.1, high=0.9, seed=seed + 1)
    member = channels.RotatingCohorts(n, n_cohorts=5, hold=4)
    return channels.ChurnSchedule(
        membership=member, link_process=link, p_process=p_drift, adj_every=HOLD)


def corr_schedule(n: int, ell: float, *, seed: int = 0) -> channels.CorrelatedChannel:
    """``fig_corr``'s channel at correlation length ``ell``
    (``benchmarks/fig_correlated.py``): ring(n, 2) on circle positions,
    node blockage and the coupled uplink redrawn together every HOLD
    rounds."""
    return channels.CorrelatedChannel(
        topology.ring(n, 2), connectivity.heterogeneous_profile(n).p, corr_length=ell,
        rho=0.9, blockage_threshold=1.0, couple_uplink=True, uplink_gain=2.0, hold=HOLD,
        seed=seed)


def ell_label(ell: float) -> str:
    return "inf" if np.isinf(ell) else f"{ell:g}"


def run_channel_figure(
    make_schedule,
    *,
    rounds: int,
    eval_round,
    policies: dict | None = None,
    n: int = 10,
    local_steps: int = 8,
    local_batch: int = 64,
    lr: float = 0.1,
    n_train: int = 4000,
    seed: int = 0,
    engine: str = "loop",
    prefetch: str = "inline",
    device=None,
    relay_backend: str = "einsum",
    init_params=None,
    taus=None,
) -> dict[str, FigureResult]:
    """Train under each of ``policies`` (name → (strategy, policy factory);
    default :func:`channel_policies`) over a fresh ``make_schedule()`` each,
    on the same data, batches and τ stream, at the MLP: the body the
    reference's three channel scripts share.  The simulator takes p from the channel each
    round (``p=None``).

    ``engine``: ``"loop"`` evaluates the test accuracy after every round r
    with ``eval_round(r)``; ``"scan"`` and ``"pipelined"`` (staging
    ``prefetch="inline"`` or ``"thread"``) run chunks of HOLD rounds and
    evaluate at each channel epoch's end.  ``init_params`` as in
    :func:`run_figure`; ``taus``, a (rounds, n) array of uplink masks, goes
    to the loop only.  A scan or pipelined engine that captures more than
    two chunk graphs raises, as the reference's retrace check does.
    """
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r} (known: {ENGINES})")
    if taus is not None and engine != "loop":
        raise ValueError("taus= is handed to the loop only: the engines draw their own τ")
    dev = resolve_device(device)
    policies = channel_policies() if policies is None else policies
    with _repeatable_f32(dev):
        ds, parts, init, loss, accuracy = _figure_data("mlp", n, n_train, seed, dev)
        taus = _checked_taus(taus, rounds, n)
        results = {}
        for name, (strategy, make_policy) in policies.items():
            policy = make_policy() if make_policy else None
            loader = FederatedLoader(ds, parts, seed=seed)  # same data order per policy
            sim = FLSimulator(
                loss, n_clients=n, strategy=strategy, p=None, local_steps=local_steps,
                client_opt=ClientOpt(kind="sgd", weight_decay=1e-4), server_opt=ServerOpt(),
                relay_backend=relay_backend, device=dev,
            )
            params = init(seed) if init_params is None else from_jax_params(init_params, device=dev)
            ss = sim.init_server_state(params)
            gen = torch.Generator(device=dev).manual_seed(seed + 1)  # same τ stream per policy
            accs, round_ms = [], []

            def lap(n_rounds, r, params_, evaluate):
                # host ms a round since the last lap, to the device's end;
                # then the evaluation, outside the rounds' time
                nonlocal lap_start
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                round_ms.extend([(time.perf_counter() - lap_start) * 1e3 / n_rounds] * n_rounds)
                if evaluate:
                    accs.append((r, accuracy(params_)))
                lap_start = time.perf_counter()

            kw = dict(schedule=make_schedule(), rounds=rounds, lr=lr, policy=policy,
                      next_batch=lambda: loader.round_batch(local_steps, local_batch))
            counts = None
            t0 = time.time()
            lap_start = time.perf_counter()
            if engine == "loop":
                params, ss, metrics, _ = run_rounds_loop(
                    sim, gen, params, ss, taus=taus, **kw,
                    on_round=lambda r, params_: lap(1, r, params_, eval_round(r)))
            else:
                eng = (EpochScanEngine(sim, chunk=HOLD) if engine == "scan"
                       else PipelinedScanEngine(sim, chunk=HOLD, prefetch=prefetch))
                params, ss, metrics, _ = eng.run_schedule(
                    gen, params, ss, **kw,
                    on_segment=lambda seg, params_, _m: lap(
                        seg.n_rounds, seg.start_round + seg.n_rounds - 1, params_, True))
                if eng.trace_count > 2:
                    raise RuntimeError(f"{engine} engine captured {eng.trace_count} chunk "
                                       "graphs; at most 2 (chunk length × churn mask)")
                counts = dict(trace_count=eng.trace_count, replays=eng.replays,
                              eager_chunks=eng.eager_chunks)
                if engine == "pipelined":
                    counts.update(dispatches=eng.dispatches, prefetch_stats=eng.prefetch_stats)
                del eng  # its captured graphs and static buffers go with it
            losses = [float(x) for x in metrics["loss"]]
            results[name] = FigureResult(name, losses, accs, time.time() - t0, round_ms,
                                         params, engine_counts=counts, policy=policy)
        return results


def scheduler_line(figure: str, stats) -> str:
    """The reference's OPT-α scheduler row of an adaptive policy's stats."""
    return (f"{figure}/opt_alpha_scheduler,0,rounds={stats.rounds};solves={stats.solves};"
            f"cache_hits={stats.cache_hits};warm_solves={stats.warm_solves};"
            f"mean_sweeps={stats.mean_sweeps:.1f}")


def _channel_figure(figure: str, make_schedule, rounds, model, n, seed, eval_every, kw):
    if model != "mlp":
        # the study is of the channel, not the architecture (the reference's)
        study = "churn" if figure == "fig6" else "channel"
        print(f"{figure}/skipped,0,reason={study}_study_is_mlp_only;model={model}")
        return {}
    results = run_channel_figure(
        lambda: make_schedule(n, seed=seed + 7),  # the same channel per policy
        rounds=rounds, n=n, seed=seed,
        eval_round=lambda r: r % eval_every == 0 or r == rounds - 1, **kw)
    print_figure_csv(figure, results)
    for res in results.values():
        if isinstance(res.policy, channels.AdaptiveOptAlpha):
            print(scheduler_line(figure, res.policy.stats))
    return results


def fig5(rounds: int = 30, model: str = "mlp", n: int = 10, seed: int = 0,
         eval_every: int = 2, **kw):
    """Fig. 5 (``benchmarks/fig5_timevarying.py``), beyond the paper: the
    three policies under Markov fading and p drift.  Claim: adaptive
    re-OPT-α beats the stale A, which beats no relaying.  ``kw`` goes to
    :func:`run_channel_figure` (``engine=``, ``device=``, ...)."""
    return _channel_figure("fig5", fig5_schedule, rounds, model, n, seed, eval_every, kw)


def fig6(rounds: int = 30, model: str = "mlp", n: int = 10, seed: int = 0,
         eval_every: int = 2, **kw):
    """Fig. 6 (``benchmarks/fig6_churn.py``), beyond the paper: Fig. 5's
    channel with rotating-cohort churn.  Claim: adaptive ColRel ≥ blind
    FedAvg."""
    return _channel_figure("fig6", fig6_schedule, rounds, model, n, seed, eval_every, kw)


def sweep_mean_line(results: dict[str, FigureResult]) -> str:
    """``fig_corr``'s summary row: per policy the mean over ℓ of the mean
    accuracy and of the final loss, and whether they order adaptive ≥ stale
    ≥ FedAvg in accuracy (at the 1,000-image test set's resolution, 1e-3)
    and adaptive ≤ stale ≤ FedAvg in loss.  ``results`` is keyed
    ``<policy>@ell=<ℓ>``."""
    mean_accs, final_losses = {}, {}
    for tag, res in results.items():
        name = tag.split("@", 1)[0]
        mean_accs.setdefault(name, []).append(float(np.mean([a for _, a in res.accs])))
        final_losses.setdefault(name, []).append(res.losses[-1])
    acc_m = {k: float(np.mean(v)) for k, v in mean_accs.items()}
    loss_m = {k: float(np.mean(v)) for k, v in final_losses.items()}
    tol = 1e-3
    acc_ordered = (acc_m["colrel_adaptive"] >= acc_m["colrel_stale"] - tol
                   and acc_m["colrel_stale"] >= acc_m["fedavg_dropout_blind"] - tol)
    loss_ordered = (loss_m["colrel_adaptive"] <= loss_m["colrel_stale"]
                    <= loss_m["fedavg_dropout_blind"])
    return ("fig_corr/sweep_mean,0,"
            + ";".join(f"acc_{k}={v:.4f}" for k, v in sorted(acc_m.items())) + ";"
            + ";".join(f"loss_{k}={v:.4f}" for k, v in sorted(loss_m.items()))
            + f";adaptive_ge_stale_ge_fedavg_acc={acc_ordered}"
            + f";adaptive_le_stale_le_fedavg_loss={loss_ordered}")


def fig_corr(rounds: int = 30, model: str = "mlp", n: int = 10, seed: int = 0,
             taus=None, **kw):
    """The correlated-shadowing sweep (``benchmarks/fig_correlated.py``),
    beyond the paper: the three policies at each ℓ of CORR_SWEEP, the
    accuracy evaluated at each coherence interval's end.  Claim: over the
    sweep, mean accuracy orders adaptive ≥ stale ≥ FedAvg and mean final
    loss strictly the other way.  ``taus`` maps each ℓ to the loop's τ
    stream at it (p follows the shadowing, so each ℓ has its own)."""
    if model != "mlp":
        print(f"fig_corr/skipped,0,reason=channel_study_is_mlp_only;model={model}")
        return {}
    results = {}
    for ell in CORR_SWEEP:
        res = run_channel_figure(
            lambda: corr_schedule(n, ell, seed=seed + 7),  # the same channel per policy
            rounds=rounds, n=n, seed=seed,
            eval_round=lambda r: r % HOLD == HOLD - 1 or r == rounds - 1,
            taus=None if taus is None else taus[ell], **kw)
        for name, r in res.items():
            tag = f"{name}@ell={ell_label(ell)}"
            results[tag] = dataclasses.replace(r, strategy=tag)
    print_figure_csv("fig_corr", results)
    print(sweep_mean_line(results))
    return results


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--figure", required=True, choices=[*ALL_FIGURES, "all"])
    ap.add_argument("--model", default="mlp", choices=["mlp", "resnet20"])
    ap.add_argument("--rounds", type=int, default=100)
    ap.add_argument("--engine", default="loop", choices=ENGINES,
                    help="round engine for fig5, fig6 and fig_corr: the per-round loop, "
                         "the epoch engine, or the pipelined engine (τ drawn in the "
                         "chunk, host staging prefetched)")
    ap.add_argument("--device", default=None, help="default: the GPU")
    ap.add_argument("--seed", type=int, default=0, help="data, parameters and τ")
    # the dense backends (segment takes a sparse operand)
    ap.add_argument("--relay-backend", default="einsum",
                    choices=[b for b in RELAY_BACKENDS if b != "segment"])
    args = ap.parse_args(argv)
    runs = {"fig2": fig2, "fig3": fig3, "fig4": fig4, "fig5": fig5, "fig6": fig6,
            "fig_corr": fig_corr}
    for figure in (ALL_FIGURES if args.figure == "all" else [args.figure]):
        kw = {"engine": args.engine} if figure in CHANNEL_FIGURES else {}
        runs[figure](rounds=args.rounds, model=args.model, device=args.device,
                     relay_backend=args.relay_backend, seed=args.seed, **kw)


if __name__ == "__main__":
    main()
