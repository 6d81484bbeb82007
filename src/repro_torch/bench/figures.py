"""The paper's Figs. 2–4 protocol on the port.

The counterpart of the JAX package's ``benchmarks/common.py`` and of the
settings in ``benchmarks/fig2_homogeneous.py``, ``fig3_ring.py`` and
``fig4_noniid.py``.  Each figure trains the same model under several
aggregation strategies over identical data and τ randomness and reports
final losses and accuracies.  Models: ``resnet20`` (the paper's, ResNet-20
with GroupNorm) or ``mlp`` (CIFAR-shaped data flattened; fast, the same
protocol behaviour).

    PYTHONPATH=src python -m repro_torch.bench.figures --figure fig4 \\
        --model mlp --rounds 30 [--device cpu] [--relay-backend hopper_fused] \\
        [--seed S]

The host data (``cifar_like``, the partitions, ``FederatedLoader``) is the
reference's numpy, so the same seed gives the same batches.  Torch cannot
draw the reference's threefry numbers: ``run_figure(init_params=, taus=)``
takes its initial parameters and τ as arrays (the cross-package tests hand
them over); without them the port draws its own, the parameters from
``seed`` and τ from a generator on the device seeded ``seed + 1``, the same
stream for every strategy.  Runs on the GPU unless ``device="cpu"``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.resnet20_cifar import CONFIG as RESNET20_CONFIG
from repro_torch.core import connectivity, opt_alpha, topology
from repro_torch.core.aggregation import ServerOpt
from repro_torch.data.loader import FederatedLoader
from repro_torch.data.partition import iid_partition, sort_and_partition
from repro_torch.data.synthetic import cifar_like
from repro_torch.fl.simulator import FLSimulator
from repro_torch.kernels.ops import RELAY_BACKENDS
from repro_torch.models.resnet import init_resnet20, resnet20_logits, resnet20_loss
from repro_torch.optim.sgd import ClientOpt
from repro_torch.utils import from_jax_params, resolve_device

FIGURES = ("fig2", "fig3", "fig4")


@dataclasses.dataclass
class FigureResult:
    strategy: str
    losses: list
    accs: list
    seconds: float
    # host ms of each round, to the read of its loss (evaluations excluded)
    round_ms: list = dataclasses.field(default_factory=list)
    params: object = None  # the parameters after the last round


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
        ds = cifar_like(n_train, snr=0.5, seed=seed)
        test = cifar_like(1000, snr=0.5, seed=seed + 99)
        parts = (sort_and_partition(ds, n, shards_per_client=1, seed=seed)
                 if non_iid else iid_partition(ds, n, seed=seed))
        init, logits_fn, loss = _make_model(model, dev)
        test_x = torch.as_tensor(test.inputs, device=dev)
        test_y = torch.as_tensor(test.labels, device=dev).long()
        if taus is not None:
            taus = np.asarray(taus, np.float32)
            if taus.shape != (rounds, n):
                raise ValueError(f"taus shape {taus.shape} != (rounds, n) = {(rounds, n)}")

        @torch.no_grad()
        def accuracy(params):
            return float((logits_fn(params, test_x).argmax(-1) == test_y).float().mean())

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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--figure", required=True, choices=FIGURES)
    ap.add_argument("--model", default="mlp", choices=["mlp", "resnet20"])
    ap.add_argument("--rounds", type=int, default=100)
    ap.add_argument("--device", default=None, help="default: the GPU")
    ap.add_argument("--seed", type=int, default=0, help="data, parameters and τ")
    # the dense backends (segment takes a sparse operand)
    ap.add_argument("--relay-backend", default="einsum",
                    choices=[b for b in RELAY_BACKENDS if b != "segment"])
    args = ap.parse_args(argv)
    run = {"fig2": fig2, "fig3": fig3, "fig4": fig4}[args.figure]
    run(rounds=args.rounds, model=args.model, device=args.device,
        relay_backend=args.relay_backend, seed=args.seed)


if __name__ == "__main__":
    main()
