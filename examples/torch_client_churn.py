"""Client churn on PyTorch: ColRel when clients come and go mid-run.

    PYTHONPATH=src python examples/torch_client_churn.py [--device cpu] [--rounds 12]

The port's copy of ``examples/client_churn.py``.  Ten padded client slots;
every few rounds one cohort departs and another rejoins (rotating shifts),
while D2D links fade on a Markov chain.  A `ChurnSchedule` streams one
(adj, p, active, epoch) per round; the adaptive OPT-α scheduler re-solves
the *masked* relay problem per epoch (departed clients carry zero weight,
unbiasedness holds over whoever is present).  Compare against blind FedAvg
on the identical channel: the data is non-IID (one class shard per client),
so a departing or badly-connected client takes its classes with it — unless
its neighbors relay its update to the PS.

The JAX original also asserts ``sim.trace_count == 1`` (membership changes
never recompile its jitted step).  The port runs eagerly and compiles
nothing, so it has no trace count and the copy drops that assert.  Runs on
the GPU unless ``--device cpu``.
"""
import argparse

import numpy as np
import torch

from repro_torch import channels
from repro_torch.core import connectivity, topology
from repro_torch.data.loader import FederatedLoader
from repro_torch.data.partition import sort_and_partition
from repro_torch.data.synthetic import gaussian_classification
from repro_torch.fl.simulator import FLSimulator
from repro_torch.optim.sgd import ClientOpt
from repro_torch.utils import resolve_device

N_MAX, DIM, CLASSES = 10, 32, 10


def make_schedule():
    """Markov-fading ring + one of 5 cohorts offline per 3-round shift."""
    link = channels.MarkovLinkProcess(
        topology.ring(N_MAX, 2), p_up_to_down=0.3, p_down_to_up=0.5, seed=7)
    return channels.ChurnSchedule(
        membership=channels.RotatingCohorts(N_MAX, n_cohorts=5, hold=3),
        link_process=link,
        p=connectivity.paper_heterogeneous().p,
        adj_every=2)


def loss_fn(params, batch):
    logits = batch["inputs"] @ params["w"] + params["b"]
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(1, batch["labels"].long()[:, None])[:, 0]
    return torch.mean(logz - gold)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: the GPU")
    ap.add_argument("--rounds", type=int, default=12)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # Data + model (same linear classifier as torch_quickstart.py)
    ds = gaussian_classification(4000, dim=DIM, n_classes=CLASSES, snr=0.8, seed=0)
    test = gaussian_classification(1000, dim=DIM, n_classes=CLASSES, snr=0.8, seed=1)
    test_x = torch.as_tensor(test.inputs, device=device)
    test_y = torch.as_tensor(test.labels, device=device).long()

    def accuracy(params):
        logits = test_x @ params["w"] + params["b"]
        return float((logits.argmax(-1) == test_y).float().mean())

    def train(strategy: str, policy=None) -> float:
        schedule = make_schedule()  # identical channel for both runs
        sim = FLSimulator(loss_fn, n_clients=N_MAX, strategy=strategy, local_steps=4,
                          client_opt=ClientOpt(kind="sgd", weight_decay=1e-4),
                          device=device)
        loader = FederatedLoader(
            ds, sort_and_partition(ds, N_MAX, shards_per_client=1, seed=0), seed=0)
        params = {"w": torch.zeros((DIM, CLASSES), device=device),
                  "b": torch.zeros((CLASSES,), device=device)}
        state = sim.init_server_state(params)
        gen = torch.Generator(device=device).manual_seed(42)
        last_epoch = -1
        for r, ch in enumerate(schedule.rounds(args.rounds)):
            A = policy.relay_matrix(ch) if policy else None
            batch = loader.round_batch(4, 16)
            params, state, m = sim.run_round(gen, params, state, batch, 0.5,
                                             A=A, p=ch.p, active=ch.active)
            if policy and ch.epoch_id != last_epoch:
                last_epoch = ch.epoch_id
                away = np.nonzero(~ch.active)[0].tolist()
                print(f"round {r:3d}  epoch {ch.epoch_id:3d}  "
                      f"away={away}  links={int(ch.adj.sum()) // 2:2d}  "
                      f"loss={float(m['loss']):.4f}")
        return accuracy(params)

    print("=== adaptive ColRel under churn ===")
    policy = channels.AdaptiveOptAlpha(sweeps=40, warm_sweeps=12)
    acc_colrel = train("colrel_fused", policy)
    s = policy.stats
    print("\n=== blind FedAvg on the identical channel ===")
    acc_fedavg = train("fedavg_blind")

    print(f"\nacc@{args.rounds}: adaptive_colrel={acc_colrel:.3f}  "
          f"fedavg_blind={acc_fedavg:.3f}")
    print(f"opt_alpha_solves={s.solves} (warm={s.warm_solves}, "
          f"cache_hits={s.cache_hits}, mean_sweeps={s.mean_sweeps:.1f})")
    if acc_colrel < acc_fedavg:
        raise SystemExit(f"adaptive ColRel {acc_colrel} < FedAvg-blind {acc_fedavg}")
    print("adaptive ColRel ≥ FedAvg-blind under churn ✓")


if __name__ == "__main__":
    main()
