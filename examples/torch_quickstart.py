"""Quickstart on PyTorch: the ColRel protocol in ~60 lines.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu] [--rounds 12]

The port's copy of ``examples/quickstart.py``.  Ten clients with
intermittent uplinks (the paper's heterogeneous p-vector), a ring D2D graph,
OPT-α relay weights, and federated rounds of a linear classifier — ColRel
vs blind FedAvg-with-dropout vs the no-dropout upper bound.  Runs on the GPU
unless ``--device cpu``."""
import argparse

import torch

from repro_torch.core import connectivity, opt_alpha, topology
from repro_torch.data.loader import FederatedLoader
from repro_torch.data.partition import iid_partition
from repro_torch.data.synthetic import gaussian_classification
from repro_torch.fl.simulator import FLSimulator
from repro_torch.optim.sgd import ClientOpt
from repro_torch.utils import resolve_device

N_CLIENTS, DIM, CLASSES = 10, 64, 10


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

    # 1. Connectivity model + D2D topology (paper Fig. 3 setting)
    conn = connectivity.paper_heterogeneous()
    adj = topology.ring(N_CLIENTS, k=1)

    # 2. OPT-α: minimize the variance proxy S(p, A) s.t. unbiasedness (Alg. 3)
    res = opt_alpha.optimize(conn.p, adj, sweeps=50)
    print(f"OPT-α: S {res.S_history[0]:.2f} -> {res.S_history[-1]:.2f} "
          f"in {res.sweeps} Gauss-Seidel sweeps")

    # 3. Data: IID synthetic classification, partitioned over clients
    ds = gaussian_classification(4000, dim=DIM, n_classes=CLASSES, snr=0.8, seed=0)
    test = gaussian_classification(1000, dim=DIM, n_classes=CLASSES, snr=0.8, seed=1)
    test_x = torch.as_tensor(test.inputs, device=device)
    test_y = torch.as_tensor(test.labels, device=device).long()

    def accuracy(params):
        logits = test_x @ params["w"] + params["b"]
        return float((logits.argmax(-1) == test_y).float().mean())

    # 4. Run the protocol under three aggregation strategies
    for strategy, A in [("no_dropout", None), ("fedavg_blind", None), ("colrel", res.A)]:
        sim = FLSimulator(loss_fn, n_clients=N_CLIENTS, strategy=strategy, A=A,
                          p=conn.p, local_steps=4,
                          client_opt=ClientOpt(kind="sgd", weight_decay=1e-4),
                          device=device)
        loader = FederatedLoader(ds, iid_partition(ds, N_CLIENTS, seed=0), seed=0)
        params = {"w": torch.zeros((DIM, CLASSES), device=device),
                  "b": torch.zeros((CLASSES,), device=device)}
        state = sim.init_server_state(params)
        gen = torch.Generator(device=device).manual_seed(42)
        acc5 = None
        for r in range(args.rounds):
            batch = loader.round_batch(4, 16)
            params, state, m = sim.run_round(gen, params, state, batch, lr=0.5)
            if r == min(4, args.rounds - 1):
                acc5 = accuracy(params)
        print(f"{strategy:14s} acc@5={acc5:.3f} acc@{args.rounds}={accuracy(params):.3f} "
              f"final_train_loss={float(m['loss']):.4f}")


if __name__ == "__main__":
    main()
