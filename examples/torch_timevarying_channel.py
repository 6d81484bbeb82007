"""Time-varying channel on PyTorch: ColRel when the network won't sit still.

    PYTHONPATH=src python examples/torch_timevarying_channel.py [--device cpu] [--rounds 20]

The port's copy of ``examples/timevarying_channel.py``.  Ten clients on
random-waypoint trajectories (D2D neighbors = within radio range), uplink
probabilities drifting as a reflected random walk.  A `ChannelSchedule`
streams one (adj, p, epoch) per round; the adaptive OPT-α scheduler
re-optimizes the relay matrix only on epoch changes, warm-started from the
previous optimum.

The JAX original also asserts ``sim.trace_count == 1`` (A and p enter its
jitted step by value, so it never recompiles).  The port runs eagerly and
compiles nothing, so it has no trace count and the copy drops that assert.
Runs on the GPU unless ``--device cpu``.
"""
import argparse

import torch

from repro_torch import channels
from repro_torch.core import connectivity
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
    ap.add_argument("--rounds", type=int, default=20)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # 1. The channel: mobility-driven topology + drifting uplink probabilities
    mobility = channels.RandomWaypointMobility(N_CLIENTS, radius=0.45, speed=0.08, seed=3)
    drift = channels.RandomWalkDrift(connectivity.paper_heterogeneous().p, sigma=0.03, seed=4)
    schedule = channels.TimeVaryingChannel(link_process=mobility, p_process=drift)
    policy = channels.AdaptiveOptAlpha(sweeps=40, warm_sweeps=12)

    # 2. Data + model (same linear classifier as torch_quickstart.py)
    ds = gaussian_classification(4000, dim=DIM, n_classes=CLASSES, snr=0.8, seed=0)
    test = gaussian_classification(1000, dim=DIM, n_classes=CLASSES, snr=0.8, seed=1)
    test_x = torch.as_tensor(test.inputs, device=device)
    test_y = torch.as_tensor(test.labels, device=device).long()

    # 3. Run: the channel stream drives per-round (A, p)
    sim = FLSimulator(loss_fn, n_clients=N_CLIENTS, strategy="colrel_fused", local_steps=4,
                      client_opt=ClientOpt(kind="sgd", weight_decay=1e-4), device=device)
    loader = FederatedLoader(ds, iid_partition(ds, N_CLIENTS, seed=0), seed=0)
    params = {"w": torch.zeros((DIM, CLASSES), device=device),
              "b": torch.zeros((CLASSES,), device=device)}
    state = sim.init_server_state(params)
    gen = torch.Generator(device=device).manual_seed(42)
    last_epoch = -1
    for r, ch in enumerate(schedule.rounds(args.rounds)):
        A = policy.relay_matrix(ch)
        batch = loader.round_batch(4, 16)
        params, state, m = sim.run_round(gen, params, state, batch, 0.5, A=A, p=ch.p)
        if ch.epoch_id != last_epoch:
            last_epoch = ch.epoch_id
            print(f"round {r:3d}  epoch {ch.epoch_id:3d}  "
                  f"links={int(ch.adj.sum()) // 2:2d}  "
                  f"mean_p={float(ch.p.mean()):.2f}  "
                  f"loss={float(m['loss']):.4f}")

    s = policy.stats
    acc = float(((test_x @ params["w"] + params["b"]).argmax(-1) == test_y).float().mean())
    print(f"\nacc@{args.rounds}={acc:.3f}  "
          f"epochs={last_epoch + 1}  opt_alpha_solves={s.solves} "
          f"(warm={s.warm_solves}, mean_sweeps={s.mean_sweeps:.1f})")


if __name__ == "__main__":
    main()
