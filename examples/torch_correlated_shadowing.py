"""Correlated connectivity on PyTorch: when failures come in bursts.

    PYTHONPATH=src python examples/torch_correlated_shadowing.py [--device cpu] [--rounds 24]

The port's copy of ``examples/correlated_shadowing.py``.  Ten clients on a
ring, embedded on a circle.  One latent shadowing field (AR(1) in time,
Gaussian-process over the positions in space) drives the whole channel: a
node in deep shadow loses *all* its D2D edges at once, and — because the
uplink rides the same fade — its p_i collapses in the same round.
``(adj, p)`` are jointly sampled, unlike the independent per-edge chains of
`examples/torch_timevarying_channel.py`.  The adaptive OPT-α scheduler
re-solves only at joint epoch boundaries (LRU cache on the full (adj, p)
value + warm starts).

The JAX original also asserts ``sim.trace_count == 1`` (the correlated
channel is value-only traffic for its jitted step).  The port runs eagerly
and compiles nothing, so it has no trace count and the copy drops that
assert.  Runs on the GPU unless ``--device cpu``.
"""
import argparse

import numpy as np
import torch

from repro_torch import channels
from repro_torch.core import connectivity, topology
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
    ap.add_argument("--rounds", type=int, default=24)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # 1. The channel: one latent field → blockage + coupled uplink.
    #    corr_length=0.4 on the unit-square circle embedding couples each
    #    node to ~2 neighbors a side; try 0.0 (independent) or np.inf (one
    #    obstacle blocks the whole mesh at once).
    schedule = channels.CorrelatedChannel(
        topology.ring(N_CLIENTS, 2),
        connectivity.paper_heterogeneous().p,
        corr_length=0.4,
        rho=0.9,
        blockage_threshold=1.0,
        couple_uplink=True,
        uplink_gain=2.0,
        hold=3,  # 3-round coherence time → 3-round epochs for the scheduler
        seed=3,
    )
    policy = channels.AdaptiveOptAlpha(sweeps=40, warm_sweeps=12)

    # 2. Data + model (same linear classifier as torch_quickstart.py)
    ds = gaussian_classification(4000, dim=DIM, n_classes=CLASSES, snr=0.8, seed=0)
    test = gaussian_classification(1000, dim=DIM, n_classes=CLASSES, snr=0.8, seed=1)
    test_x = torch.as_tensor(test.inputs, device=device)
    test_y = torch.as_tensor(test.labels, device=device).long()

    # 3. Run: blocked nodes lose their edges *and* their uplink together
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
            blocked = np.nonzero(schedule.blocked)[0].tolist()
            print(f"round {r:3d}  epoch {ch.epoch_id:2d}  "
                  f"links={int(ch.adj.sum()) // 2:2d}  "
                  f"blocked={list(blocked)!s:12s}  "
                  f"mean_p={float(ch.p.mean()):.2f}  "
                  f"loss={float(m['loss']):.4f}")

    s = policy.stats
    acc = float(((test_x @ params["w"] + params["b"]).argmax(-1) == test_y).float().mean())
    print(f"\nacc@{args.rounds}={acc:.3f}  "
          f"epochs={last_epoch + 1}  opt_alpha_solves={s.solves} "
          f"(cache_hits={s.cache_hits}, warm={s.warm_solves}, "
          f"mean_sweeps={s.mean_sweeps:.1f})")


if __name__ == "__main__":
    main()
