"""The paper's convergence claims on a strongly convex ERM, where Theorem 1's
assumptions hold exactly.

The counterpart of the setting of the JAX package's
``tests/test_fl_convergence.py``: ten clients with the paper's heterogeneous
uplinks on ring(10, 1), the quadratic f_i(x) = ½ (x − c_i)ᵀ H (x − c_i) in
20 dimensions (``data.synthetic.quadratic_problem``), 4 local steps of
batch 8 a round over 150 rounds at lr min(0.4, 4 / (rT + 1)).  The error is
‖x − x*‖² after the last round.  The claims, with the reference's bounds:

* ColRel beats blind FedAvg-dropout: err(colrel) < 0.3 × err(blind), on the
  first τ seed;
* optimized A beats Alg. 3's initial A: mean err(opt) < 1.05 × mean err(init);
* ColRel comes within reach of no-dropout: mean err(colrel) < 250 ×
  max(mean err(no-dropout), 1e-4).

The means run over the τ seeds (42, 43, 44): one τ realization fluctuates by
more than 2× around the expected error.  Torch cannot draw the reference's
threefry numbers, so the batches' noise comes from a CPU generator seeded 1
(the same on every device) and τ from a generator on the run's device,
seeded with the τ seed; :func:`run_quadratic` also takes both as arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import connectivity, opt_alpha, topology
from repro_torch.data.synthetic import quadratic_problem
from repro_torch.fl.simulator import FLSimulator
from repro_torch.optim.sgd import ClientOpt
from repro_torch.utils import resolve_device

N_CLIENTS, DIM, LOCAL_STEPS, LOCAL_BATCH, ROUNDS = 10, 20, 4, 8, 150
SEEDS = (42, 43, 44)
# the reference's bounds (tests/test_fl_convergence.py)
BLIND_RATIO, INIT_RATIO, NO_DROPOUT_RATIO, ERR_FLOOR = 0.3, 1.05, 250.0, 1e-4


def quadratic_setting(*, device=None, noise=None) -> dict:
    """The problem, channel and batches on ``device``.  ``noise``: a
    (ROUNDS, n, T, b, dim) array added to the client centres (the reference
    hands over its own); by default 0.5 × a standard normal draw of a CPU
    generator seeded 1."""
    dev = resolve_device(device)
    H, centers, x_star = quadratic_problem(DIM, N_CLIENTS, seed=0)
    p = connectivity.paper_heterogeneous().p
    adj = topology.ring(N_CLIENTS, 1)
    shape = (ROUNDS, N_CLIENTS, LOCAL_STEPS, LOCAL_BATCH, DIM)
    if noise is None:
        noise = torch.randn(shape, generator=torch.Generator().manual_seed(1)).numpy() * 0.5
    batches = (centers[None, :, None, None, :] + np.asarray(noise)).astype(np.float32)
    Hd = torch.as_tensor(H, device=dev)

    def loss_fn(params, batch):
        diff = params["x"][None, :] - batch["c"]
        return 0.5 * torch.mean(torch.einsum("bi,ij,bj->b", diff, Hd, diff))

    return dict(
        loss_fn=loss_fn, p=p, A=opt_alpha.optimize(p, adj, sweeps=60).A,
        A0=opt_alpha.initial_weights(p, adj),
        batches=torch.as_tensor(batches, device=dev),
        x_star=torch.as_tensor(x_star, device=dev), device=dev)


def run_quadratic(q: dict, strategy: str, A=None, *, seed: int = SEEDS[0],
                  relay_backend: str = "einsum", taus=None, trajectory: bool = False):
    """‖x − x*‖² after ``ROUNDS`` rounds from x = 0; with
    ``trajectory=True`` also x after every round.  τ comes from a generator
    on the device seeded ``seed``, or from ``taus`` (ROUNDS, n)."""
    sim = FLSimulator(
        q["loss_fn"], n_clients=N_CLIENTS, strategy=strategy, A=A, p=q["p"],
        local_steps=LOCAL_STEPS, client_opt=ClientOpt(kind="sgd", weight_decay=0.0),
        relay_backend=relay_backend, device=q["device"])
    params = {"x": torch.zeros((DIM,), device=q["device"])}
    ss = sim.init_server_state(params)
    gen = torch.Generator(device=q["device"]).manual_seed(seed)
    xs = []
    for r in range(ROUNDS):
        lr = min(0.4, 4.0 / (r * LOCAL_STEPS + 1))
        tau = None if taus is None else taus[r]
        params, ss, _ = sim.run_round(gen, params, ss, {"c": q["batches"][r]}, lr, tau=tau)
        if trajectory:
            xs.append(params["x"])
    err = float(torch.sum((params["x"] - q["x_star"]) ** 2))
    return (err, torch.stack(xs)) if trajectory else err


def check_claims(q: dict, *, relay_backend: str = "einsum") -> dict:
    """Each claim's two sides and whether it holds, and every run's error by
    seed: ten runs of ``ROUNDS`` rounds."""
    def errs(strategy, A=None, seeds=SEEDS):
        return [run_quadratic(q, strategy, A, seed=s, relay_backend=relay_backend)
                for s in seeds]

    err = {"colrel": errs("colrel_fused", q["A"]), "blind": errs("fedavg_blind", seeds=SEEDS[:1]),
           "init": errs("colrel_fused", q["A0"]), "no_dropout": errs("no_dropout")}
    mean = {k: float(np.mean(v)) for k, v in err.items()}
    sides = {
        "colrel_beats_fedavg_dropout": (err["colrel"][0], BLIND_RATIO * err["blind"][0]),
        "optimized_beats_init": (mean["colrel"], INIT_RATIO * mean["init"]),
        "colrel_within_reach_of_no_dropout": (
            mean["colrel"], NO_DROPOUT_RATIO * max(mean["no_dropout"], ERR_FLOOR)),
    }
    return {"errors": err, "claims": {k: {"value": a, "bound": b, "holds": a < b}
                                      for k, (a, b) in sides.items()}}
