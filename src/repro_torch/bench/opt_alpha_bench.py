"""OPT-α (Alg. 3) runtime and variance-reduction bench.

The counterpart of the JAX package's ``benchmarks/bench_opt_alpha.py``, on
the port's ``core`` (host numpy, line for line the reference's, so the
derived fields are equal).  Complexity claim: O(L · (n² + K)) per the paper
§IV: µs a Gauss-Seidel sweep across client counts and topologies (a host
wall clock), and the S(p, A) reduction achieved.

    PYTHONPATH=src python -m repro_torch.bench.opt_alpha_bench
"""
from __future__ import annotations

import time

from repro_torch.core import connectivity, opt_alpha, topology

CLIENTS = (10, 32, 64, 128)


def run() -> list[tuple[str, float, str]]:
    rows = []
    for n in CLIENTS:
        p = connectivity.heterogeneous_profile(n).p
        for topo_name, adj in (("ring2", topology.ring(n, 2)),
                               ("fct", topology.fully_connected(n)),
                               ("er.3", topology.erdos_renyi(n, 0.3, seed=1))):
            A0 = opt_alpha.initial_weights(p, adj)
            s0 = opt_alpha.variance_proxy(p, A0)
            t0 = time.perf_counter()
            res = opt_alpha.optimize(p, adj, sweeps=30)
            dt = time.perf_counter() - t0
            us_per_sweep = 1e6 * dt / max(1, res.sweeps)
            rows.append((f"opt_alpha/n{n}/{topo_name}", us_per_sweep,
                         f"S_init={s0:.3f};S_opt={res.S_history[-1]:.3f};"
                         f"sweeps={res.sweeps};bisect={res.bisection_iters_total}"))
    for name, us, derived in rows:
        print(f"{name},{us:.0f},{derived}")
    return rows


if __name__ == "__main__":
    run()
