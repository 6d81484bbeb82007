"""Attribute collective bytes to the port code that issued them.

The PyTorch counterpart of the JAX package's ``launch/attribute.py``: the
diagnosis step of the performance workflow.  The reference groups the
loop-corrected collective bytes of a compiled module by HLO ``op_name``
(the JAX trace path).  Here :func:`attribute` runs a step under
`launch/hlo_cost.py`'s counting mode and groups the bytes of every
collective by (kind, source), the source being the innermost frame of the
port that issued it — ``fl/ring.py:ring_relay_flat`` for the ring
exchange, ``fl/distributed.py:scan_rounds`` for the gathered delta blocks
— past the mesh's own collective wrappers (``launch/mesh.py``).

The port runs the model zoo unsharded, so its collectives are the
federated round's exchanges.  ``main`` runs the client-sharded round step
(`fl/distributed.py`'s ``build_sharded_scan_round_step``) on gloo ranks on
the CPU, once a relay exchange, and prints the top entries:

  PYTHONPATH=src python -m repro_torch.launch.attribute [--ranks 4] \\
      [--clients 8] [--exchange gather,ring] [--top 15]
"""
from __future__ import annotations

import argparse
import os
import sys
from collections import defaultdict

import torch

from repro_torch.launch import hlo_cost

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# frames that relay a collective rather than issue it
_SKIP = {os.path.join("launch", "mesh.py"), os.path.join("launch", "hlo_cost.py"),
         os.path.join("launch", "attribute.py")}


def _source() -> str:
    """``module/path.py:function`` of the innermost port frame on the
    stack that is not a collective wrapper; ``?`` if none is."""
    frame = sys._getframe(1)
    while frame is not None:
        path = os.path.abspath(frame.f_code.co_filename)
        if path.startswith(_PKG + os.sep):
            rel = os.path.relpath(path, _PKG)
            if rel not in _SKIP:
                return f"{rel.replace(os.sep, '/')}:{frame.f_code.co_name}"
        frame = frame.f_back
    return "?"


def attribute(fn, *args, **kw) -> dict:
    """(collective kind, source) -> bytes of this rank, over one call of
    ``fn(*args, **kw)`` (every loop trip counted)."""
    out: dict = defaultdict(float)

    def on_op(_func, cost):
        for kind, nbytes in cost.collectives.items():
            out[(kind, _source())] += nbytes

    mode = hlo_cost._CostMode(on_op=on_op)
    with mode:
        fn(*args, **kw)
    return dict(out)


def _loss(params, batch):
    h = torch.tanh(batch["x"] @ params["w"])
    return torch.mean((h @ params["v"] - batch["y"]) ** 2)


def sharded_round_attribution(rank: int, exchange: str, n_clients: int, rounds: int) -> dict:
    """Rank program (for ``run_ranks``): ``rounds`` rounds of the
    client-sharded step with ``exchange`` on a small MLP (dim 64, width 32),
    attributed.  Returns this rank's attribution."""
    from repro_torch.core import connectivity, opt_alpha, topology
    from repro_torch.fl.distributed import build_sharded_scan_round_step
    from repro_torch.launch.mesh import make_client_mesh

    mesh = make_client_mesh()
    p = connectivity.heterogeneous_profile(n_clients).p
    A = opt_alpha.optimize(p, topology.ring(n_clients, 1), sweeps=10).A
    step = build_sharded_scan_round_step(_loss, n_clients=n_clients, local_steps=1, mesh=mesh,
                                         exchange=exchange)
    gen = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(64, 32, generator=gen) / 8, "v": torch.randn(32, 10, generator=gen)}
    batches = {"x": torch.randn(rounds, n_clients, 1, 4, 64, generator=gen),
               "y": torch.randn(rounds, n_clients, 1, 4, 10, generator=gen)}
    return attribute(step, torch.Generator().manual_seed(1), params, None, batches,
                     torch.as_tensor(p, dtype=torch.float32), 0.1, A=A)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--exchange", default="gather,ring")
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args(argv)
    from repro_torch.launch.mesh import run_ranks

    attr: dict = defaultdict(float)
    for exchange in args.exchange.split(","):
        rank0 = run_ranks(sharded_round_attribution, args.ranks,
                          args=(exchange, args.clients, args.rounds), num_threads=1)[0]
        for (kind, src), b in rank0.items():
            attr[(kind, f"{src} [{exchange}]")] += b
    print(f"collective bytes of rank 0 of {args.ranks}, {args.rounds} rounds of the "
          f"client-sharded step (n = {args.clients}):")
    for (kind, src), b in sorted(attr.items(), key=lambda kv: -kv[1])[: args.top]:
        print(f"{b / 1e3:12.3f} kB  {kind:20s} {src}")
    return dict(attr)


if __name__ == "__main__":
    main()
