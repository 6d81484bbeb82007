"""Paper Fig. 3/4 style comparison with full accuracy curves (CSV out), on
PyTorch.

    PYTHONPATH=src python examples/torch_colrel_vs_fedavg.py --rounds 30 \\
        [--non-iid] [--model mlp|resnet20] [--csv out.csv] [--device cpu]

The port's copy of ``examples/colrel_vs_fedavg.py``: round-by-round test
accuracy per strategy on stdout and (optionally) a CSV file, the data behind
the paper's accuracy-vs-round figures.  Runs on the GPU unless
``--device cpu``."""
import argparse

from repro_torch.bench.figures import run_figure
from repro_torch.core import connectivity, opt_alpha, topology


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--non-iid", action="store_true")
    ap.add_argument("--model", default="mlp", choices=["mlp", "resnet20"])
    ap.add_argument("--csv", default="")
    ap.add_argument("--device", default=None, help="default: the GPU")
    args = ap.parse_args(argv)

    p = connectivity.paper_heterogeneous().p
    adj = topology.ring(10, k=2 if args.non_iid else 1)
    opt = opt_alpha.optimize(p, adj, sweeps=60)
    A0 = opt_alpha.initial_weights(p, adj)
    print(f"S(p,A): init {opt_alpha.variance_proxy(p, A0):.3f} -> "
          f"optimized {opt.S_history[-1]:.3f}")

    results = run_figure(
        p=p, adj=adj,
        strategies={
            "no_dropout": ("no_dropout", None),
            "fedavg_blind": ("fedavg_blind", None),
            "fedavg_nonblind": ("fedavg_nonblind", None),
            "colrel_unopt": ("colrel_fused", A0),
            "colrel_opt": ("colrel_fused", opt.A),
        },
        rounds=args.rounds, non_iid=args.non_iid,
        server_momentum=0.9 if args.non_iid else 0.0, model=args.model,
        device=args.device,
    )

    names = list(results)
    rows = ["round," + ",".join(names)]
    n_evals = len(results[names[0]].accs)
    for i in range(n_evals):
        r = results[names[0]].accs[i][0]
        rows.append(f"{r}," + ",".join(f"{results[nm].accs[i][1]:.4f}" for nm in names))
    out = "\n".join(rows)
    print(out)
    if args.csv:
        with open(args.csv, "w") as f:
            f.write(out + "\n")
        print(f"wrote {args.csv}")


if __name__ == "__main__":
    main()
