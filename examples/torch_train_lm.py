"""End-to-end example on PyTorch: federally train a transformer LM with ColRel.

    PYTHONPATH=src python examples/torch_train_lm.py --rounds 200          # ~25M
    PYTHONPATH=src python examples/torch_train_lm.py --preset 100m --rounds 300
    PYTHONPATH=src python examples/torch_train_lm.py --preset 3m --device cpu

The port's copy of ``examples/train_lm.py``.  The model is the qwen3 family
(GQA + qk-norm) scaled to the requested parameter budget; data is the
synthetic affine-recurrence token stream (per-client stream skew = non-IID);
the protocol is the full paper stack: OPT-α weights → T local steps → D2D
relay → blind τ-masked PS aggregation → global momentum.  Checkpoints +
perplexity eval included.  Runs on the GPU unless ``--device cpu``."""
import argparse
import dataclasses
import functools
import time

import numpy as np
import torch

from repro_torch import checkpoint
from repro_torch.configs import registry as creg
from repro_torch.core import connectivity, opt_alpha, topology
from repro_torch.core.aggregation import ServerOpt
from repro_torch.data.loader import FederatedLoader
from repro_torch.data.partition import sort_and_partition
from repro_torch.data.synthetic import ArrayDataset, lm_tokens
from repro_torch.fl.simulator import FLSimulator
from repro_torch.models import registry as mreg
from repro_torch.optim.sgd import ClientOpt
from repro_torch.utils import resolve_device, tree_size

print = functools.partial(print, flush=True)

PRESETS = {
    # name: (n_layers, d_model, n_heads, n_kv, d_ff, vocab) ≈ params
    "3m": (4, 192, 4, 2, 512, 2048),       # fast CI-scale
    "25m": (8, 448, 8, 4, 1536, 8192),     # default: minutes on CPU
    "100m": (12, 768, 12, 4, 2688, 16384), # the "~100M for a few hundred steps" run
}


def build_cfg(preset: str):
    L, d, h, kv, f, v = PRESETS[preset]
    base = creg.get_config("qwen3-14b")
    return dataclasses.replace(
        base, name=f"qwen3-{preset}", n_layers=L, d_model=d, n_heads=h,
        n_kv=kv, head_dim=d // h, d_ff=f, vocab=v)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="25m", choices=sorted(PRESETS))
    ap.add_argument("--rounds", type=int, default=200)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--local-steps", type=int, default=2)
    ap.add_argument("--local-batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--lr", type=float, default=0.3)
    ap.add_argument("--strategy", default="colrel_fused")
    ap.add_argument("--checkpoint", default="checkpoints/train_lm.npz")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None, help="default: the GPU")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = build_cfg(args.preset)
    md = mreg.get_model(cfg)
    params = md.init(0, device=device)
    print(f"model {cfg.name}: {tree_size(params)/1e6:.1f}M params")

    n = args.clients
    conn = connectivity.heterogeneous_profile(n)
    adj = topology.ring(n, k=2)
    res = opt_alpha.optimize(conn.p, adj, sweeps=50)
    print(f"OPT-α: S {res.S_history[0]:.2f} -> {res.S_history[-1]:.2f}")

    # one draw of stream coefficients; the last 64 sequences are held out
    full = lm_tokens(2048 + 64, args.seq_len, vocab=cfg.vocab, n_streams=n, seed=0)
    ds = ArrayDataset(full.inputs[:2048], full.labels[:2048])
    held = ArrayDataset(full.inputs[2048:], full.labels[2048:])
    parts = sort_and_partition(ds, n, shards_per_client=2, seed=0)
    loader = FederatedLoader(ds, parts, seed=0)
    held_batch = {"tokens": torch.as_tensor(held.inputs[:, :-1], device=device),
                  "labels": torch.as_tensor(held.inputs[:, 1:], device=device)}

    def eval_loss(params):
        with torch.no_grad():
            return float(md.loss(params, held_batch))

    sim = FLSimulator(
        md.loss, n_clients=n, strategy=args.strategy,
        A=res.A if args.strategy.startswith("colrel") else None, p=conn.p,
        local_steps=args.local_steps,
        client_opt=ClientOpt(kind="sgd", weight_decay=1e-4),
        server_opt=ServerOpt(momentum=0.9), device=device)
    state = sim.init_server_state(params)
    gen = torch.Generator(device=device).manual_seed(1)
    t0 = time.time()
    for r in range(args.rounds):
        batch = loader.round_batch(args.local_steps, args.local_batch, lm=True)
        params, state, m = sim.run_round(gen, params, state, batch, args.lr)
        if r % args.log_every == 0 or r == args.rounds - 1:
            ev = eval_loss(params)
            print(f"round {r:4d} train_loss={float(m['loss']):.4f} "
                  f"eval_loss={ev:.4f} ppl={np.exp(min(ev, 20)):.1f} "
                  f"tau_up={int(m['tau'].sum())}/{n} "
                  f"({time.time()-t0:.0f}s)")
    if args.checkpoint:
        checkpoint.save(args.checkpoint, params,
                        metadata={"preset": args.preset, "rounds": args.rounds,
                                  "strategy": args.strategy})
        print(f"saved {args.checkpoint}")


if __name__ == "__main__":
    main()
