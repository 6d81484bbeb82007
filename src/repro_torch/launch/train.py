"""Continuous-training service: stream federated rounds, publish snapshots.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-14b --reduced \
        --rounds 50 --engine async --delay poisson --publish-every 10 \
        --ckpt-dir checkpoints [--device cpu]

:class:`ContinuousTrainer` drives any of the round engines (per-round loop,
epoch engine, pipelined engine, or the asynchronous staleness-weighted
engine) over a :class:`~repro_torch.channels.ChannelSchedule` in
checkpoint-sized bursts: the schedule / policy / batch stream stay live
across bursts (one continuous round stream, exactly as if a single ``run_*``
call had covered the whole horizon), and every ``publish_every`` rounds the
full training state is published via :func:`repro_torch.checkpoint.publish`
with atomic latest-pointer rotation.  The serving loop
(:class:`repro_torch.launch.serve.SnapshotEvalLoop`) reloads the newest
snapshot as it lands.

Resume: :meth:`ContinuousTrainer.restore_latest` reloads params, server
state, the τ generator and the round counter;
:meth:`ContinuousTrainer.advance_stream` replays the (deterministic,
seed-rebuilt) schedule / policy / batch stream to the restored round.  For
the synchronous engines the resumed trajectory is bitwise-equal to the
uninterrupted run (``tests/test_torch_launch.py``); the async engine
restarts with an empty arrival buffer (in-flight updates are lost on a
crash — the production semantic), so its resumed stream is statistically,
not bitwise, continuous.

The command line (:func:`main`) trains an LM of the model zoo with ColRel
through this trainer; it runs on the GPU unless ``--device cpu`` is given.
``--rounds 0`` streams indefinitely.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import checkpoint
from repro_torch.core import connectivity, topology
from repro_torch.fl.async_engine import AsyncRoundEngine
from repro_torch.fl.engine import EpochScanEngine, PipelinedScanEngine, run_rounds_loop

ENGINES = ("loop", "scan", "pipelined", "async")


class ContinuousTrainer:
    """Runs one engine in bursts over one live channel stream.

    ``engine`` ∈ {loop, scan, pipelined, async}.  The trainer owns the
    training state (params, server state, τ generator, round counter); the
    caller owns the stream (``schedule``, ``policy``, ``next_batch``) —
    they are stateful and advance only when rounds run, which is what makes
    the burst sequence one continuous trajectory.

    ``publish_every > 0`` + ``ckpt_dir`` publishes the full training state
    every N rounds (and after the final burst) with atomic latest-pointer
    rotation, keeping the newest ``keep`` snapshots.
    """

    def __init__(self, sim, *, schedule, next_batch, lr, policy=None,
                 engine: str = "loop", chunk: int = 32, delays=None,
                 staleness_decay: float = 0.8, buffer_k: int = 0,
                 ckpt_dir: str | None = None, publish_every: int = 0,
                 keep: int = 3, metadata: dict | None = None, tracer=None):
        if engine not in ENGINES:
            raise ValueError(f"unknown engine {engine!r} (known: {ENGINES})")
        self.sim = sim
        self.schedule = schedule
        self.next_batch = next_batch
        self.lr = lr
        self.policy = policy
        self.engine_name = engine
        self.ckpt_dir = ckpt_dir
        self.publish_every = publish_every
        self.keep = keep
        self.metadata = metadata or {}
        if engine == "scan":
            self._engine = EpochScanEngine(sim, chunk=chunk, tracer=tracer)
        elif engine == "pipelined":
            self._engine = PipelinedScanEngine(sim, chunk=chunk, tracer=tracer)
        elif engine == "async":
            self._engine = AsyncRoundEngine(
                sim, delays=delays, staleness_decay=staleness_decay,
                buffer_k=buffer_k, tracer=tracer,
            )
        else:
            self._engine = None
        self._started = False
        self.params = None
        self.server_state = None
        self.generator = None
        self.round = 0

    # ------------------------------------------------------------ lifecycle

    def init(self, params, generator: torch.Generator) -> None:
        """Fresh training state at round 0; ``generator`` draws τ (on the
        simulator's device)."""
        self.params = params
        self.server_state = self.sim.init_server_state(params)
        self.generator = generator
        self.round = 0
        self._started = False

    def restore_latest(self) -> bool:
        """Reload the newest published snapshot (params, server state, τ
        generator, round counter).  Call :meth:`init` first — the restore
        validates against the initialized structures.  Returns False when
        no snapshot exists.  The stream is *not* rewound: follow up with
        :meth:`advance_stream` to replay schedule/policy/batches."""
        if self.params is None:
            raise RuntimeError("call init() before restore_latest()")
        if self.ckpt_dir is None:
            return False
        path = checkpoint.latest_checkpoint(self.ckpt_dir)
        if path is None:
            return False
        params, server_state, generator, rnd = checkpoint.restore_training_state(
            path, params_like=self.params,
            server_state_like=self.server_state,
        )
        self.params, self.server_state = params, server_state
        self.generator, self.round = generator, rnd
        self._started = False
        return True

    def advance_stream(self, rounds: int | None = None) -> None:
        """Replay ``rounds`` (default: the restored round counter) through
        the schedule, policy and batch stream without training — the
        deterministic fast-forward that aligns a seed-rebuilt stream with a
        restored state."""
        for state in self.schedule.rounds(self.round if rounds is None else rounds):
            if self.policy is not None:
                self.policy.relay_matrix(state)
            self.next_batch()

    # -------------------------------------------------------------- running

    def run(self, rounds: int, *, on_publish=None, stop=None) -> dict:
        """Run ``rounds`` more rounds in publish-sized bursts.  Returns the
        per-round metrics (host numpy, concatenated over bursts).
        ``on_publish(path, round)`` fires after each snapshot; ``stop()`` is
        polled between bursts (True ⇒ return early, after a final
        publish)."""
        if self.params is None:
            raise RuntimeError("call init() (and optionally restore) first")
        burst = self.publish_every if self.publish_every > 0 else rounds
        collected: list[dict] = []
        remaining = rounds
        while remaining > 0:
            n = min(burst, remaining)
            metrics = self._run_burst(n)
            collected.append({k: v.cpu().numpy() for k, v in metrics.items()})
            remaining -= n
            self.round += n
            if self.publish_every > 0:
                self._publish(on_publish)
            if stop is not None and stop():
                break
        if self.publish_every == 0 and self.ckpt_dir is not None:
            self._publish(on_publish)
        if not collected:
            return {}
        return {
            k: np.concatenate([c[k] for c in collected])
            for k in collected[0]
        }

    def _run_burst(self, rounds: int) -> dict:
        kw = dict(schedule=self.schedule, rounds=rounds, next_batch=self.next_batch,
                  lr=self.lr, policy=self.policy)
        if self.engine_name == "loop":
            out = run_rounds_loop(
                self.sim, self.generator, self.params, self.server_state, **kw)
        elif self.engine_name == "async":
            out = self._engine.run_schedule(
                self.generator, self.params, self.server_state,
                reset=not self._started, **kw)
        else:
            out = self._engine.run_schedule(
                self.generator, self.params, self.server_state, **kw)
        self.params, self.server_state, metrics, self.generator = out
        self._started = True
        return metrics

    def _publish(self, on_publish) -> None:
        if self.ckpt_dir is None:
            return
        path = checkpoint.publish(
            self.ckpt_dir, params=self.params, server_state=self.server_state,
            generator=self.generator, round=self.round, keep=self.keep,
            metadata=dict(self.metadata, engine=self.engine_name),
        )
        if on_publish is not None:
            on_publish(path, self.round)


# --------------------------------------------------------- channel helpers


def build_topology(name: str, n: int, k: int) -> np.ndarray:
    if name == "ring":
        return topology.ring(n, k)
    if name == "fct":
        return topology.fully_connected(n)
    if name == "disconnected":
        return topology.disconnected(n)
    if name == "clusters":
        return topology.clusters(n, max(1, n // 4))
    raise ValueError(name)


def build_connectivity(profile: str, n: int, p_hom: float):
    if profile == "homogeneous":
        return connectivity.homogeneous(n, p_hom)
    if profile == "paper" and n == 10:
        return connectivity.paper_heterogeneous()
    return connectivity.heterogeneous_profile(n)


# ------------------------------------------------------------------ the CLI


def main(argv=None) -> None:
    from repro_torch import channels
    from repro_torch.channels.delay import make_delays
    from repro_torch.configs import registry as creg
    from repro_torch.core import opt_alpha
    from repro_torch.core.aggregation import ServerOpt
    from repro_torch.data.loader import FederatedLoader
    from repro_torch.data.partition import iid_partition, sort_and_partition
    from repro_torch.data.synthetic import lm_tokens
    from repro_torch.fl.simulator import FLSimulator
    from repro_torch.models import registry as mreg
    from repro_torch.optim.sgd import ClientOpt
    from repro_torch.utils import resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-14b", choices=sorted(creg.ARCHS))
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--rounds", type=int, default=50,
                    help="0 = stream indefinitely (Ctrl-C to stop)")
    ap.add_argument("--clients", type=int, default=10)
    ap.add_argument("--local-steps", type=int, default=4)
    ap.add_argument("--local-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--strategy", default="colrel_fused",
                    choices=["colrel_fused", "fedavg_blind", "no_dropout"])
    ap.add_argument("--engine", default="loop", choices=list(ENGINES))
    ap.add_argument("--chunk", type=int, default=32)
    ap.add_argument("--delay", default="none",
                    choices=["none", "poisson", "geometric"])
    ap.add_argument("--delay-rate", type=float, default=1.0)
    ap.add_argument("--delay-max", type=int, default=8)
    ap.add_argument("--staleness-decay", type=float, default=0.8)
    ap.add_argument("--buffer-k", type=int, default=0)
    ap.add_argument("--topology", default="ring")
    ap.add_argument("--topology-k", type=int, default=1)
    ap.add_argument("--p-profile", default="heterogeneous",
                    choices=["homogeneous", "heterogeneous", "paper"])
    ap.add_argument("--p", type=float, default=0.2, help="homogeneous p")
    ap.add_argument("--non-iid", action="store_true")
    ap.add_argument("--server-momentum", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--publish-every", type=int, default=0)
    ap.add_argument("--keep", type=int, default=3)
    ap.add_argument("--resume", action="store_true",
                    help="restore the newest snapshot in --ckpt-dir")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None, help="default: the GPU")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    n = args.clients
    cfg = creg.get_config(args.arch, reduced=args.reduced)
    if cfg.family == "resnet":
        raise SystemExit("use benchmarks/fig*.py for the resnet paper runs")
    md = mreg.get_model(cfg)

    conn = build_connectivity(args.p_profile, n, args.p)
    adj = build_topology(args.topology, n, args.topology_k)
    res = opt_alpha.optimize(conn.p, adj, sweeps=50)
    print(f"OPT-α: S {res.S_history[0]:.3f} -> {res.S_history[-1]:.3f} "
          f"({res.sweeps} sweeps, feasible={res.feasible_columns.all()})")

    ds = lm_tokens(4096, args.seq_len, vocab=cfg.vocab, seed=args.seed)
    parts = (sort_and_partition(ds, n, seed=args.seed) if args.non_iid
             else iid_partition(ds, n, seed=args.seed))
    loader = FederatedLoader(ds, parts, seed=args.seed)

    sim = FLSimulator(
        md.loss, n_clients=n, strategy=args.strategy, A=res.A, p=conn.p,
        local_steps=args.local_steps,
        client_opt=ClientOpt(kind="sgd", weight_decay=1e-4),
        server_opt=ServerOpt(momentum=args.server_momentum),
        device=device,
    )
    trainer = ContinuousTrainer(
        sim,
        schedule=channels.StaticChannel(adj, conn.p),
        next_batch=lambda: loader.round_batch(
            args.local_steps, args.local_batch, lm=True
        ),
        lr=args.lr,
        engine=args.engine,
        chunk=args.chunk,
        delays=make_delays(args.delay, n, rate=args.delay_rate,
                           max_delay=args.delay_max, seed=args.seed + 11),
        staleness_decay=args.staleness_decay,
        buffer_k=args.buffer_k,
        ckpt_dir=args.ckpt_dir or None,
        publish_every=args.publish_every,
        keep=args.keep,
        metadata={"arch": args.arch, "strategy": args.strategy},
    )
    trainer.init(md.init(args.seed, device=device),
                 torch.Generator(device=device).manual_seed(args.seed + 1))
    if args.resume and trainer.restore_latest():
        print(f"resumed from round {trainer.round}; replaying the stream")
        trainer.advance_stream()

    t0 = time.time()

    def log_burst(metrics, base_round):
        losses = np.asarray(metrics["loss"])
        for i, loss in enumerate(losses):
            r = base_round + i
            if r % args.log_every == 0 or i == len(losses) - 1:
                print(f"round {r:4d} loss={float(loss):.4f} "
                      f"({time.time()-t0:.1f}s)")

    def on_publish(path, rnd):
        print(f"published {path} @ round {rnd}")

    try:
        if args.rounds > 0:
            base = trainer.round
            metrics = trainer.run(args.rounds, on_publish=on_publish)
            log_burst(metrics, base)
        else:
            burst = args.publish_every or args.log_every
            while True:
                base = trainer.round
                metrics = trainer.run(burst, on_publish=on_publish)
                log_burst(metrics, base)
    except KeyboardInterrupt:
        print(f"interrupted at round {trainer.round}")


if __name__ == "__main__":
    main()
