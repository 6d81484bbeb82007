"""Serving launcher: batched prefill + decode over the model zoo, plus a
snapshot-watching eval loop for the continuous-training service.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch glm4-9b --reduced \
        --batch 4 --prompt-len 64 --new-tokens 16 [--device cpu]

    # live eval against a training run publishing into checkpoints/
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b --reduced \
        --watch checkpoints --max-polls 30

One-shot mode loads (or random-inits) a model, prefills the prompt batch,
then greedy-decodes with the KV cache / SSM state machinery.  It runs on
the GPU unless ``--device cpu`` is given.

Watch mode (:class:`SnapshotEvalLoop`) polls the ``LATEST`` pointer the
trainer rotates (``repro_torch.checkpoint.publish``); whenever it names a
new snapshot the loop reloads just the params (the server-optimizer state
and the generator in the snapshot are ignored — eval only needs the model)
and runs the eval function against a fixed held-out batch, giving a live
loss-vs-round readout of the run in progress.  It reads only ``params/…``
and the sidecar's ``round``, so it follows the JAX package's snapshots as
well.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import checkpoint
from repro_torch.utils import resolve_device, tree_flatten, tree_map


class SnapshotEvalLoop:
    """Poll a checkpoint directory's ``LATEST`` pointer and evaluate each
    new snapshot.

    ``params_like`` gives the pytree structure, device and dtypes to restore
    into (eval-only: extra snapshot entries like the server state are
    ignored).  ``eval_fn`` maps ``(params, batch) -> scalar loss``; the
    batch's numpy leaves go to the params' device first.  :meth:`poll`
    reloads iff the pointer changed and returns True on reload;
    :meth:`eval_batch` scores a batch against the currently-loaded params;
    :meth:`watch` packages the poll/eval/sleep cycle.
    """

    def __init__(self, ckpt_dir: str, *, params_like, eval_fn=None):
        self.ckpt_dir = ckpt_dir
        self.params_like = params_like
        self.eval_fn = eval_fn
        self.params = None
        self.round: int | None = None
        self._seen: str | None = None

    def poll(self) -> bool:
        """Reload params iff the ``LATEST`` pointer names a new snapshot."""
        path = checkpoint.latest_checkpoint(self.ckpt_dir)
        if path is None or path == self._seen:
            return False
        self.params = checkpoint.restore(
            path, {"params": self.params_like}
        )["params"]
        self.round = int(checkpoint.load_metadata(path).get("round", -1))
        self._seen = path
        return True

    def eval_batch(self, batch) -> float:
        if self.params is None:
            raise RuntimeError("no snapshot loaded yet — poll() first")
        if self.eval_fn is None:
            raise RuntimeError("no eval_fn configured")
        device = tree_flatten(self.params)[0][0].device
        batch = tree_map(lambda x: torch.as_tensor(x, device=device), batch)
        return float(self.eval_fn(self.params, batch))

    def watch(self, batch, *, max_polls: int, interval: float = 2.0,
              on_eval=None, sleep=time.sleep) -> list[tuple[int, float]]:
        """Run up to ``max_polls`` poll cycles, evaluating on each new
        snapshot.  Returns the ``(round, loss)`` history.  ``sleep`` is
        injectable so tests can run the loop without waiting."""
        history: list[tuple[int, float]] = []
        for i in range(max_polls):
            if self.poll():
                loss = self.eval_batch(batch)
                history.append((self.round, loss))
                if on_eval is not None:
                    on_eval(self.round, loss)
            if i + 1 < max_polls:
                sleep(interval)
        return history


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _DecodeGraph:
    """``md.decode`` captured as one CUDA graph: the port's counterpart of
    the JAX package's ``jax.jit(md.decode)``.  An eager decode step is
    thousands of small launches from one thread (3,613 for glm4-9b), so the
    host, not the card, sets its pace; a replay launches them all at once.

    The graph reads the cache and the tokens from static buffers: a call
    copies them in and replays.  It returns the logits as a new tensor and
    the cache as the graph's static output, which the next call overwrites
    (feed it back, as a decode loop does, and keep nothing else of it)."""

    def __init__(self, md, params, cache, toks):
        self.cache = tree_map(torch.clone, cache)
        self.toks = toks.clone()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # warm-up outside the capture
            md.decode(params, self.cache, self.toks)
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = md.decode(params, self.cache, self.toks)

    def __call__(self, cache, toks):
        tree_map(lambda dst, src: dst.copy_(src), self.cache, cache)
        self.toks.copy_(toks)
        self.graph.replay()
        logits, new_cache = self.out
        return logits.clone(), new_cache


def _decode_demo(md, cfg, params, args) -> dict:
    """Prefill a random prompt batch, then greedy-decode ``args.new_tokens``
    tokens (the first from the prefill's logits).  Runs where ``params``
    live; on the GPU the decode step is captured once as a CUDA graph
    (:class:`_DecodeGraph`, timed apart as ``capture_s``).  Prints the times
    and returns them with the prompt batch, the generated tokens and each
    decode step's logits."""
    B, S = args.batch, args.prompt_len
    device = tree_flatten(params)[0][0].device
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=gen, device=device,
                                     dtype=torch.int32)}
    if cfg.family == "audio":
        batch["frame_embeds"] = torch.randn((B, cfg.enc_frames, cfg.d_model), generator=gen,
                                            device=device)
    if cfg.family == "vlm":
        batch["img_embeds"] = torch.randn((B, cfg.n_image_tokens, cfg.d_model),
                                          generator=gen, device=device)

    with torch.no_grad():
        _sync(device)
        t0 = time.perf_counter()
        logits, cache = md.prefill(params, batch)
        _sync(device)
        t1 = time.perf_counter()
        toks = torch.argmax(logits[:, -1], dim=-1)[:, None]
        graphed = device.type == "cuda" and args.new_tokens > 1
        if graphed:
            decode = _DecodeGraph(md, params, cache, toks)
        else:
            decode = lambda c, t: md.decode(params, c, t)  # noqa: E731
        _sync(device)
        t2 = time.perf_counter()
        outs, step_logits = [toks], []
        for _ in range(args.new_tokens - 1):
            logits, cache = decode(cache, toks)
            step_logits.append(logits)
            toks = torch.argmax(logits[:, -1], dim=-1)[:, None]
            outs.append(toks)
        _sync(device)
        t3 = time.perf_counter()
    gen_tokens = torch.cat(outs, dim=1).cpu().numpy()
    print(f"prefill: {B}x{S} in {t1-t0:.2f}s; "
          f"decode: {args.new_tokens} tokens in {t3-t2:.2f}s "
          f"({B*args.new_tokens/(t3-t2):.1f} tok/s batch-aggregate"
          + (f"; decode step captured in {t2-t1:.2f}s)" if graphed else ")"))
    for b in range(min(B, 4)):
        print(f"  request {b}: {gen_tokens[b].tolist()}")
    return {"batch": batch, "generated": gen_tokens, "decode_logits": step_logits,
            "prefill_s": t1 - t0, "capture_s": t2 - t1, "decode_s": t3 - t2}


def main(argv=None) -> None:
    from repro_torch.configs import registry as creg
    from repro_torch.models import registry as mreg

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="glm4-9b", choices=sorted(creg.ARCHS))
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--restore", default="")
    ap.add_argument("--watch", default="",
                    help="checkpoint dir to poll for new snapshots")
    ap.add_argument("--max-polls", type=int, default=30)
    ap.add_argument("--poll-interval", type=float, default=2.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: the GPU")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = creg.get_config(args.arch, reduced=args.reduced)
    if cfg.family == "resnet":
        raise SystemExit("resnet20 is a classifier; nothing to decode")
    md = mreg.get_model(cfg)
    params = md.init(args.seed, device=device)

    if args.watch:
        gen = torch.Generator(device=device).manual_seed(args.seed + 1)
        # same split the training loader uses: draw seq+1 tokens, labels
        # are the next-token shift (md.loss needs both keys)
        toks = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len + 1), generator=gen,
                             device=device, dtype=torch.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        loop = SnapshotEvalLoop(args.watch, params_like=params, eval_fn=md.loss)
        print(f"watching {args.watch} ({args.max_polls} polls, "
              f"{args.poll_interval}s apart)")
        loop.watch(
            batch, max_polls=args.max_polls, interval=args.poll_interval,
            on_eval=lambda rnd, loss: print(
                f"round {rnd:4d} eval_loss={loss:.4f}"),
        )
        return

    if args.restore:
        with np.load(args.restore) as z:
            # publish() snapshots namespace model leaves under params/
            # (alongside the generator state + optional server state);
            # bare trees from checkpoint.save() have no prefix
            nested = any(k.startswith("params/") for k in z.keys())
        if nested:
            params = checkpoint.restore(args.restore, {"params": params})["params"]
        else:
            params = checkpoint.restore(args.restore, params)
    _decode_demo(md, cfg, params, args)


if __name__ == "__main__":
    main()
