"""Snapshot-watching eval loop for the continuous-training service.

:class:`SnapshotEvalLoop` polls the ``LATEST`` pointer the trainer rotates
(``repro_torch.checkpoint.publish``); whenever it names a new snapshot the
loop reloads just the params (the server-optimizer state and the generator
in the snapshot are ignored — eval only needs the model) and runs the eval
function against a fixed held-out batch, giving a live loss-vs-round readout
of the run in progress.  It reads only ``params/…`` and the sidecar's
``round``, so it follows the JAX package's snapshots as well.

The JAX package's serving command line (batched prefill + decode over its
LM model zoo) comes with the slice that ports that zoo.
"""
from __future__ import annotations

import time

import torch

from repro_torch import checkpoint
from repro_torch.utils import tree_flatten, tree_map


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
