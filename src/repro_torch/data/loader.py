"""Federated batch sampling: stacked per-client batches for the FL engine.

A round batch has leaves shaped (n_clients, T, local_batch, ...) — T local
steps per round, one minibatch each — matching ``fl.simulator``.  numpy, the same RNG
streams as the JAX package's ``data/loader.py``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.data.synthetic import ArrayDataset

# Below this many clients the per-client ``rng.choice`` loop is cheap and its
# RNG stream is pinned by existing trajectories/tests; at cohort-sampling
# scale (n ≳ 10³) the loop itself dominates staging, so ``round_batch``
# switches to one vectorized gather (different stream, same distribution).
VECTORIZED_MIN_CLIENTS = 256


class FederatedLoader:
    """``vectorized`` ∈ {None, True, False}: None (default) auto-enables the
    single-gather sampling path when ``n_clients >= VECTORIZED_MIN_CLIENTS``
    and every partition has equal size; True/False force it.  The vectorized
    path draws all ``n·T·b`` sample indices with one ``rng.integers`` call
    and gathers the dataset once — its RNG stream differs from the loop
    path's (one ``choice`` per client), which is why small-n defaults keep
    the historical stream."""

    def __init__(
        self,
        ds: ArrayDataset,
        parts: list[np.ndarray],
        *,
        seed: int = 0,
        vectorized: bool | None = None,
    ):
        self.ds = ds
        self.parts = parts
        self.rng = np.random.default_rng(seed)
        sizes = {len(p) for p in parts}
        equal = len(sizes) == 1
        if vectorized is None:
            vectorized = equal and len(parts) >= VECTORIZED_MIN_CLIENTS
        elif vectorized and not equal:
            raise ValueError(
                "vectorized sampling needs equal-size partitions "
                f"(got sizes {sorted(sizes)})"
            )
        self.vectorized = bool(vectorized)
        # (n, m) partition matrix: row i lists client i's dataset indices
        self._part_mat = (
            np.stack([np.asarray(p) for p in parts]) if self.vectorized else None
        )

    @property
    def n_clients(self) -> int:
        return len(self.parts)

    def round_batch(self, local_steps: int, local_batch: int, *, lm: bool = False):
        """Sample (n, T, b, ...) input/label arrays for one round."""
        n = self.n_clients
        if self.vectorized:
            mat = self._part_mat
            r = self.rng.integers(
                0, mat.shape[1], size=(n, local_steps, local_batch)
            )
            idx = np.take_along_axis(mat[:, None, :], r, axis=2)  # (n, T, b)
            x = self.ds.inputs[idx]
            y = self.ds.labels[idx]
        else:
            xs, ys = [], []
            for part in self.parts:
                idx = self.rng.choice(
                    part, size=(local_steps, local_batch), replace=True
                )
                xs.append(self.ds.inputs[idx])
                ys.append(self.ds.labels[idx])
            x = np.stack(xs)  # (n, T, b, ...)
            y = np.stack(ys)
        if lm:
            # inputs are (.., seq+1) token arrays: split into tokens/labels
            return {"tokens": x[..., :-1], "labels": x[..., 1:]}
        key = "images" if x.ndim >= 5 else "inputs"
        return {key: x, "labels": y}
