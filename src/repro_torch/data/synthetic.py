"""Synthetic datasets, generated from seeds (numpy, the same streams as the
JAX package's ``data/synthetic.py``).

* ``cifar_like``: 10-class Gaussian-prototype images, CIFAR-shaped
  (32×32×3).  Linearly separable at high SNR, genuinely learnable by the
  ResNet/MLP models, and class structure makes the paper's sort-and-partition
  non-IID pathology reproducible.
* ``lm_tokens``: affine-recurrence token streams  t_{k+1} = (a·t_k + b) mod V
  with per-stream (a, b) and noise — next-token prediction is learnable and
  per-client (a, b) skew provides non-IID-ness for LM FL experiments.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class ArrayDataset:
    """In-memory dataset; leaves indexed along axis 0."""
    inputs: np.ndarray
    labels: np.ndarray

    def __len__(self) -> int:
        return int(self.labels.shape[0])


def cifar_like(
    n: int, *, n_classes: int = 10, snr: float = 2.0, seed: int = 0,
    proto_seed: int = 12345,
) -> ArrayDataset:
    """``proto_seed`` fixes the class prototypes (the *task*); ``seed`` draws
    the samples — so train/test splits share the task but not the noise."""
    protos = np.random.default_rng(proto_seed).normal(
        size=(n_classes, 32, 32, 3)).astype(np.float32)
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, size=(n,))
    noise = rng.normal(size=(n, 32, 32, 3)).astype(np.float32)
    images = snr * protos[labels] + noise
    images /= np.sqrt(1.0 + snr**2)
    return ArrayDataset(images.astype(np.float32), labels.astype(np.int32))


def gaussian_classification(
    n: int, *, dim: int = 64, n_classes: int = 10, snr: float = 2.0, seed: int = 0,
    proto_seed: int = 12345,
) -> ArrayDataset:
    """Flat-feature variant for MLP / logistic-regression experiments."""
    protos = np.random.default_rng(proto_seed).normal(
        size=(n_classes, dim)).astype(np.float32)
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, size=(n,))
    x = snr * protos[labels] + rng.normal(size=(n, dim)).astype(np.float32)
    x /= np.sqrt(1.0 + snr**2)
    return ArrayDataset(x.astype(np.float32), labels.astype(np.int32))


def lm_tokens(
    n_seqs: int, seq_len: int, *, vocab: int = 512, n_streams: int = 8,
    noise: float = 0.05, seed: int = 0
) -> ArrayDataset:
    """Token sequences; labels are next tokens (shift by one).

    ``labels[i] = stream id`` so the same partition machinery (IID vs
    sort-and-partition) applies to LM data as to classification data.
    """
    rng = np.random.default_rng(seed)
    a = rng.integers(1, vocab - 1, size=(n_streams,)) | 1  # odd → full cycle-ish
    b = rng.integers(0, vocab, size=(n_streams,))
    stream = rng.integers(0, n_streams, size=(n_seqs,))
    toks = np.empty((n_seqs, seq_len + 1), dtype=np.int32)
    toks[:, 0] = rng.integers(0, vocab, size=(n_seqs,))
    for k in range(seq_len):
        nxt = (a[stream] * toks[:, k] + b[stream]) % vocab
        flip = rng.random(n_seqs) < noise
        nxt = np.where(flip, rng.integers(0, vocab, size=(n_seqs,)), nxt)
        toks[:, k + 1] = nxt
    return ArrayDataset(toks.astype(np.int32), stream.astype(np.int32))


def quadratic_problem(dim: int, n_clients: int, *, hetero: float = 1.0, seed: int = 0):
    """Strongly-convex quadratic ERM where Thm. 1 assumptions hold exactly.

    Client i's loss:  f_i(x) = 0.5 (x - c_i)ᵀ H (x - c_i),  H ≻ 0 shared.
    Global optimum x* = mean(c_i).  Returns (H, centers, x_star).
    """
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(dim, dim)))
    eig = np.linspace(1.0, 10.0, dim)  # μ = 1, L = 10
    H = (q * eig) @ q.T
    centers = hetero * rng.normal(size=(n_clients, dim))
    return H.astype(np.float32), centers.astype(np.float32), centers.mean(0).astype(np.float32)
