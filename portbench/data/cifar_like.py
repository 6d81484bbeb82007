"""Synthetic CIFAR-shaped images: 10-class Gaussian prototypes, IID over
the clients.

``cifar_like`` is a frozen copy of
``src/repro_torch/data/synthetic.py::cifar_like`` at commit c3a27a4: the
benchmark's yardstick does not move when the port's generators do.
"""
from __future__ import annotations

import numpy as np

from portbench.inputs import Dataset, iid_partition

LM = False


def cifar_like(n: int, *, n_classes: int = 10, snr: float = 2.0, seed: int = 0,
               proto_seed: int = 12345) -> Dataset:
    """10-class Gaussian-prototype images, CIFAR-shaped (32×32×3):
    ``proto_seed`` fixes the class prototypes, ``seed`` draws the samples."""
    protos = np.random.default_rng(proto_seed).normal(
        size=(n_classes, 32, 32, 3)).astype(np.float32)
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, size=(n,))
    noise = rng.normal(size=(n, 32, 32, 3)).astype(np.float32)
    images = snr * protos[labels] + noise
    images /= np.sqrt(1.0 + snr**2)
    return Dataset(images.astype(np.float32), labels.astype(np.int32))


def make(data: dict, n_clients: int, seeds: dict):
    """``n_train`` images (``n_classes``, ``snr``) and an IID partition."""
    if data["partition"] != "iid":
        raise ValueError(f"cifar_like: unknown partition {data['partition']!r} (known: iid)")
    ds = cifar_like(data["n_train"], n_classes=data["n_classes"], snr=data["snr"],
                    seed=seeds["data"])
    return ds, iid_partition(len(ds), n_clients, seed=seeds["partition"])
