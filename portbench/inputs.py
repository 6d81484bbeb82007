"""The inputs a run makes from its seed and hands to both the port and the
reference: the images, the client partition and the sub-seeds.

``cifar_like`` and ``iid_partition`` are frozen copies of
``src/repro_torch/data/synthetic.py::cifar_like`` and
``src/repro_torch/data/partition.py::iid_partition`` at commit c3a27a4:
the benchmark's yardstick does not move when the port's generators do.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# the sub-seeds one run draws from its --seed, in this order
SEED_NAMES = ("data", "partition", "loader", "tau", "params")


@dataclasses.dataclass(frozen=True)
class Dataset:
    """Images (N, 32, 32, 3) f32 NHWC and labels (N,) int32: what
    ``FederatedLoader`` reads (``inputs`` and ``labels``)."""

    inputs: np.ndarray
    labels: np.ndarray

    def __len__(self) -> int:
        return int(self.labels.shape[0])


def sub_seeds(seed: int) -> dict[str, int]:
    """Independent 63-bit sub-seeds of a run's ``--seed`` (any integer that
    fits 64 bits), one a use."""
    state = np.random.SeedSequence(int(seed)).generate_state(len(SEED_NAMES), np.uint64)
    return {name: int(s) >> 1 for name, s in zip(SEED_NAMES, state)}


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


def iid_partition(n_items: int, n_clients: int, *, seed: int = 0) -> list[np.ndarray]:
    """A random permutation cut into ``n_clients`` near-equal sorted parts."""
    idx = np.random.default_rng(seed).permutation(n_items)
    return [np.sort(part) for part in np.array_split(idx, n_clients)]


def make_data(data: dict, n_clients: int, seeds: dict) -> tuple[Dataset, list[np.ndarray]]:
    """A configuration's ``data`` block → (dataset, client partitions)."""
    if data["kind"] != "cifar_like" or data["partition"] != "iid":
        raise ValueError(f"unknown data {data!r} (known: cifar_like, iid)")
    ds = cifar_like(data["n_train"], n_classes=data["n_classes"], snr=data["snr"],
                    seed=seeds["data"])
    return ds, iid_partition(len(ds), n_clients, seed=seeds["partition"])
