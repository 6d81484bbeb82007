"""The inputs a run makes from its seed and hands to both the port and the
reference: the dataset, the client partition and the sub-seeds.

A configuration's ``data.kind`` names the module that makes its dataset,
``data/<kind>.py`` (``make`` and ``LM``), found by name.  ``iid_partition``
is a frozen copy of ``src/repro_torch/data/partition.py::iid_partition``
at commit c3a27a4: the benchmark's yardstick does not move when the port's
generators do.
"""
from __future__ import annotations

import dataclasses
import importlib

import numpy as np

# the sub-seeds one run draws from its --seed, in this order
SEED_NAMES = ("data", "partition", "loader", "tau", "params")


@dataclasses.dataclass(frozen=True)
class Dataset:
    """Inputs (N, ...) and labels (N,) int32, what ``FederatedLoader``
    reads: f32 NHWC images and their classes, or (N, seq + 1) int32 token
    sequences and their stream ids."""

    inputs: np.ndarray
    labels: np.ndarray

    def __len__(self) -> int:
        return int(self.labels.shape[0])


def sub_seeds(seed: int) -> dict[str, int]:
    """Independent 63-bit sub-seeds of a run's ``--seed`` (any integer that
    fits 64 bits), one a use."""
    state = np.random.SeedSequence(int(seed)).generate_state(len(SEED_NAMES), np.uint64)
    return {name: int(s) >> 1 for name, s in zip(SEED_NAMES, state)}


def iid_partition(n_items: int, n_clients: int, *, seed: int = 0) -> list[np.ndarray]:
    """A random permutation cut into ``n_clients`` near-equal sorted parts."""
    idx = np.random.default_rng(seed).permutation(n_items)
    return [np.sort(part) for part in np.array_split(idx, n_clients)]


def data_kind(data: dict):
    """The module of a configuration's ``data`` block's kind."""
    return importlib.import_module(f"portbench.data.{data['kind']}")


def make_data(data: dict, n_clients: int, seeds: dict) -> tuple[Dataset, list[np.ndarray]]:
    """A configuration's ``data`` block → (dataset, client partitions)."""
    return data_kind(data).make(data, n_clients, seeds)
