"""Client data partitioning: IID and the paper's sort-and-partition non-IID.

Paper §V: "the training data is initially sorted based on labels, and then
divided into blocks and distributed among clients in a skewed fashion so that
each client has data from only a few classes."
"""
from __future__ import annotations

import numpy as np

from repro_torch.data.synthetic import ArrayDataset


def iid_partition(ds: ArrayDataset, n_clients: int, *, seed: int = 0) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(ds))
    return [np.sort(part) for part in np.array_split(idx, n_clients)]


def sort_and_partition(
    ds: ArrayDataset, n_clients: int, *, shards_per_client: int = 2, seed: int = 0
) -> list[np.ndarray]:
    """Sort by label, cut into n_clients·shards_per_client blocks, deal
    `shards_per_client` random blocks to each client."""
    rng = np.random.default_rng(seed)
    order = np.argsort(ds.labels, kind="stable")
    n_shards = n_clients * shards_per_client
    shards = np.array_split(order, n_shards)
    perm = rng.permutation(n_shards)
    return [
        np.sort(np.concatenate([shards[perm[i * shards_per_client + j]]
                                for j in range(shards_per_client)]))
        for i in range(n_clients)
    ]


def client_label_histogram(ds: ArrayDataset, parts: list[np.ndarray], n_classes: int):
    return np.stack(
        [np.bincount(ds.labels[p], minlength=n_classes) for p in parts]
    )
