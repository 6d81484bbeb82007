"""Federated data: synthetic datasets, partitions, the federated loader."""
from repro_torch.data import loader, partition, synthetic

__all__ = ["loader", "partition", "synthetic"]
