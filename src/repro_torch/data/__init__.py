"""Federated data: synthetic datasets, partitions, the federated loader."""
