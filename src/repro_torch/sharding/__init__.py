"""Sharding rules of the distributed round step."""
from repro_torch.sharding import rules

__all__ = ["rules"]
