"""Model configuration: the fields the ported models read.

The JAX package's ``ModelConfig`` also describes the LM zoo (attention,
MoE, SSM, sharding); those fields come with the slices that port those
models.  ``pdtype``/``cdtype`` are torch dtypes here.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # resnet (the LM families come later)
    n_layers: int
    d_model: int
    vocab: int = 0
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    source: str = ""

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)
