"""Config dataclasses for models, the FL protocol, sharding and a run.

The JAX package's ``ModelConfig`` also describes the LM zoo (attention,
MoE, SSM), and its module holds the LM-only config classes and input
shapes; those come with the slice that ports those models.
``pdtype``/``cdtype`` are torch dtypes here.
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


@dataclasses.dataclass(frozen=True)
class FLConfig:
    """ColRel protocol configuration."""
    n_clients: int = 16
    local_steps: int = 1          # T
    topology: str = "ring"        # ring | fct | disconnected | er | clusters
    topology_k: int = 1
    p_profile: str = "heterogeneous"  # homogeneous | heterogeneous | paper
    p_homogeneous: float = 0.2
    relay_mode: str = "faithful"  # faithful | fused
    aggregation: str = "colrel"   # colrel | colrel_fused | fedavg_* | no_dropout
    server_momentum: float = 0.0
    client_lr: float = 0.1
    weight_decay: float = 1e-4
    opt_alpha_sweeps: int = 50


@dataclasses.dataclass(frozen=True)
class ShardingConfig:
    mode: str = "tp"   # "tp" (weights over model axis) | "fsdp_tp" (2-D)
    remat: bool = True


@dataclasses.dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    fl: FLConfig
    sharding: ShardingConfig
