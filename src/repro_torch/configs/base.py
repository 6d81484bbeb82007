"""Config dataclasses for models, FL protocol, sharding and input shapes.

The fields, defaults and formulas are the JAX package's; ``pdtype`` and
``cdtype`` are torch dtypes here.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 → ceil(d_model / 16)


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    lru_width: int = 0       # 0 → d_model
    conv_width: int = 4
    block_pattern: Sequence[str] = ("recurrent", "recurrent", "attention")
    local_window: int = 2048


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | audio | vlm | resnet
    n_layers: int
    d_model: int
    n_heads: int = 0
    n_kv: int = 0
    d_ff: int = 0
    vocab: int = 0
    head_dim: int = 0             # 0 → d_model // n_heads
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    rotary_pct: float = 1.0       # glm4 uses partial rotary (0.5)
    sliding_window: int = 0       # 0 → full attention
    long_context_window: int = 8192   # SWA window used for the long_500k variant
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    act: str = "silu"             # mlp activation; "gelu" for whisper
    mlp_gated: bool = True        # SwiGLU vs plain 2-layer MLP
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    # encoder-decoder (whisper)
    enc_dec: bool = False
    n_enc_layers: int = 0
    enc_frames: int = 1500        # stub audio frontend output length for serve shapes
    # vlm
    cross_attn_every: int = 0     # >0 → cross-attn block every k-th layer
    n_image_tokens: int = 1600    # stub vision frontend output length
    # dtypes
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    # citation for the assigned-architecture pool
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads if self.n_heads else 0)

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def param_count(self) -> int:
        """Analytic total parameter count N (embeddings included)."""
        d, f, L, V = self.d_model, self.d_ff, self.n_layers, self.vocab
        if self.family == "resnet":
            return 272_474  # resnet-20 CIFAR (analytic, GN variant)
        emb = V * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":
            di = self.ssm.expand * d
            dtr = self.ssm.dt_rank or -(-d // 16)
            per = (d * 2 * di + di * self.ssm.d_conv
                   + di * (dtr + 2 * self.ssm.d_state) + dtr * di
                   + di * self.ssm.d_state + di + di * d + d)
            return L * per + emb + d
        hd = self.hd
        attn = d * self.n_heads * hd + 2 * d * self.n_kv * hd + self.n_heads * hd * d
        mlp = d * f * (3 if self.mlp_gated else 2)
        if self.family == "moe":
            mlp = self.moe.n_experts * mlp + d * self.moe.n_experts
        per = attn + mlp + 2 * d
        total = L * per + emb + d
        # hybrid: recurrent blocks replace attention in 2/3 of layers; the
        # attention estimate stands in for them (the exact count comes from
        # the parameter tree)
        if self.enc_dec:
            total += self.n_enc_layers * per
        if self.cross_attn_every:
            n_cross = self.n_layers // self.cross_attn_every
            total += n_cross * (attn + 2 * d)
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if self.family != "moe":
            return self.param_count()
        d, f, L, V = self.d_model, self.d_ff, self.n_layers, self.vocab
        hd = self.hd
        attn = d * self.n_heads * hd + 2 * d * self.n_kv * hd + self.n_heads * hd * d
        mlp_active = self.moe.top_k * d * f * (3 if self.mlp_gated else 2)
        per = attn + mlp_active + 2 * d
        emb = V * d * (1 if self.tie_embeddings else 2)
        return L * per + emb + d


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


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
