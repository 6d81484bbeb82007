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


# --------------------------------------------------------------------------
# DeepSeek-V2 (arXiv:2405.04434): latent attention, YaRN, DeepSeekMoE.  Port
# only: the JAX package has no such model, so these are classes of their own
# and ``ModelConfig`` keeps the reference's fields.
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention without a query LoRA (§2.1.2–2.1.3): keys
    of ``qk_nope_dim`` + ``qk_rope_dim`` (the decoupled RoPE part, one key
    shared by the heads), values of ``v_head_dim``, K and V up-projected
    from a latent of ``kv_lora_rank``."""
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128

    @property
    def qk_dim(self) -> int:
        return self.qk_nope_dim + self.qk_rope_dim


@dataclasses.dataclass(frozen=True)
class YaRNConfig:
    """YaRN's RoPE scaling as DeepSeek-V2 applies it (``rope_scaling``);
    the port takes ``mscale`` equal to ``mscale_all_dim``, as DeepSeek-V2
    does (the rotated channels then keep their scale)."""
    factor: float = 40.0
    original_max_pos: int = 4096
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 0.707
    mscale_all_dim: float = 0.707


@dataclasses.dataclass(frozen=True)
class DeepSeekMoEConfig:
    """DeepSeekMoE (§2.2): ``n_routed`` experts of width ``expert_d_ff``
    behind a softmax router with greedy top-``top_k`` (no renormalization,
    scaled by ``routed_scale``), and ``n_shared`` shared experts, one SwiGLU
    of ``n_shared · expert_d_ff``.  The layer computes the routed experts
    ``[held_start, held_start + n_held)`` only (one chip's share under
    expert parallelism; ``n_held == n_routed`` is the whole layer); each
    holds ``capacity_factor · S · top_k / n_routed`` tokens a sequence and
    drops the rest by position.  ``aux_alpha`` weighs the sequence-wise
    balance loss, taken over all ``n_routed`` router outputs."""
    n_routed: int = 64
    top_k: int = 6
    expert_d_ff: int = 1408
    n_shared: int = 2
    routed_scale: float = 1.0
    n_held: int = 64
    held_start: int = 0
    capacity_factor: float = 1.25
    aux_alpha: float = 0.001


@dataclasses.dataclass(frozen=True)
class DeepSeekConfig(ModelConfig):
    """A DeepSeek-V2 stack: ``first_dense`` leading layers with a dense
    SwiGLU of ``d_ff``, then DeepSeekMoE layers; every layer MLA; an untied
    head over ``vocab``."""
    mla: MLAConfig = MLAConfig()
    yarn: YaRNConfig = YaRNConfig()
    ds_moe: DeepSeekMoEConfig = DeepSeekMoEConfig()
    first_dense: int = 1

    def _attn_params(self) -> int:
        d, m, H = self.d_model, self.mla, self.n_heads
        return (d * H * m.qk_dim + d * (m.kv_lora_rank + m.qk_rope_dim) + m.kv_lora_rank
                + m.kv_lora_rank * H * (m.qk_nope_dim + m.v_head_dim) + H * m.v_head_dim * d)

    def _ffn_params(self, routed: int) -> tuple[int, int]:
        """(dense layer's, a MoE layer's with ``routed`` routed experts)."""
        d, e = self.d_model, self.ds_moe
        expert = 3 * d * e.expert_d_ff
        return 3 * d * self.d_ff, routed * expert + e.n_shared * expert + d * e.n_routed

    def _count(self, routed: int) -> int:
        d, L = self.d_model, self.n_layers
        dense, moe = self._ffn_params(routed)
        per = self._attn_params() + 2 * d
        return (L * per + self.first_dense * dense + (L - self.first_dense) * moe
                + 2 * self.vocab * d + d)

    def param_count(self) -> int:
        """Every parameter this configuration holds: the held experts of each
        MoE layer (all of them for the published model), the router at its
        full width, the embedding and the untied head."""
        return self._count(self.ds_moe.n_held)

    def active_param_count(self) -> int:
        """Parameters a token passes through, by the port's convention for
        MoE configurations (embedding table and head both counted): top_k
        routed experts of each MoE layer, the shared experts, the router, the
        attention and the dense layer.  Without the input embedding table
        (a lookup) the published model reads 2.45·10⁹, DeepSeek's "2.4B
        activated"."""
        return self._count(self.ds_moe.top_k)


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
