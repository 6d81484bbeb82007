"""mixtral-8x22b [moe]: 56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768,
MoE 8 experts top-2, sliding-window attention.  [arXiv:2401.04088]"""
import dataclasses
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv=8, d_ff=16384, vocab=32768,
    head_dim=128, sliding_window=4096,
    moe=MoEConfig(n_experts=8, top_k=2),
    source="arXiv:2401.04088",
)

def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=256, n_heads=4, n_kv=2, head_dim=64,
        d_ff=512, vocab=512, sliding_window=64,
        moe=MoEConfig(n_experts=4, top_k=2))
