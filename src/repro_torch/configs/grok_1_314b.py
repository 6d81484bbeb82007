"""grok-1-314b [moe]: 64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072,
MoE 8 experts top-2.  [hf:xai-org/grok-1]"""
import dataclasses
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv=8, d_ff=32768, vocab=131072,
    head_dim=128,
    moe=MoEConfig(n_experts=8, top_k=2),
    source="hf:xai-org/grok-1",
)

def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=256, n_heads=4, n_kv=2, head_dim=64,
        d_ff=512, vocab=512, moe=MoEConfig(n_experts=4, top_k=2))
