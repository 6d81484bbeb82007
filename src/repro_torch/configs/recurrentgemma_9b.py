"""recurrentgemma-9b [hybrid]: 38L d_model=4096 16H (MQA kv=1) d_ff=12288
vocab=256000 — RG-LRU + local attention, 1 attn : 2 recurrent.  [arXiv:2402.19427]"""
import dataclasses
from repro_torch.configs.base import ModelConfig, RGLRUConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv=1, d_ff=12288, vocab=256000,
    head_dim=256, act="gelu",
    rglru=RGLRUConfig(lru_width=4096, conv_width=4,
                      block_pattern=("recurrent", "recurrent", "attention"),
                      local_window=2048),
    source="arXiv:2402.19427",
)

def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=256, n_heads=4, n_kv=1, head_dim=64,
        d_ff=512, vocab=512,
        rglru=RGLRUConfig(lru_width=256, local_window=64))
