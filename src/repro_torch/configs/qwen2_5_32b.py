"""qwen2.5-32b [dense]: 64L d_model=5120 40H (GQA kv=8) d_ff=27648
vocab=152064 — GQA, QKV bias.  [hf:Qwen/Qwen2.5-0.5B]"""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv=8, d_ff=27648, vocab=152064,
    head_dim=128, qkv_bias=True, rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen2.5-0.5B",
)

def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=256, n_heads=4, n_kv=2, head_dim=64,
        d_ff=512, vocab=512)
