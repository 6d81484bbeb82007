"""qwen1.5-32b [dense]: 64L d_model=5120 40H (MHA kv=40) d_ff=27392
vocab=152064 — QKV bias.  [hf:Qwen/Qwen1.5-0.5B]"""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv=40, d_ff=27392, vocab=152064,
    head_dim=128, qkv_bias=True,
    source="hf:Qwen/Qwen1.5-0.5B",
)

def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=256, n_heads=4, n_kv=4, head_dim=64,
        d_ff=512, vocab=512)
