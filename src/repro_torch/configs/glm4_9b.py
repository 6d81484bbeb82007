"""glm4-9b [dense]: 40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552 —
RoPE (partial rotary 0.5), GQA.  [hf:THUDM/glm-4-9b]"""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv=2, d_ff=13696, vocab=151552,
    head_dim=128, rotary_pct=0.5,
    source="hf:THUDM/glm-4-9b",
)

def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=256, n_heads=4, n_kv=2, head_dim=64,
        d_ff=512, vocab=512)
