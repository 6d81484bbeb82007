"""llama-3.2-vision-11b [vlm]: 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256 — cross-attention image layers (every 5th layer); vision encoder
is a stub (precomputed projected patch embeddings).
[hf:meta-llama/Llama-3.2-11B-Vision]"""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv=8, d_ff=14336, vocab=128256,
    head_dim=128, cross_attn_every=5, n_image_tokens=1600,
    rope_theta=500_000.0,
    source="hf:meta-llama/Llama-3.2-11B-Vision",
)

def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=10, d_model=256, n_heads=4, n_kv=2, head_dim=64,
        d_ff=512, vocab=512, cross_attn_every=5, n_image_tokens=16)
