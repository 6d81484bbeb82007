"""whisper-tiny [audio]: 4L d_model=384 6H (kv=6) d_ff=1536 vocab=51865 —
encoder-decoder; mel+conv frontend is a stub (precomputed frame embeddings).
vocab padded 51865 -> 51968 for 16-way tensor parallelism (DESIGN.md §8).
[arXiv:2212.04356]"""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="audio",
    n_layers=4, d_model=384, n_heads=6, n_kv=6, d_ff=1536, vocab=51968,
    head_dim=64, act="gelu", mlp_gated=False,
    enc_dec=True, n_enc_layers=4, enc_frames=1500,
    source="arXiv:2212.04356",
)

def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, n_enc_layers=2, d_model=128, n_heads=2, n_kv=2,
        head_dim=64, d_ff=256, vocab=512, enc_frames=64)
