"""falcon-mamba-7b [ssm]: 64L d_model=4096 (attention-free) vocab=65024,
ssm_state=16 — mamba-1 architecture.  [arXiv:2410.05355]"""
import dataclasses
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, d_ff=0, vocab=65024,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    source="arXiv:2410.05355",
)

def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=256, vocab=512,
        ssm=SSMConfig(d_state=8, d_conv=4, expand=2))
