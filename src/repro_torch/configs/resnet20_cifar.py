"""ResNet-20 / CIFAR-10 — the paper's own §V model (GroupNorm instead of
BatchNorm, as in the JAX package)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="resnet20-cifar", family="resnet",
    n_layers=20, d_model=64, vocab=10,
    source="paper §V (He et al. CIFAR ResNet-20)",
)
