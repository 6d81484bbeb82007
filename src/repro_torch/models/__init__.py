"""Model zoo: functional architectures over parameter dicts (dense GQA, MoE,
Mamba-1, RG-LRU hybrid, encoder-decoder audio, VLM cross-attention,
ResNet-20/GN)."""
from repro_torch.models.registry import ModelDef, get_model, input_specs

__all__ = ["ModelDef", "get_model", "input_specs"]
