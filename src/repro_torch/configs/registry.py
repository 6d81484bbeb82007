"""Architecture registry: --arch <id> resolution for launchers and tests."""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import ModelConfig, ShapeConfig

ARCHS = {
    "qwen3-14b": "qwen3_14b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "mixtral-8x22b": "mixtral_8x22b",
    "qwen2.5-32b": "qwen2_5_32b",
    "whisper-tiny": "whisper_tiny",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "grok-1-314b": "grok_1_314b",
    "qwen1.5-32b": "qwen1_5_32b",
    "glm4-9b": "glm4_9b",
    "llama-3.2-vision-11b": "llama_3_2_vision_11b",
    "resnet20-cifar": "resnet20_cifar",
}

ASSIGNED = [a for a in ARCHS if a != "resnet20-cifar"]


def _module(arch: str):
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")


def get_config(arch: str, *, reduced: bool = False) -> ModelConfig:
    mod = _module(arch)
    return mod.reduced() if reduced else mod.CONFIG


def for_shape(cfg: ModelConfig, shape: ShapeConfig) -> ModelConfig:
    """Resolve the shape-dependent attention variant.

    long_500k on full-attention archs uses the sliding-window variant
    (window = cfg.long_context_window) so the KV cache stays bounded —
    DESIGN.md §5.  Whisper (enc-dec) skips long_500k entirely.
    """
    if shape.name == "long_500k" and cfg.family in ("dense", "moe", "vlm"):
        if not cfg.sliding_window:
            return dataclasses.replace(cfg, sliding_window=cfg.long_context_window)
    return cfg


def is_skipped(arch: str, shape_name: str) -> str | None:
    """Return a reason string if this (arch, shape) pair is skipped."""
    cfg = get_config(arch)
    if shape_name == "long_500k" and cfg.family == "audio":
        return "enc-dec full-attention decoder: 500k-token decode out of family (DESIGN.md §5)"
    return None
