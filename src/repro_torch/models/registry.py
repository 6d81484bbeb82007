"""Uniform model API over every architecture family.

``get_model(cfg)`` returns a ``ModelDef`` with init / loss / prefill /
decode / init_cache / input_specs closures; the FL engine and the serving
path consume only this interface.  ``init(seed, device=None)`` draws the
parameters on ``device`` (the GPU unless it says otherwise).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import resnet, stacks


@dataclasses.dataclass(frozen=True)
class ModelDef:
    cfg: ModelConfig
    init: Callable[..., Any]
    loss: Callable[[Any, dict], torch.Tensor]
    prefill: Optional[Callable[[Any, dict], tuple]] = None
    decode: Optional[Callable[[Any, Any, torch.Tensor], tuple]] = None
    init_cache: Optional[Callable[..., Any]] = None

    def input_specs(self, shape: ShapeConfig, *, batch_override: int = 0) -> dict:
        """``meta``-device stand-ins for one global batch of `shape`."""
        return input_specs(self.cfg, shape, batch_override=batch_override)


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _specs_train(cfg: ModelConfig, B: int, S: int) -> dict:
    tok = _spec((B, S), torch.int32)
    specs = {"tokens": tok, "labels": tok}
    if cfg.family == "audio":
        # stub mel+conv frontend: precomputed frame embeddings; decoder text
        # length S // 8 (audio-to-text compression)
        dec = max(stacks.CE_CHUNK, S // 8)
        specs = {
            "frame_embeds": _spec((B, S, cfg.d_model), torch.float32),
            "tokens": _spec((B, dec), torch.int32),
            "labels": _spec((B, dec), torch.int32),
        }
    elif cfg.family == "vlm":
        specs["img_embeds"] = _spec((B, cfg.n_image_tokens, cfg.d_model), torch.float32)
    elif cfg.family == "resnet":
        specs = {
            "images": _spec((B, 32, 32, 3), torch.float32),
            "labels": _spec((B,), torch.int32),
        }
    return specs


def _specs_prefill(cfg: ModelConfig, B: int, S: int) -> dict:
    specs = {"tokens": _spec((B, S), torch.int32)}
    if cfg.family == "audio":
        specs = {
            "frame_embeds": _spec((B, cfg.enc_frames, cfg.d_model), torch.float32),
            "tokens": _spec((B, S), torch.int32),
        }
    elif cfg.family == "vlm":
        specs["img_embeds"] = _spec((B, cfg.n_image_tokens, cfg.d_model), torch.float32)
    return specs


def input_specs(cfg: ModelConfig, shape: ShapeConfig, *, batch_override: int = 0) -> dict:
    B = batch_override or shape.global_batch
    if shape.kind == "train":
        return _specs_train(cfg, B, shape.seq_len)
    if shape.kind == "prefill":
        return _specs_prefill(cfg, B, shape.seq_len)
    # decode: ONE new token against a cache of seq_len
    return {"tokens": _spec((B, 1), torch.int32)}


_FAMILIES = {
    "dense": ("init_lm", "lm"),
    "moe": ("init_lm", "lm"),
    "vlm": ("init_vlm", "vlm"),
    "audio": ("init_encdec", "encdec"),
    "ssm": ("init_mamba_lm", "mamba"),
    "hybrid": ("init_hybrid", "hybrid"),
}


def get_model(cfg: ModelConfig) -> ModelDef:
    fam = cfg.family
    if fam in _FAMILIES:
        init_name, prefix = _FAMILIES[fam]
        init_fn = getattr(stacks, init_name)
        loss_fn = getattr(stacks, f"{prefix}_loss")
        prefill_fn = getattr(stacks, f"{prefix}_prefill")
        decode_fn = getattr(stacks, f"{prefix}_decode")
        cache_fn = getattr(stacks, f"{prefix}_init_cache")
        return ModelDef(
            cfg,
            init=lambda seed, device=None: init_fn(seed, cfg, device=device),
            loss=lambda p, b: loss_fn(p, cfg, b),
            prefill=lambda p, b: prefill_fn(p, cfg, b),
            decode=lambda p, c, t: decode_fn(p, cfg, c, t),
            init_cache=lambda bs, sl, device=None: cache_fn(cfg, bs, sl, device=device),
        )
    if fam == "resnet":
        return ModelDef(
            cfg,
            init=lambda seed, device=None: resnet.init_resnet20(seed, cfg, device=device),
            loss=lambda p, b: resnet.resnet20_loss(p, cfg, b),
        )
    raise ValueError(f"unknown family: {fam!r}")
