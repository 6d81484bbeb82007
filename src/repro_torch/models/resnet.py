"""ResNet-20 for CIFAR-shaped inputs — the paper's §V model.

Faithful 3-stage (16/32/64 channels, 3 basic blocks each) CIFAR ResNet with
GroupNorm(8) in place of BatchNorm, as in the JAX package, so the model stays
a pure function of its parameter dict.

Layouts follow the JAX package at the public functions: conv weights are
HWIO and images NHWC.  The forward permutes to torch's NCHW/OIHW inside.
Two details keep the numbers equal to the reference:

* ``"SAME"`` padding is computed as XLA computes it.  A stride-2 3×3 conv on
  an even input pads (0, 1): nothing before, one after.  ``F.conv2d``'s
  ``padding=1`` would pad (1, 1) and shift every output.
* GroupNorm divides by the population variance (``correction=0``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.utils import resolve_device, tree_map


def _conv_init(gen, kh, kw, cin, cout, dtype):
    fan_in = kh * kw * cin
    w = torch.randn((kh, kw, cin, cout), generator=gen) * (2.0 / fan_in) ** 0.5
    return w.to(dtype)


def _same_pad(size: int, k: int, stride: int) -> tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(w, x, stride=1):
    """x (B, C, H, W), w HWIO → (B, Cout, H', W') with XLA's SAME padding."""
    kh, kw = w.shape[0], w.shape[1]
    top, bottom = _same_pad(x.shape[2], kh, stride)
    left, right = _same_pad(x.shape[3], kw, stride)
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom))
    return F.conv2d(x, w.to(x.dtype).permute(3, 2, 0, 1), stride=stride)


def _init_gn(c, dtype):
    return {"scale": torch.ones((c,), dtype=dtype), "bias": torch.zeros((c,), dtype=dtype)}


def _gn(p, x, groups=8, eps=1e-5):
    B, C, H, W = x.shape
    g = min(groups, C)
    xf = x.float().reshape(B, g, C // g, H, W)
    mu = xf.mean(dim=(2, 3, 4), keepdim=True)
    var = xf.var(dim=(2, 3, 4), keepdim=True, correction=0)
    xf = ((xf - mu) * torch.rsqrt(var + eps)).reshape(B, C, H, W)
    out = xf * p["scale"][:, None, None] + p["bias"][:, None, None]
    return out.to(x.dtype)


def _init_block(gen, cin, cout, dtype):
    p = {
        "conv1": _conv_init(gen, 3, 3, cin, cout, dtype),
        "gn1": _init_gn(cout, dtype),
        "conv2": _conv_init(gen, 3, 3, cout, cout, dtype),
        "gn2": _init_gn(cout, dtype),
    }
    if cin != cout:
        p["proj"] = _conv_init(gen, 1, 1, cin, cout, dtype)
    return p


def _block(p, x, stride):
    h = F.relu(_gn(p["gn1"], _conv(p["conv1"], x, stride)))
    h = _gn(p["gn2"], _conv(p["conv2"], h))
    sc = _conv(p["proj"], x, stride) if "proj" in p else x
    return F.relu(h + sc)


def init_resnet20(seed: int, cfg: ModelConfig, num_classes: int = 10, *, device=None):
    """Random ResNet-20/GN parameters from ``seed`` (drawn on the CPU, so a
    seed gives the same weights on every machine), moved to ``device``.
    Use ``repro_torch.utils.from_jax_params`` to load the JAX package's."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    dtype = cfg.pdtype
    widths = [16, 32, 64]
    params = {"stem": _conv_init(gen, 3, 3, 3, 16, dtype), "gn0": _init_gn(16, dtype)}
    cin = 16
    for s, w in enumerate(widths):
        for b in range(3):
            params[f"s{s}b{b}"] = _init_block(gen, cin, w, dtype)
            cin = w
    params["fc"] = {
        "w": (torch.randn((64, num_classes), generator=gen) * 64**-0.5).to(dtype),
        "b": torch.zeros((num_classes,), dtype=dtype),
    }
    return tree_map(lambda x: x.to(device), params)


def resnet20_logits(params, cfg: ModelConfig, images):
    """images (B, 32, 32, 3) NHWC -> logits (B, 10)."""
    x = images.to(cfg.cdtype).permute(0, 3, 1, 2)
    x = F.relu(_gn(params["gn0"], _conv(params["stem"], x)))
    for s in range(3):
        for b in range(3):
            stride = 2 if (s > 0 and b == 0) else 1
            x = _block(params[f"s{s}b{b}"], x, stride)
    x = x.mean(dim=(2, 3))
    return x @ params["fc"]["w"].to(cfg.cdtype) + params["fc"]["b"].to(cfg.cdtype)


def resnet20_loss(params, cfg: ModelConfig, batch):
    logits = resnet20_logits(params, cfg, batch["images"]).float()
    labels = batch["labels"].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[:, None])[:, 0]
    return (logz - gold).mean()
