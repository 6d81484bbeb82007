"""ResNet-20 for 32×32×3 images (He et al., arXiv:1512.03385, §4.2) with
GroupNorm (Wu and He, arXiv:1803.08494) in place of BatchNorm: the plain
model of the ``resnet20_gn`` configurations, in plain torch.

Three stages of three basic blocks (16, 32, 64 channels); the first block
of stages 2 and 3 halves the map with a stride-2 3×3 convolution and a
stride-2 1×1 projection on the shortcut; GroupNorm of ``min(8, C)`` groups
over the population variance (eps 1e-5); global average pooling and a
linear layer.  Departures from the paper, as the benchmark's weights lay
them out: convolution weights are HWIO and images NHWC, and "SAME" padding
puts the odd pixel after the map (a stride-2 3×3 convolution of an even
map pads 0 before and 1 after).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

STAGES = (16, 32, 64)
BLOCKS = 3
GROUPS = 8


def _conv(w, x, stride: int = 1):
    k = w.shape[0]
    size = x.shape[2]
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    before, after = total // 2, total - total // 2
    if total:
        x = F.pad(x, (before, after, before, after))
    return F.conv2d(x, w.permute(3, 2, 0, 1), stride=stride)


def _group_norm(p, x):
    B, C, H, W = x.shape
    g = min(GROUPS, C)
    xg = x.reshape(B, g, C // g, H, W)
    mu = xg.mean(dim=(2, 3, 4), keepdim=True)
    var = ((xg - mu) ** 2).mean(dim=(2, 3, 4), keepdim=True)
    xg = (xg - mu) / torch.sqrt(var + 1e-5)
    return xg.reshape(B, C, H, W) * p["scale"][:, None, None] + p["bias"][:, None, None]


def logits(params, images):
    """images (B, 32, 32, 3) → logits (B, classes)."""
    x = images.permute(0, 3, 1, 2)
    x = F.relu(_group_norm(params["gn0"], _conv(params["stem"], x)))
    for s in range(len(STAGES)):
        for b in range(BLOCKS):
            p = params[f"s{s}b{b}"]
            stride = 2 if (s > 0 and b == 0) else 1
            h = F.relu(_group_norm(p["gn1"], _conv(p["conv1"], x, stride)))
            h = _group_norm(p["gn2"], _conv(p["conv2"], h))
            shortcut = _conv(p["proj"], x, stride) if "proj" in p else x
            x = F.relu(h + shortcut)
    x = x.mean(dim=(2, 3))
    return x @ params["fc"]["w"] + params["fc"]["b"]


def loss(params, images, labels):
    """Mean cross-entropy of a minibatch."""
    return F.cross_entropy(logits(params, images), labels.long())
