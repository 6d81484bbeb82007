"""The channel figures' MLP in plain torch: a flattened 32×32×3 image
(3,072 inputs) → 256 ReLU units → 10 logits, mean cross-entropy."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def logits(params, images):
    x = images.reshape(images.shape[0], -1)
    h = torch.relu(x @ params["w1"] + params["b1"])
    return h @ params["w2"] + params["b2"]


def loss(params, images, labels):
    """Mean cross-entropy of a minibatch."""
    return F.cross_entropy(logits(params, images), labels.long())
