"""The channel figures' MLP (3,072 → 256 → 10): the benchmark's weights, the
port's loss, its own weights (the layout to match), the CPU tests' size and
the FLOP count.

The plain model is ``portbench/reference/mlp3072.py``; the port's is
``repro_torch.bench.figures.make_mlp`` (imported when the loss is asked
for).
"""
from __future__ import annotations

import torch


def leaf_shapes(cfg: dict) -> dict[str, tuple]:
    m = cfg["model_shape"]
    d_in, width, out = m["inputs"], m["hidden"], m["num_classes"]
    return {"b1": (width,), "b2": (out,), "w1": (d_in, width), "w2": (width, out)}


def init_params(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """N(0, 1/fan_in) weights and zero biases: one normal draw on ``device``
    from ``seed``, cut into the two weights."""
    shapes = leaf_shapes(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    w1, w2 = shapes["w1"], shapes["w2"]
    flat = torch.randn(w1[0] * w1[1] + w2[0] * w2[1], generator=gen, device=device,
                       dtype=torch.float32)
    return {
        "b1": torch.zeros(shapes["b1"], device=device),
        "b2": torch.zeros(shapes["b2"], device=device),
        "w1": flat[: w1[0] * w1[1]].view(w1) * w1[0] ** -0.5,
        "w2": flat[w1[0] * w1[1]:].view(w2) * w2[0] ** -0.5,
    }


def program_loss(cfg: dict):
    """The port's loss on a parameter dict and a minibatch."""
    from repro_torch.bench.figures import make_mlp

    m = cfg["model_shape"]
    _, _, loss = make_mlp(m["inputs"], m["hidden"], m["num_classes"], device="cpu")
    return loss


def port_params(cfg: dict, seed: int) -> dict:
    """The port's own initial weights, on the CPU: the layout
    :func:`init_params` has to match leaf for leaf."""
    from repro_torch.bench.figures import make_mlp

    m = cfg["model_shape"]
    return make_mlp(m["inputs"], m["hidden"], m["num_classes"], device="cpu")[0](seed)


def cpu_size(cfg: dict) -> dict:
    """The configuration the CPU tests run: this one as it is."""
    return cfg


def forward_flops_per_sample(cfg: dict) -> int:
    """2 × the multiply-adds of the two linear layers for one image; the
    biases, the ReLU and the loss are not counted."""
    m = cfg["model_shape"]
    return 2 * (m["inputs"] * m["hidden"] + m["hidden"] * m["num_classes"])
