"""ResNet-20/GN: the benchmark's weights, the port's loss, its own weights
(the layout to match), the CPU tests' size and the FLOP count.

The plain model is ``portbench/reference/resnet20_gn.py``; the port's is
``repro_torch.models.resnet`` (imported when the loss is asked for, so this
file loads without the port).
"""
from __future__ import annotations

import torch


def leaf_shapes(cfg: dict) -> dict[str, tuple]:
    """Every parameter's name ('a/b' for nested) and shape, in sorted order.
    Convolutions are HWIO."""
    m = cfg["model_shape"]
    h, w, c_in = m["image"]
    shapes = {"stem": (3, 3, c_in, m["stage_widths"][0]),
              "gn0/scale": (m["stage_widths"][0],), "gn0/bias": (m["stage_widths"][0],)}
    cin = m["stage_widths"][0]
    for s, width in enumerate(m["stage_widths"]):
        for b in range(m["blocks_per_stage"]):
            pre = f"s{s}b{b}/"
            shapes[pre + "conv1"] = (3, 3, cin, width)
            shapes[pre + "gn1/scale"] = shapes[pre + "gn1/bias"] = (width,)
            shapes[pre + "conv2"] = (3, 3, width, width)
            shapes[pre + "gn2/scale"] = shapes[pre + "gn2/bias"] = (width,)
            if cin != width:
                shapes[pre + "proj"] = (1, 1, cin, width)
            cin = width
    shapes["fc/w"] = (cin, m["num_classes"])
    shapes["fc/b"] = (m["num_classes"],)
    return dict(sorted(shapes.items()))


def init_params(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """He-normal convolutions, N(0, 1/fan_in) for the linear layer, GroupNorm
    scale 1 and bias 0, zero biases: one normal draw on ``device`` from
    ``seed``, cut into the leaves."""
    shapes = leaf_shapes(cfg)
    drawn = {k: s for k, s in shapes.items() if len(s) > 1}
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(_numel(s) for s in drawn.values()), generator=gen,
                       device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape in shapes.items():
        if name in drawn:
            fan_in = _numel(shape[:-1])
            scale = (2.0 / fan_in) ** 0.5 if len(shape) == 4 else fan_in**-0.5
            out[name] = flat[at:at + _numel(shape)].view(shape) * scale
            at += _numel(shape)
        elif name.endswith("scale"):
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out


def program_loss(cfg: dict):
    """The port's loss on a nested parameter dict and a minibatch."""
    from repro_torch.configs.resnet20_cifar import CONFIG
    from repro_torch.models.resnet import resnet20_loss

    def loss(params, batch):
        return resnet20_loss(params, CONFIG, batch)

    return loss


def port_params(cfg: dict, seed: int) -> dict:
    """The port's own initial weights (nested), on the CPU: the layout
    :func:`init_params` has to match leaf for leaf."""
    from repro_torch.configs.resnet20_cifar import CONFIG
    from repro_torch.models.resnet import init_resnet20

    return init_resnet20(seed, CONFIG, device="cpu")


def cpu_size(cfg: dict) -> dict:
    """The configuration the CPU tests run: this one as it is (a round of
    ResNet-20 at a few images runs in seconds there)."""
    return cfg


def forward_flops_per_sample(cfg: dict) -> int:
    """2 × the multiply-adds of every convolution and the linear layer for
    one image; normalization, activations, pooling and the loss are not
    counted."""
    m = cfg["model_shape"]
    size = m["image"][0]
    macs = size * size * _numel(leaf_shapes(cfg)["stem"])
    cin = m["stage_widths"][0]
    for s, width in enumerate(m["stage_widths"]):
        for b in range(m["blocks_per_stage"]):
            stride = 2 if (s > 0 and b == 0) else 1
            size = -(-size // stride)
            macs += size * size * 9 * cin * width  # conv1
            macs += size * size * 9 * width * width  # conv2
            if cin != width:
                macs += size * size * cin * width  # projection
            cin = width
    macs += cin * m["num_classes"]
    return 2 * macs


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n
