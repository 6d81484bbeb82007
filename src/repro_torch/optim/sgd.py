"""Client-side optimizers.  The paper trains clients with plain SGD
(lr 0.1, ℓ2 1e-4); momentum/Adam are provided for beyond-paper runs.

The updates are elementwise, so they apply unchanged to a stacked
per-client pytree (leaves (n, ...)).  Weight decay and the update math run
in f32; the result is cast back to the parameter dtype.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.utils import tree_flatten, tree_map


@dataclasses.dataclass(frozen=True)
class ClientOpt:
    kind: str = "sgd"            # sgd | momentum | adam
    momentum: float = 0.9
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 1e-4

    def init(self, params) -> Any:
        if self.kind == "sgd":
            return ()
        if self.kind == "momentum":
            return tree_map(torch.zeros_like, params)
        if self.kind == "adam":
            z = tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32), params)
            return {"m": z, "v": tree_map(torch.clone, z), "t": 0}
        raise ValueError(self.kind)

    def step(self, params, grads, state, lr):
        wd = self.weight_decay

        def decayed(g, p):
            return g.float() + wd * p.float()

        if self.kind == "sgd":
            new = tree_map(
                lambda p, g: (p.float() - lr * decayed(g, p)).to(p.dtype),
                params, grads)
            return new, state
        if self.kind == "momentum":
            vel = tree_map(
                lambda v, g, p: self.momentum * v + decayed(g, p), state, grads, params)
            new = tree_map(
                lambda p, v: (p.float() - lr * v).to(p.dtype), params, vel)
            return new, vel
        if self.kind == "adam":
            t = state["t"] + 1
            m = tree_map(lambda m, g, p: self.b1 * m + (1 - self.b1) * decayed(g, p),
                         state["m"], grads, params)
            v = tree_map(lambda v, g, p: self.b2 * v + (1 - self.b2) * decayed(g, p) ** 2,
                         state["v"], grads, params)
            # bias corrections in f32 on the device, b ** f32(t) as the JAX
            # package computes them: no host tensor, so no copy in a round
            # (a captured round may not copy from the host)
            dev = tree_flatten(m)[0][0].device

            def bias_correction(b):
                return 1 - torch.pow(torch.full((), b, dtype=torch.float32, device=dev),
                                     float(t))

            bc1, bc2 = bias_correction(self.b1), bias_correction(self.b2)
            new = tree_map(
                lambda p, m_, v_: (
                    p.float() - lr * (m_ / bc1) / (torch.sqrt(v_ / bc2) + self.eps)
                ).to(p.dtype),
                params, m, v)
            return new, {"m": m, "v": v, "t": t}
        raise ValueError(self.kind)
