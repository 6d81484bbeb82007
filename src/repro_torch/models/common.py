"""Shared building blocks for the model zoo: norms, MLPs, RoPE, embeddings.

All models are functional over parameter dicts: ``init_*`` builds nested
dicts of tensors, the forward functions apply them.  Layer stacks are
stored stacked along a leading layer dim, as in the JAX package, and driven
by a Python loop over the layer index (``lax.scan`` there).

Initializers draw from a ``torch.Generator`` on the device the parameters
live on, and take ``lead``: the leading stack dims (``(L,)`` for a stack of
L layers).  A stacked leaf is drawn once at its full ``(L, ...)`` shape, so
a full-width model never holds its layers twice.  Torch cannot replay
threefry, so the values differ from the JAX init; the parity tests carry
the JAX package's parameters across instead (``utils.from_jax_params``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig


def _normal(gen, shape, scale, dtype):
    x = torch.randn(tuple(shape), generator=gen, device=gen.device, dtype=torch.float32)
    return x.mul_(scale).to(dtype)


def init_dense(gen, d_in, d_out, dtype, *, bias=False, scale=None, lead=()):
    scale = scale if scale is not None else d_in**-0.5
    p = {"w": _normal(gen, (*lead, d_in, d_out), scale, dtype)}
    if bias:
        p["b"] = torch.zeros((*lead, d_out), dtype=dtype, device=gen.device)
    return p


def dense(p, x, *, cdtype):
    y = x.to(cdtype) @ p["w"].to(cdtype)
    if "b" in p:
        y = y + p["b"].to(cdtype)
    return y


def init_rmsnorm(d, dtype, *, device=None, lead=()):
    return {"scale": torch.ones((*lead, d), dtype=dtype, device=device)}


def rmsnorm(p, x, *, eps):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def init_layernorm(d, dtype, *, device=None, lead=()):
    return {"scale": torch.ones((*lead, d), dtype=dtype, device=device),
            "bias": torch.zeros((*lead, d), dtype=dtype, device=device)}


def layernorm(p, x, *, eps):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


def _gelu(x):
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(x, approximate="tanh")


def activation(name: str):
    return {"silu": F.silu, "gelu": _gelu, "relu": F.relu}[name]


def init_mlp(gen, cfg: ModelConfig, d_ff=None, *, lead=()):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    p = {
        "up": init_dense(gen, d, f, cfg.pdtype, lead=lead),
        "down": init_dense(gen, f, d, cfg.pdtype, scale=f**-0.5, lead=lead),
    }
    if cfg.mlp_gated:
        p["gate"] = init_dense(gen, d, f, cfg.pdtype, lead=lead)
    return p


def mlp(p, x, cfg: ModelConfig):
    act = activation(cfg.act)
    up = dense(p["up"], x, cdtype=cfg.cdtype)
    h = act(dense(p["gate"], x, cdtype=cfg.cdtype)) * up if "gate" in p else act(up)
    return dense(p["down"], h, cdtype=cfg.cdtype)


# --------------------------------------------------------------------------
# Rotary position embeddings (with partial-rotary support for glm4)
# --------------------------------------------------------------------------


def rope_freqs(cfg: ModelConfig, device=None):
    """Inverse frequencies (f32) and the rotated width.  Computed in f64 and
    rounded once: the correctly rounded values, which are what the JAX
    package's jitted models get (XLA folds the constant at compile time).
    An f32 ``pow`` can be an ulp off, and the angle multiplies that by the
    position (2e-5 on a key at position 95 for θ = 5e5)."""
    hd = cfg.hd
    rot = int(hd * cfg.rotary_pct) // 2 * 2
    expo = torch.arange(0, rot, 2, dtype=torch.float64, device=device) / rot
    inv = (1.0 / (cfg.rope_theta ** expo)).float()
    return inv, rot


def apply_rope(x, positions, cfg: ModelConfig):
    """x: (..., S, H, hd); positions: (..., S) int."""
    inv, rot = rope_freqs(cfg, x.device)
    if rot == 0:
        return x
    ang = positions[..., :, None].float() * inv  # (..., S, rot/2)
    cos = torch.cos(ang)[..., :, None, :]  # (..., S, 1, rot/2)
    sin = torch.sin(ang)[..., :, None, :]
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    y = torch.stack([out1, out2], dim=-1).reshape(xr.shape)
    return torch.cat([y, xp], dim=-1).to(x.dtype)


def init_embedding(gen, vocab, d, dtype):
    return {"table": _normal(gen, (vocab, d), 1.0, dtype)}


def embed(p, tokens, *, cdtype):
    return p["table"].to(cdtype)[tokens.long()]


def unembed(p, x, *, cdtype):
    return x.to(cdtype) @ p["table"].to(cdtype).T


def cross_entropy(logits, labels):
    """Mean token-level CE.  logits (..., V) f32-cast; labels (...) int."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(logz - gold)


def stack_layers(init_one, gen, n_layers: int, lead=()):
    """Initialize n layers stacked along a leading layer dim: ``init_one``
    draws each leaf once at ``(*lead, n_layers, ...)``."""
    return init_one(gen, (*lead, n_layers))
