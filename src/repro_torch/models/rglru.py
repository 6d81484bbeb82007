"""RG-LRU recurrent block (RecurrentGemma / Griffin) — the recurrent 2/3 of
the hybrid architecture.  Linear per-channel recurrence

    r_t = σ(W_a x_t + b_a)            (recurrence gate)
    i_t = σ(W_x x_t + b_x)            (input gate)
    a_t = exp(-c · softplus(Λ) · r_t) (per-channel decay, c = 8)
    h_t = a_t ⊙ h_{t-1} + sqrt(1 − a_t²) ⊙ (i_t ⊙ x_t)

run as the log-step scan of ``mamba.linear_scan`` over each chunk of the
sequence (the JAX package's ``lax.associative_scan``; about 1e-7 relative
apart in f32).  The full Griffin recurrent block is: linear → causal conv(4)
→ RG-LRU on one branch, gated by GeLU(linear) on the other, then an output
projection.  The JAX package checkpoints each chunk (``jax.checkpoint``);
that changes memory, not numbers, and is left out here because
``torch.utils.checkpoint`` does not compose with ``torch.func.vmap(grad)``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common
from repro_torch.models.mamba import linear_scan

_C = 8.0


def _width(cfg: ModelConfig) -> int:
    return cfg.rglru.lru_width or cfg.d_model


def init_rglru_block(gen, cfg: ModelConfig, *, lead=()):
    d, w = cfg.d_model, _width(cfg)
    dc = cfg.rglru.conv_width
    dev = gen.device
    # Λ init so that a ∈ (0.9, 0.999) at r = 1 (griffin init)
    lam = torch.rand((*lead, w), generator=gen, device=dev) * 4.0 + 2.0
    return {
        "in_x": common.init_dense(gen, d, w, cfg.pdtype, lead=lead),
        "in_gate": common.init_dense(gen, d, w, cfg.pdtype, lead=lead),
        "conv_w": common._normal(gen, (*lead, dc, w), 0.1, cfg.pdtype),
        "conv_b": torch.zeros((*lead, w), dtype=cfg.pdtype, device=dev),
        "W_a": common.init_dense(gen, w, w, cfg.pdtype, bias=True, lead=lead),
        "W_x": common.init_dense(gen, w, w, cfg.pdtype, bias=True, lead=lead),
        "lam": lam.to(cfg.pdtype),
        "out": common.init_dense(gen, w, d, cfg.pdtype, scale=w**-0.5, lead=lead),
    }


def _gates(p, x, cfg: ModelConfig):
    r = torch.sigmoid(common.dense(p["W_a"], x, cdtype=torch.float32))
    i = torch.sigmoid(common.dense(p["W_x"], x, cdtype=torch.float32))
    log_a = -_C * F.softplus(p["lam"].float()) * r
    a = torch.exp(log_a)
    gated_in = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * x.float())
    return a, gated_in


def _causal_conv(p, x, cfg: ModelConfig):
    dc = p["conv_w"].shape[0]
    pad = F.pad(x, (0, 0, dc - 1, 0))
    out = sum(
        pad[:, i : i + x.shape[1]] * p["conv_w"][i].to(cfg.cdtype)
        for i in range(dc)
    )
    return out + p["conv_b"].to(cfg.cdtype)


# chunk length for the linear recurrence: bounds the (B, chunk, W) f32
# gate/state tensors a chunk holds
CHUNK = 512


def _add_h0(a, b, h):
    """b with a[:, 0] ⊙ h added to its first step (out of place)."""
    return torch.cat([b[:, :1] + a[:, :1] * h[:, None], b[:, 1:]], dim=1)


def _recurrence_from_xb(p, xb, cfg: ModelConfig, h0):
    """Gates + linear recurrence, chunked over the sequence.
    xb: (B, S, W) post-conv activations."""
    B, S, W = xb.shape
    q = min(CHUNK, S)
    if S % q:
        a, b = _gates(p, xb, cfg)  # short sequences: one-shot
        if h0 is not None:
            b = _add_h0(a, b, h0)
        _, h = linear_scan(a, b, dim=1)
        return h.to(cfg.cdtype)
    h = torch.zeros((B, W), dtype=torch.float32, device=xb.device) if h0 is None else h0
    hs = []
    for c in range(S // q):
        ac, bc = _gates(p, xb[:, c * q:(c + 1) * q], cfg)
        bc = _add_h0(ac, bc, h)
        _, hc = linear_scan(ac, bc, dim=1)
        h = hc[:, -1]
        hs.append(hc.to(cfg.cdtype))
    return torch.cat(hs, dim=1)


def rglru_block(p, x, cfg: ModelConfig, h0=None):
    """Full-sequence path.  x (B,S,D) -> (out (B,S,D), h_final (B,W))."""
    xb = common.dense(p["in_x"], x, cdtype=cfg.cdtype)
    gate = F.gelu(common.dense(p["in_gate"], x, cdtype=cfg.cdtype), approximate="tanh")
    xb = _causal_conv(p, xb, cfg)
    h = _recurrence_from_xb(p, xb, cfg, h0)
    y = h * gate
    return common.dense(p["out"], y, cdtype=cfg.cdtype), h[:, -1].float()


def init_rglru_state(cfg: ModelConfig, batch: int, *, device=None):
    w, dc = _width(cfg), cfg.rglru.conv_width
    return {
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, dc - 1, w), dtype=cfg.cdtype, device=device),
    }


def rglru_decode_block(p, x1, state, cfg: ModelConfig):
    """One-token step.  x1 (B,1,D) -> (out (B,1,D), new state)."""
    xb = common.dense(p["in_x"], x1, cdtype=cfg.cdtype)  # (B,1,W)
    gate = F.gelu(common.dense(p["in_gate"], x1, cdtype=cfg.cdtype), approximate="tanh")
    window = torch.cat([state["conv"], xb], dim=1)  # (B,dc,W)
    conv = torch.einsum("btw,tw->bw", window.to(cfg.cdtype), p["conv_w"].to(cfg.cdtype))
    xc = (conv + p["conv_b"].to(cfg.cdtype))[:, None]
    a, b = _gates(p, xc, cfg)
    h = a[:, 0] * state["h"] + b[:, 0]
    y = h[:, None].to(cfg.cdtype) * gate
    out = common.dense(p["out"], y, cdtype=cfg.cdtype)
    return out, {"h": h, "conv": window[:, 1:]}
