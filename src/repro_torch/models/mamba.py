"""Mamba-1 (selective SSM) backbone — falcon-mamba-7b family.

The sequence is split into chunks; within a chunk the linear recurrence
h_t = a_t ⊙ h_{t-1} + b_t runs as an inclusive log-step scan
(:func:`linear_scan`, ⌈log₂ q⌉ passes over the chunk), and a Python loop
carries the boundary state across chunks.  This bounds the materialized
state to (B, chunk, d_inner, d_state) instead of (B, S, d_inner, d_state).
The JAX package runs ``lax.associative_scan`` within a chunk; torch has no
counterpart, and the log-step scan associates the products in another
order (about 1e-7 relative in f32 against the JAX scan).

The JAX package wraps the train path in ``jax.checkpoint`` (remat); that
changes memory, not numbers, and ``torch.utils.checkpoint`` does not
compose with the simulator's ``torch.func.vmap(grad)``, so it is left out.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common

CHUNK = 256


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    dt_rank = s.dt_rank or -(-cfg.d_model // 16)
    return d_inner, dt_rank, s.d_state, s.d_conv


def linear_scan(a, b, dim: int):
    """Inclusive scan of h_t = a_t ⊙ h_{t-1} + b_t (h_{-1} = 0) along
    ``dim``: returns (cumulative a, h).  Hillis–Steele: at step 2^i each
    element combines with the one 2^i before it; out of place, so autograd
    and ``torch.func`` see plain ops."""
    n = a.shape[dim]
    shift = 1
    while shift < n:
        a_prev = a.narrow(dim, 0, n - shift)
        b_prev = b.narrow(dim, 0, n - shift)
        a_cur = a.narrow(dim, shift, n - shift)
        b_cur = b.narrow(dim, shift, n - shift)
        b = torch.cat([b.narrow(dim, 0, shift), b_prev * a_cur + b_cur], dim=dim)
        a = torch.cat([a.narrow(dim, 0, shift), a_prev * a_cur], dim=dim)
        shift *= 2
    return a, b


def init_mamba_layer(gen, cfg: ModelConfig, *, lead=()):
    d = cfg.d_model
    di, dtr, ds, dc = _dims(cfg)
    dev = gen.device
    A = torch.arange(1, ds + 1, dtype=torch.float32, device=dev)[None, :].expand(di, ds)
    return {
        "in_proj": common.init_dense(gen, d, 2 * di, cfg.pdtype, lead=lead),
        "conv_w": common._normal(gen, (*lead, dc, di), 0.1, cfg.pdtype),
        "conv_b": torch.zeros((*lead, di), dtype=cfg.pdtype, device=dev),
        "x_proj": common.init_dense(gen, di, dtr + 2 * ds, cfg.pdtype, lead=lead),
        "dt_proj": common.init_dense(gen, dtr, di, cfg.pdtype, bias=True, lead=lead),
        "A_log": torch.log(A).to(cfg.pdtype).expand(*lead, di, ds).clone(),
        "D": torch.ones((*lead, di), dtype=cfg.pdtype, device=dev),
        "out_proj": common.init_dense(gen, di, d, cfg.pdtype, scale=di**-0.5, lead=lead),
        "norm": common.init_rmsnorm(d, cfg.pdtype, device=dev, lead=lead),
    }


def _ssm_inputs(p, xz, cfg: ModelConfig):
    """Project conv output to (delta, B, C) and the decay a = exp(Δ·A)."""
    di, dtr, ds, _ = _dims(cfg)
    proj = common.dense(p["x_proj"], xz, cdtype=cfg.cdtype)
    dt, Bm, Cm = torch.split(proj, [dtr, ds, ds], dim=-1)
    delta = F.softplus(common.dense(p["dt_proj"], dt, cdtype=cfg.cdtype))
    A = -torch.exp(p["A_log"].float())  # (di, ds), negative
    # a: (..., di, ds); b: (..., di, ds) = Δ ⊙ x (outer with B)
    a = torch.exp(delta.float()[..., :, None] * A)
    b = (delta * xz).float()[..., :, None] * Bm.float()[..., None, :]
    return a, b, Cm.float()


def _chunked_scan(a, b, C, h0):
    """Linear recurrence, chunked over the sequence.

    a, b: (B, S, di, ds); C: (B, S, ds); h0: (B, di, ds).
    Returns (y (B, S, di) f32, h_final).
    """
    Bsz, S, di, ds = a.shape
    q = min(CHUNK, S)
    assert S % q == 0, f"seq {S} not a multiple of chunk {q}"
    h, ys = h0, []
    for c in range(S // q):
        ac, bc, cc = a[:, c * q:(c + 1) * q], b[:, c * q:(c + 1) * q], C[:, c * q:(c + 1) * q]
        acc_a, acc_b = linear_scan(ac, bc, dim=1)
        h_t = acc_a * h[:, None] + acc_b  # (B, q, di, ds)
        ys.append(torch.einsum("bqds,bqs->bqd", h_t, cc))
        h = h_t[:, -1]
    return torch.cat(ys, dim=1), h


def _causal_conv(p, x, cfg: ModelConfig):
    """Depthwise causal conv over seq: x (B,S,di)."""
    dc = p["conv_w"].shape[0]
    pad = F.pad(x, (0, 0, dc - 1, 0))
    out = sum(
        pad[:, i : i + x.shape[1]] * p["conv_w"][i].to(cfg.cdtype)
        for i in range(dc)
    )
    return out + p["conv_b"].to(cfg.cdtype)


def mamba_layer(p, x, cfg: ModelConfig, h0=None):
    """Full-sequence path. x (B,S,D). Returns (out, h_final)."""
    di, *_ = _dims(cfg)
    ds = cfg.ssm.d_state
    B = x.shape[0]
    resid = x
    x = common.rmsnorm(p["norm"], x, eps=cfg.norm_eps)
    xz = common.dense(p["in_proj"], x, cdtype=cfg.cdtype)
    xpart, z = torch.chunk(xz, 2, dim=-1)
    xpart = F.silu(_causal_conv(p, xpart, cfg))
    a, b, C = _ssm_inputs(p, xpart, cfg)
    h0 = torch.zeros((B, di, ds), dtype=torch.float32, device=x.device) if h0 is None else h0
    y, h_fin = _chunked_scan(a, b, C, h0)
    y = y.to(cfg.cdtype) + p["D"].to(cfg.cdtype) * xpart
    y = y * F.silu(z)
    out = common.dense(p["out_proj"], y, cdtype=cfg.cdtype)
    return resid + out, h_fin


def init_mamba_state(cfg: ModelConfig, batch: int, *, device=None):
    di, _, ds, dc = _dims(cfg)
    return {
        "h": torch.zeros((batch, di, ds), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, dc - 1, di), dtype=cfg.cdtype, device=device),
    }


def mamba_decode_layer(p, x1, state, cfg: ModelConfig):
    """One-token step. x1 (B,1,D). Returns (out (B,1,D), new state)."""
    resid = x1
    x = common.rmsnorm(p["norm"], x1, eps=cfg.norm_eps)
    xz = common.dense(p["in_proj"], x, cdtype=cfg.cdtype)
    xpart, z = torch.chunk(xz, 2, dim=-1)  # (B,1,di)
    window = torch.cat([state["conv"], xpart], dim=1)  # (B,dc,di)
    conv = torch.einsum("bti,ti->bi", window.to(cfg.cdtype), p["conv_w"].to(cfg.cdtype))
    xc = F.silu(conv + p["conv_b"].to(cfg.cdtype))[:, None]
    a, b, C = _ssm_inputs(p, xc, cfg)
    h = a[:, 0] * state["h"] + b[:, 0]
    y = torch.einsum("bds,bs->bd", h, C[:, 0])[:, None]
    y = y.to(cfg.cdtype) + p["D"].to(cfg.cdtype) * xc
    y = y * F.silu(z)
    out = common.dense(p["out_proj"], y, cdtype=cfg.cdtype)
    new_state = {"h": h, "conv": window[:, 1:]}
    return resid + out, new_state
