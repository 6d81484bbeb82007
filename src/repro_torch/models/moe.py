"""Mixture-of-Experts FFN (Mixtral / Grok-1 style: softmax router, top-2).

Dispatch is scatter/gather-based rather than one-hot-einsum-based: slot
assignment is computed with a cumsum over router one-hots and tokens are
moved with a scatter into an (E·C + 1, D) buffer and a gather back, so the
expert matmuls do the active compute only (2·E·C·d·f each).

Capacity-overflow tokens are dropped (standard practice; overflow slot E·C
is a write-off buffer row).

Routing is *group-wise*: each batch row routes independently, with its own
capacity, as the JAX package's vmap over rows does.  Here the rows are a
leading batch dim of every op instead of a nested ``vmap``, so the function
composes with the simulator's ``torch.func.vmap(grad)`` over clients.  The
scatter is out of place; duplicate slots all land on the discarded dump
row, so which of their writes wins does not matter.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common


def init_moe(gen, cfg: ModelConfig, *, lead=()):
    d, f, E = cfg.d_model, cfg.d_ff, cfg.moe.n_experts

    def ew(din, dout, scale):
        return common._normal(gen, (*lead, E, din, dout), scale, cfg.pdtype)

    p = {
        "router": common.init_dense(gen, d, E, cfg.pdtype, lead=lead),
        "up": ew(d, f, d**-0.5),
        "down": ew(f, d, f**-0.5),
    }
    if cfg.mlp_gated:
        p["gate"] = ew(d, f, d**-0.5)
    return p


def _one_hot(ids, n, dtype):
    return (ids[..., None] == torch.arange(n, device=ids.device)).to(dtype)


def _capacity(cfg: ModelConfig, T: int) -> int:
    mcfg = cfg.moe
    return max(1, int(mcfg.capacity_factor * T * mcfg.top_k / mcfg.n_experts))


def _route(p, x, cfg: ModelConfig):
    """x (B, S, D) -> (probs (B,S,E), gate_vals (B,S,K), expert_ids (B,S,K))."""
    logits = common.dense(p["router"], x, cdtype=torch.float32)  # (B,S,E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = torch.topk(probs, cfg.moe.top_k, dim=-1)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    return probs, gate_vals, expert_ids


def moe_ffn(p, x, cfg: ModelConfig):
    """x (B,S,D) -> (out (B,S,D), aux_loss scalar: the mean over rows)."""
    out, aux = _moe_ffn_group(p, x, cfg)
    return out, torch.mean(aux)


def _moe_ffn_group(p, x, cfg: ModelConfig):
    """x (B, S, D): B routing groups, one a row.  Returns (out, aux (B,))."""
    mcfg = cfg.moe
    B, S, D = x.shape
    T = S
    E, K = mcfg.n_experts, mcfg.top_k
    C = _capacity(cfg, T)

    probs, gate_vals, expert_ids = _route(p, x, cfg)

    # Load-balance aux loss (Switch-style): E * sum_e f_e * P_e
    top1 = expert_ids[..., 0]
    f_e = torch.mean(_one_hot(top1, E, torch.float32), dim=1)  # (B,E)
    P_e = torch.mean(probs, dim=1)
    aux = E * torch.sum(f_e * P_e, dim=-1) * mcfg.aux_loss_weight

    # Slot assignment: flatten the K choices, count position within expert.
    flat_e = expert_ids.reshape(B, T * K)  # choice-major per token
    onehot = _one_hot(flat_e, E, torch.int64)  # (B,TK,E)
    pos_in_e = torch.cumsum(onehot, dim=1) - onehot  # exclusive count
    pos = torch.gather(pos_in_e, 2, flat_e[..., None])[..., 0]  # (B,TK)
    overflow = pos >= C
    slots = torch.where(overflow, E * C, flat_e * C + pos)  # E*C = dump row

    # token t appears K times
    xt_rep = x.to(cfg.cdtype)[:, :, None, :].expand(B, T, K, D).reshape(B, T * K, D)
    buf = torch.zeros((B, E * C + 1, D), dtype=cfg.cdtype, device=x.device)
    buf = buf.scatter(1, slots[..., None].expand(B, T * K, D), xt_rep)
    eb = buf[:, : E * C].reshape(B, E, C, D)

    # Expert FFN: batched over experts — FLOPs = active compute only.
    act = common.activation(cfg.act)
    up = torch.einsum("becd,edf->becf", eb, p["up"].to(cfg.cdtype))
    if "gate" in p:
        g = torch.einsum("becd,edf->becf", eb, p["gate"].to(cfg.cdtype))
        h = act(g) * up
    else:
        h = act(up)
    y = torch.einsum("becf,efd->becd", h, p["down"].to(cfg.cdtype))

    yflat = torch.cat([y.reshape(B, E * C, D),
                       torch.zeros((B, 1, D), dtype=cfg.cdtype, device=x.device)], dim=1)
    gathered = torch.gather(yflat, 1, slots[..., None].expand(B, T * K, D))
    # dropped tokens read zeros
    weight = torch.where(overflow, 0.0, gate_vals.reshape(B, T * K)).to(cfg.cdtype)
    gathered = gathered * weight[..., None]
    out = gathered.reshape(B, T, K, D).sum(dim=2)
    return out, aux
