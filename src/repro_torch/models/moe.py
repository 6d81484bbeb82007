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


# --------------------------------------------------------------------------
# DeepSeekMoE (DeepSeek-V2, arXiv:2405.04434 §2.2): shared experts, greedy
# top-k over a softmax router without renormalization, and a layer that
# computes only the routed experts it holds
# --------------------------------------------------------------------------


def init_ds_moe(gen, cfg, *, lead=()):
    """The router over all ``n_routed`` experts, the held experts' SwiGLU
    weights (``lead + (n_held, ...)``) and the shared experts' one SwiGLU
    of ``n_shared · expert_d_ff``."""
    d, e = cfg.d_model, cfg.ds_moe
    f = e.expert_d_ff

    def ew(din, dout):
        return common._normal(gen, (*lead, e.n_held, din, dout), din**-0.5, cfg.pdtype)

    return {
        "router": common.init_dense(gen, d, e.n_routed, cfg.pdtype, lead=lead),
        "gate": ew(d, f),
        "up": ew(d, f),
        "down": ew(f, d),
        "shared": common.init_mlp(gen, cfg, d_ff=e.n_shared * f, lead=lead),
    }


def ds_capacity(cfg, S: int) -> int:
    """Tokens a held expert takes from one sequence of S:
    capacity_factor · S · top_k / n_routed."""
    e = cfg.ds_moe
    return max(1, int(e.capacity_factor * S * e.top_k / e.n_routed))


def ds_moe_ffn(p, x, cfg):
    """x (B, S, D) → (out (B, S, D), balance loss (scalar), counters).

    Each row (a sequence) routes on its own: softmax over the router's
    ``n_routed`` outputs, greedy top-``top_k`` scaled by ``routed_scale``
    and not renormalized.  Of the routed part only the held experts' is
    computed; a choice of an absent expert adds nothing.  A held expert
    takes its first :func:`ds_capacity` choosing tokens by position and
    drops the rest.  The shared experts see every token.  The balance loss
    is DeepSeek-V2's sequence-wise one over all ``n_routed`` experts, α ·
    Σ_i f_i P_i with f_i the share of the row's choices that picked i times
    n_routed / top_k and P_i the row's mean probability, averaged over the
    rows.  ``counters``: ``moe.choices_here`` (choices of held experts) and
    ``moe.choices_dropped`` (of those, dropped at capacity), int64 sums over
    the rows.

    The held experts' tokens are gathered into an (n_held, C, D) slab, so
    the expert matmuls do the slab's work alone; each expert's rows go back
    by a scatter into their tokens' rows (a token reaches an expert once, so
    no two rows of one scatter collide, and the experts' parts are added in
    expert order: deterministic)."""
    e = cfg.ds_moe
    B, S, D = x.shape
    E, K, Hh = e.n_routed, e.top_k, e.n_held
    C = ds_capacity(cfg, S)

    probs = torch.softmax(common.dense(p["router"], x, cdtype=torch.float32), dim=-1)
    weights, ids = torch.topk(probs, K, dim=-1)  # (B, S, K)
    weights = weights * e.routed_scale

    picked = _one_hot(ids, E, torch.float32).sum(dim=2)  # (B, S, E): 1 where chosen
    f = picked.sum(dim=1) * (E / (S * K))
    aux = e.aux_alpha * torch.mean(torch.sum(f * probs.mean(dim=1), dim=-1))

    # the held experts' part: chosen[b, t, h] and its weight
    local = ids - e.held_start
    sel = (local[..., None] == torch.arange(Hh, device=x.device)).to(torch.float32)
    chosen = sel.sum(dim=2) > 0  # (B, S, Hh)
    gate = (sel * weights[..., None]).sum(dim=2)  # (B, S, Hh)
    pos = torch.cumsum(chosen.long(), dim=1) - chosen.long()  # exclusive, by position
    kept = chosen & (pos < C)
    counters = {"moe.choices_here": chosen.sum(), "moe.choices_dropped": (chosen & ~kept).sum()}

    # slot table (B, Hh, C): the token each slot holds, S for an empty slot;
    # a token not kept writes to the dump column C
    col = torch.where(kept, pos, C).transpose(1, 2)  # (B, Hh, S)
    tok = torch.arange(S, device=x.device).expand(B, Hh, S)
    table = torch.full((B, Hh, C + 1), S, dtype=torch.long, device=x.device)
    table = table.scatter(2, col, tok)[..., :C]

    xc = x.to(cfg.cdtype)
    xpad = torch.cat([xc, torch.zeros((B, 1, D), dtype=cfg.cdtype, device=x.device)], dim=1)
    flat = table.reshape(B, Hh * C)
    eb = torch.gather(xpad, 1, flat[..., None].expand(B, Hh * C, D)).reshape(B, Hh, C, D)
    act = common.activation(cfg.act)
    h = act(torch.einsum("becd,edf->becf", eb, p["gate"].to(cfg.cdtype))) * torch.einsum(
        "becd,edf->becf", eb, p["up"].to(cfg.cdtype))
    y = torch.einsum("becf,efd->becd", h, p["down"].to(cfg.cdtype))  # (B, Hh, C, D)
    gpad = torch.cat([gate, torch.zeros((B, 1, Hh), device=x.device)], dim=1).transpose(1, 2)
    y = y * torch.gather(gpad, 2, table).to(cfg.cdtype)[..., None]  # empty slots weigh 0

    routed = None
    for i in range(Hh):
        part = torch.zeros((B, S + 1, D), dtype=cfg.cdtype, device=x.device).scatter(
            1, table[:, i, :, None].expand(B, C, D), y[:, i])
        routed = part if routed is None else routed + part
    out = routed[:, :S] + common.mlp(p["shared"], x, cfg)
    return out, aux, counters
