"""DeepSeek-V2-Lite (arXiv:2405.04434; the published ``config.json``), one
chip's share, in plain torch: the plain model of the ``deepseek_v2_lite``
configurations.

Widths are read from the weights' shapes; what shapes do not tell is the
published model's (below) and the share's (``HELD_START``, the first of the
experts this chip holds: shard 0).

* Embedding, then ``dense`` layers and ``blocks`` (MoE) layers, each
  x + MLA(RMSNorm(x)) then x + FFN(RMSNorm(x)); a final RMSNorm and an
  untied head; mean next-token cross-entropy over the vocabulary's rows,
  plus every MoE layer's balance loss.
* MLA without a query LoRA (§2.1.2–2.1.3): q = W_q h, per head [q_nope;
  q_pe]; [c_kv; k_pe] = W_kva h; c_kv ← RMSNorm(c_kv); [k_nope; v] = W_kvb
  c_kv per head; RoPE on q_pe and on the one k_pe every head shares, its
  frequencies YaRN's (written out below from the YaRN paper, arXiv:2309.00071,
  as DeepSeek-V2 applies it: pairs (2i, 2i + 1) rotated together); scores
  q·k scaled by (qk_nope + qk_rope)^-½ · (0.1 · mscale_all_dim · ln factor
  + 1)²; the full (S, S) score matrix, causally masked, softmax, times v; W_o.
* DeepSeekMoE (§2.2): softmax over the router's E outputs, greedy top-K,
  weights not renormalized (scaled by ROUTED_SCALE); each held expert e
  (a loop over them) takes, of the tokens that chose it, the first
  ⌊CAPACITY_FACTOR · S · K / E⌋ by position and adds weight × SwiGLU_e(h)
  to them; a choice of an expert held elsewhere adds nothing; the shared
  experts (one SwiGLU) see every token.  Balance loss AUX_ALPHA · Σ_i f_i
  P_i, f_i = (E / (S K)) · the row's choices of i, P_i the row's mean
  probability of i, over all E; averaged over the rows.

Departures from the published model: the capacity drop (the published model
drops by affinity at device level; here a held expert drops by position,
as the port does) and the share itself (layers, experts and vocabulary of
one chip).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# the published config's (config.json; AUX_ALPHA is DeepSeek-V2's α₁ for
# V2-Lite, which the catalog's config lacks)
TOP_K = 6
ROUTED_SCALE = 1.0
ROPE_THETA = 10_000.0
YARN = {"factor": 40.0, "original_max_position_embeddings": 4096, "beta_fast": 32.0,
        "beta_slow": 1.0, "mscale": 0.707, "mscale_all_dim": 0.707}
RMS_EPS = 1e-6
AUX_ALPHA = 0.001
# assumed (the configuration's capacity_factor), and the share's
CAPACITY_FACTOR = 1.25
HELD_START = 0


def _rmsnorm(scale, x):
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + RMS_EPS) * scale


def _swiglu(gate, up, down, x):
    return (F.silu(x @ gate) * (x @ up)) @ down


def _yarn_mscale(factor, m):
    return 1.0 if factor <= 1 else 0.1 * m * math.log(factor) + 1.0


def yarn_inv_freq(dim: int) -> torch.Tensor:
    """YaRN's per-pair inverse frequencies for a rotated width ``dim``,
    worked out in f64: a pair that turns r(i) = L / (2π θ^(2i/dim)) times over the original
    context L keeps θ^(−2i/dim) where r ≥ beta_fast, takes θ^(−2i/dim) /
    factor where r ≤ beta_slow, and a linear blend between; the two ends
    are where r crosses beta_fast and beta_slow, rounded outward to whole
    pairs."""
    y, L = YARN, YARN["original_max_position_embeddings"]
    i = torch.arange(dim // 2, dtype=torch.float64)
    base = ROPE_THETA ** (-2 * i / dim)

    def pair_at(turns):  # the (fractional) pair index where r(i) = turns
        return dim * math.log(L / (2 * math.pi * turns)) / (2 * math.log(ROPE_THETA))

    lo = max(math.floor(pair_at(y["beta_fast"])), 0)
    hi = min(math.ceil(pair_at(y["beta_slow"])), dim - 1)
    if hi == lo:
        hi += 0.001
    interp = torch.clamp((i - lo) / (hi - lo), 0.0, 1.0)  # 0: keep, 1: divide by factor
    return base * (1 - interp) + base / y["factor"] * interp


def _rope(x, inv):
    """x (..., S, heads, dim): pairs (2i, 2i+1) rotated by position × inv_i,
    the angles and their cos and sin in f32 (DeepSeek-V2's code takes them
    so)."""
    S = x.shape[-3]
    ang = (torch.arange(S, dtype=torch.float32, device=x.device)[:, None]
           * inv.to(device=x.device, dtype=torch.float32))
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    # YaRN's factor on cos and sin, yarn_mscale(mscale) / yarn_mscale(mscale_all_dim),
    # is 1 here: the published config's two are equal
    return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).flatten(-2)


def _mla(p, h):
    B, S, _ = h.shape
    r = p["kv_norm"]["scale"].shape[0]
    rope = p["kv_a"]["w"].shape[1] - r
    qo, kvbo, vo = p["q"]["w"].shape[1], p["kv_b"]["w"].shape[1], p["o"]["w"].shape[0]
    H = (qo + vo - kvbo) // rope
    nope, v_dim = qo // H - rope, vo // H
    q = (h @ p["q"]["w"]).reshape(B, S, H, nope + rope)
    a = h @ p["kv_a"]["w"]
    c, k_pe = a[..., :r], a[..., r:]
    kv = (_rmsnorm(p["kv_norm"]["scale"], c) @ p["kv_b"]["w"]).reshape(B, S, H, nope + v_dim)
    inv = yarn_inv_freq(rope)
    q = torch.cat([q[..., :nope], _rope(q[..., nope:], inv)], dim=-1)
    k_pe = _rope(k_pe[:, :, None, :], inv).expand(B, S, H, rope)
    k = torch.cat([kv[..., :nope], k_pe], dim=-1)
    v = kv[..., nope:]
    scale = (nope + rope) ** -0.5 * _yarn_mscale(YARN["factor"], YARN["mscale_all_dim"]) ** 2
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    causal = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
    w = torch.softmax(torch.where(causal, s, torch.finfo(s.dtype).min), dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(B, S, H * v_dim)
    return o @ p["o"]["w"]


def _moe(p, h):
    """(out (B, S, D), balance loss averaged over the rows)."""
    B, S, D = h.shape
    E = p["router"]["w"].shape[1]
    probs = torch.softmax(h @ p["router"]["w"], dim=-1)
    weights, ids = torch.topk(probs, TOP_K, dim=-1)
    weights = weights * ROUTED_SCALE
    counts = F.one_hot(ids, E).sum(dim=(1, 2)).to(probs.dtype)  # (B, E): each row's choices
    aux = AUX_ALPHA * ((counts * E / (S * TOP_K)) * probs.mean(dim=1)).sum(dim=-1).mean()
    cap = max(1, int(CAPACITY_FACTOR * S * TOP_K / E))
    flat = h.reshape(B * S, D)
    out = _swiglu(p["shared"]["gate"]["w"], p["shared"]["up"]["w"], p["shared"]["down"]["w"],
                  flat)
    for e in range(p["gate"].shape[0]):
        hit = ids == HELD_START + e  # (B, S, K)
        chosen = hit.any(dim=-1)
        rank = torch.cumsum(chosen.long(), dim=1) - 1  # its place among the row's choosers
        tokens = torch.nonzero((chosen & (rank < cap)).reshape(-1)).reshape(-1)
        w = (weights * hit).sum(dim=-1).reshape(-1)[tokens]
        y = _swiglu(p["gate"][e], p["up"][e], p["down"][e], flat[tokens])
        out = out.index_add(0, tokens, y * w[:, None])
    return out.reshape(B, S, D), aux


def _layer(tree, i):
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def loss(params, tokens, targets):
    """Mean next-token cross-entropy of tokens (B, S) against targets
    (B, S), plus the MoE layers' balance losses."""
    x = params["embed"]["table"][tokens.long()]
    aux = 0.0
    for group in ("dense", "blocks"):
        for i in range(params[group]["ln1"]["scale"].shape[0]):
            p = _layer(params[group], i)
            x = x + _mla(p["attn"], _rmsnorm(p["ln1"]["scale"], x))
            h = _rmsnorm(p["ln2"]["scale"], x)
            if "moe" in p:
                m, a = _moe(p["moe"], h)
                aux = aux + a
            else:
                m = _swiglu(p["mlp"]["gate"]["w"], p["mlp"]["up"]["w"], p["mlp"]["down"]["w"], h)
            x = x + m
    logits = _rmsnorm(params["norm"]["scale"], x) @ params["head"]["w"]
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), targets.reshape(-1).long())
    return ce + aux
