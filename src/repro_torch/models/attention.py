"""Attention: GQA/MHA with RoPE, qk-norm, QKV-bias, sliding-window and
cross-attention variants, plus KV-cache prefill/decode paths.

Written as the JAX package writes it, scores in f32 masked with -1e30 and
the blockwise online softmax above ``BLOCKWISE_THRESHOLD``, rather than
through ``scaled_dot_product_attention``, so that the two packages agree on
the CPU.  The blockwise path carries the reference's sharding hints
(`repro_torch.sharding.hints`) at the same tensors: inert without an active
mapping, and never a change of value.

Sliding-window training/prefill uses the chunked two-block scheme (each
window-sized chunk attends to itself causally and to the previous chunk with
a distance mask) giving O(S·2W) score memory instead of O(S²).

The KV cache is functional, as in the reference: ``decode_attention``
returns a new cache and leaves its argument as it was.  The position
counter stays a tensor on the cache's device, so decoding never waits on
the host.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common
from repro_torch.sharding.hints import hint

NEG_INF = -1e30


def init_attention(gen, cfg: ModelConfig, *, cross: bool = False, lead=()):
    d, hd = cfg.d_model, cfg.hd
    p = {
        "q": common.init_dense(gen, d, cfg.n_heads * hd, cfg.pdtype, bias=cfg.qkv_bias,
                               lead=lead),
        "k": common.init_dense(gen, d, cfg.n_kv * hd, cfg.pdtype, bias=cfg.qkv_bias,
                               lead=lead),
        "v": common.init_dense(gen, d, cfg.n_kv * hd, cfg.pdtype, bias=cfg.qkv_bias,
                               lead=lead),
        "o": common.init_dense(gen, cfg.n_heads * hd, d, cfg.pdtype, lead=lead),
    }
    if cfg.qk_norm and not cross:
        p["qn"] = common.init_rmsnorm(hd, cfg.pdtype, device=gen.device, lead=lead)
        p["kn"] = common.init_rmsnorm(hd, cfg.pdtype, device=gen.device, lead=lead)
    return p


def _project_q(p, x, cfg: ModelConfig):
    B, S = x.shape[:2]
    q = common.dense(p["q"], x, cdtype=cfg.cdtype).reshape(B, S, cfg.n_heads, cfg.hd)
    if "qn" in p:
        q = common.rmsnorm(p["qn"], q, eps=cfg.norm_eps)
    return q


def _project_kv(p, x, cfg: ModelConfig):
    B, S = x.shape[:2]
    k = common.dense(p["k"], x, cdtype=cfg.cdtype).reshape(B, S, cfg.n_kv, cfg.hd)
    v = common.dense(p["v"], x, cdtype=cfg.cdtype).reshape(B, S, cfg.n_kv, cfg.hd)
    if "kn" in p:
        k = common.rmsnorm(p["kn"], k, eps=cfg.norm_eps)
    return k, v


def _gqa_scores(q, k, cfg: ModelConfig):
    """q (B,Sq,H,hd), k (B,Sk,Kv,hd) -> scores (B,Kv,G,Sq,Sk) with G=H/Kv."""
    B, Sq, H, hd = q.shape
    G = H // cfg.n_kv
    qg = q.reshape(B, Sq, cfg.n_kv, G, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k) * (hd**-0.5)
    return s.float()


def _gqa_out(scores, v, p, cfg: ModelConfig):
    """scores (B,Kv,G,Sq,Sk) f32 post-softmax, v (B,Sk,Kv,hd) -> (B,Sq,D)."""
    B, Kv, G, Sq, _ = scores.shape
    o = torch.einsum("bkgqs,bskh->bqkgh", scores.to(cfg.cdtype), v)
    o = o.reshape(B, Sq, cfg.n_heads * cfg.hd)
    return common.dense(p["o"], o, cdtype=cfg.cdtype)


# Above this sequence length the quadratic score tensor is replaced by the
# blockwise online-softmax path (the flash-attention recurrence in torch ops).
BLOCKWISE_THRESHOLD = 2048
Q_CHUNK = 512
KV_CHUNK = 1024


def blockwise_gqa(q, k, v, *, pos_q, pos_k, causal: bool, window: int,
                  cfg: ModelConfig, q_chunk: int = Q_CHUNK, kv_chunk: int = KV_CHUNK):
    """Flash-style attention: nested loops over (q chunks × kv blocks) with
    the online-softmax recurrence — peak score buffer is (B, Kv, G, qc, kc)
    instead of (B, H, S, S).  Supports causal and sliding-window masks.

    q (B,Sq,H,hd) / k,v (B,Sk,Kv,hd) post-RoPE.  Returns (B, Sq, H·hd).
    """
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    Kv = cfg.n_kv
    G = H // Kv
    qc = min(q_chunk, Sq)
    kc = min(kv_chunk, Sk)
    assert Sq % qc == 0 and Sk % kc == 0, (Sq, qc, Sk, kc)
    nq, nk = Sq // qc, Sk // kc
    scale = hd**-0.5

    # the reference's stable layout for the nested loops (see
    # sharding/hints.py): batch → client axes, the q-chunk dim → "model",
    # K/V blocks replicated over "model"
    qr = hint(q.reshape(B, nq, qc, Kv, G, hd), "batch", None, "qchunk", None, None, None)
    kr = hint(k.reshape(B, nk, kc, Kv, hd), "batch", None, None, None, None)
    vr = hint(v.reshape(B, nk, kc, Kv, hd), "batch", None, None, None, None)
    pq = hint(pos_q.reshape(B, nq, qc), "batch", None, "qchunk")
    pk = pos_k.reshape(B, nk, kc)

    chunks = []
    for i in range(nq):
        q_blk, pq_blk = qr[:, i], pq[:, i]  # (B,qc,Kv,G,hd), (B,qc)
        m = hint(torch.full((B, Kv, G, qc), NEG_INF, dtype=torch.float32, device=q.device),
                 "batch", None, None, "qchunk")
        l = hint(torch.zeros((B, Kv, G, qc), dtype=torch.float32, device=q.device),
                 "batch", None, None, "qchunk")
        acc = hint(torch.zeros((B, Kv, G, qc, hd), dtype=torch.float32, device=q.device),
                   "batch", None, None, "qchunk", None)
        for j in range(nk):
            k_blk, v_blk, pk_blk = kr[:, j], vr[:, j], pk[:, j]
            s = torch.einsum("bqkgh,bskh->bkgqs", q_blk, k_blk).float() * scale
            valid = torch.ones((B, 1, 1, qc, kc), dtype=torch.bool, device=q.device)
            if causal:
                valid = valid & (pk_blk[:, None, None, None, :]
                                 <= pq_blk[:, None, None, :, None])
            if window:
                valid = valid & (pk_blk[:, None, None, None, :]
                                 > (pq_blk[:, None, None, :, None] - window))
            s = torch.where(valid, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            corr = torch.exp(m - m_new)
            p_ = torch.exp(s - m_new[..., None])
            l = l * corr + p_.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqs,bskh->bkgqh", p_.to(v_blk.dtype), v_blk
            ).float()
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        chunks.append(out.to(q.dtype))  # (B,Kv,G,qc,hd)
    out = torch.stack(chunks, dim=1)  # (B,nq,Kv,G,qc,hd)
    out = torch.movedim(out, 4, 2)     # (B,nq,qc,Kv,G,hd)
    return out.reshape(B, Sq, H * hd)


def full_attention(p, x, positions, cfg: ModelConfig, *, causal: bool = True):
    """Training / prefill path.  Quadratic for short sequences, blockwise
    online-softmax beyond BLOCKWISE_THRESHOLD.  Returns (out, (k, v))."""
    q = _project_q(p, x, cfg)
    k, v = _project_kv(p, x, cfg)
    q = common.apply_rope(q, positions, cfg)
    k = common.apply_rope(k, positions, cfg)
    if x.shape[1] > BLOCKWISE_THRESHOLD:
        o = blockwise_gqa(
            q, k, v, pos_q=positions, pos_k=positions, causal=causal, window=0,
            cfg=cfg,
        )
        return common.dense(p["o"], o, cdtype=cfg.cdtype), (k, v)
    scores = _gqa_scores(q, k, cfg)
    if causal:
        mask = positions[:, None, None, :, None] >= positions[:, None, None, None, :]
        scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    return _gqa_out(w, v, p, cfg), (k, v)


def sliding_window_attention(p, x, positions, cfg: ModelConfig, *, window: int):
    """Chunked SWA (train/prefill): chunks of size W attend to (prev, self).

    Requires S % W == 0 (shorter tails are end-padded); exact for
    row-contiguous positions.  Returns (out, (k, v)) where k, v cover the
    full sequence.
    """
    B, S, _ = x.shape
    W = window
    if S <= W:
        return full_attention(p, x, positions, cfg, causal=True)
    if S > BLOCKWISE_THRESHOLD:
        # long-sequence path: blockwise online softmax with the window mask
        q = _project_q(p, x, cfg)
        k, v = _project_kv(p, x, cfg)
        q = common.apply_rope(q, positions, cfg)
        k = common.apply_rope(k, positions, cfg)
        o = blockwise_gqa(
            q, k, v, pos_q=positions, pos_k=positions, causal=True, window=W,
            cfg=cfg,
        )
        return common.dense(p["o"], o, cdtype=cfg.cdtype), (k, v)
    if S % W:
        # end-pad to a multiple of W: padded keys sit at later positions than
        # every real query, so the causal chunk mask already excludes them
        # (the pad value is irrelevant for the same reason)
        pad = W - S % W
        xp = F.pad(x, (0, 0, 0, pad))
        pp = F.pad(positions, (0, pad))
        out, (k, v) = sliding_window_attention(p, xp, pp, cfg, window=W)
        return out[:, :S], (k[:, :S], v[:, :S])
    nc = S // W
    q = _project_q(p, x, cfg)
    k, v = _project_kv(p, x, cfg)
    q = common.apply_rope(q, positions, cfg)
    k = common.apply_rope(k, positions, cfg)

    hd, Kv = cfg.hd, cfg.n_kv
    G = cfg.n_heads // Kv
    qc = q.reshape(B, nc, W, cfg.n_heads, hd)
    kc = k.reshape(B, nc, W, Kv, hd)
    vc = v.reshape(B, nc, W, Kv, hd)
    # previous chunk (chunk 0's "previous" is masked out entirely)
    kp = torch.cat([torch.zeros_like(kc[:, :1]), kc[:, :-1]], dim=1)
    vp = torch.cat([torch.zeros_like(vc[:, :1]), vc[:, :-1]], dim=1)
    k2 = torch.cat([kp, kc], dim=2)  # (B, nc, 2W, Kv, hd)
    v2 = torch.cat([vp, vc], dim=2)
    qg = qc.reshape(B, nc, W, Kv, G, hd)
    scores = torch.einsum("bcqkgh,bcskh->bckgqs", qg, k2).float() * (hd**-0.5)
    i = torch.arange(W, device=x.device)[:, None]
    j = torch.arange(2 * W, device=x.device)[None, :]
    # prev half (j < W): valid iff j > i (distance < W); own half: causal j-W <= i
    mask = torch.where(j < W, j > i, (j - W) <= i)
    first = (torch.arange(nc, device=x.device) == 0)[:, None, None]
    mask = mask[None] & (~first | (j[None] >= W))  # chunk 0 has no prev
    scores = torch.where(mask[None, :, None, None], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    o = torch.einsum("bckgqs,bcskh->bcqkgh", w.to(cfg.cdtype), v2)
    o = o.reshape(B, S, cfg.n_heads * hd)
    return common.dense(p["o"], o, cdtype=cfg.cdtype), (k, v)


def cross_attention(p, x, kv_src_k, kv_src_v, cfg: ModelConfig):
    """Decoder attends to a fixed encoder/vision memory (no mask, no rope)."""
    q = _project_q(p, x, cfg)
    Sq, Sk = x.shape[1], kv_src_k.shape[1]
    if Sq > BLOCKWISE_THRESHOLD and Sq * Sk > BLOCKWISE_THRESHOLD**2:
        B = x.shape[0]
        pos_q = torch.zeros((B, Sq), dtype=torch.int32, device=x.device)
        # memory length rarely divides KV_CHUNK: pad keys, mask via pos_k = 1
        kc = min(KV_CHUNK, Sk)
        pad = (-Sk) % kc
        kp = F.pad(kv_src_k, (0, 0, 0, 0, 0, pad))
        vp = F.pad(kv_src_v, (0, 0, 0, 0, 0, pad))
        pos_k = F.pad(torch.zeros((B, Sk), dtype=torch.int32, device=x.device),
                      (0, pad), value=1)
        o = blockwise_gqa(
            q, kp, vp, pos_q=pos_q, pos_k=pos_k, causal=True, window=0, cfg=cfg
        )  # "causal" here means: mask pos_k(=1 on pads) > pos_q(=0) — pads only
        return common.dense(p["o"], o, cdtype=cfg.cdtype)
    scores = _gqa_scores(q, kv_src_k, cfg)
    w = torch.softmax(scores, dim=-1)
    return _gqa_out(w, kv_src_v, p, cfg)


def project_memory(p, mem, cfg: ModelConfig):
    """Precompute cross-attention K/V from encoder/vision memory."""
    return _project_kv(p, mem, cfg)


# --------------------------------------------------------------------------
# KV cache (ring buffer; capacity = min(seq_len, window) for SWA archs)
# --------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, capacity: int, *, device=None):
    return {
        "k": torch.zeros((batch, capacity, cfg.n_kv, cfg.hd), dtype=cfg.cdtype,
                         device=device),
        "v": torch.zeros((batch, capacity, cfg.n_kv, cfg.hd), dtype=cfg.cdtype,
                         device=device),
        "pos": torch.full((capacity,), -(2**30), dtype=torch.int32, device=device),
    }


def fill_cache_from_prefill(cache, k, v, prefill_len: int):
    """Write the last `capacity` positions of a prefill into the ring.

    The slot layout is statically known and contiguous modulo one wrap, so
    this is at most two block writes — never an index scatter.
    """
    cap = cache["k"].shape[1]
    take = min(cap, prefill_len)
    start_pos = prefill_len - take
    start_slot = start_pos % cap
    first = min(take, cap - start_slot)  # length before the ring wraps

    kk, vv = k[:, -take:], v[:, -take:]
    pos_vals = torch.arange(start_pos, prefill_len, dtype=torch.int32,
                            device=cache["pos"].device)
    ck, cv, cp = cache["k"].clone(), cache["v"].clone(), cache["pos"].clone()
    ck[:, start_slot:start_slot + first] = kk[:, :first].to(ck.dtype)
    cv[:, start_slot:start_slot + first] = vv[:, :first].to(cv.dtype)
    cp[start_slot:start_slot + first] = pos_vals[:first]
    if first < take:  # wrapped tail goes to slot 0
        ck[:, :take - first] = kk[:, first:].to(ck.dtype)
        cv[:, :take - first] = vv[:, first:].to(cv.dtype)
        cp[:take - first] = pos_vals[first:]
    return {"k": ck, "v": cv, "pos": cp}


def decode_attention(p, x1, cache, pos, cfg: ModelConfig, *, window: int = 0):
    """One-token decode.  x1 (B,1,D); pos a 0-d int tensor (next position
    index) on the cache's device.

    Returns (out (B,1,D), new cache).
    """
    B = x1.shape[0]
    cap = cache["k"].shape[1]
    q = _project_q(p, x1, cfg)
    k1, v1 = _project_kv(p, x1, cfg)
    pos = pos.to(torch.int32)
    pos_arr = pos.reshape(1, 1).expand(B, 1)
    q = common.apply_rope(q, pos_arr, cfg)
    k1 = common.apply_rope(k1, pos_arr, cfg)
    slot = torch.remainder(pos, cap).reshape(1).long()
    ck = cache["k"].index_copy(1, slot, k1.to(cache["k"].dtype))
    cv = cache["v"].index_copy(1, slot, v1.to(cache["v"].dtype))
    cpos = cache["pos"].index_copy(0, slot, pos.reshape(1))
    scores = _gqa_scores(q, ck, cfg)  # (B,Kv,G,1,cap)
    valid = (cpos >= 0) & (cpos <= pos)  # empty slots hold -2**30
    if window:
        valid = valid & (cpos > pos - window)
    scores = torch.where(valid[None, None, None, None, :], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = _gqa_out(w, cv, p, cfg)
    return out, {"k": ck, "v": cv, "pos": cpos}


# --------------------------------------------------------------------------
# Multi-head latent attention (DeepSeek-V2, arXiv:2405.04434 §2.1) and a
# causal attention whose backward recomputes its blocks
# --------------------------------------------------------------------------

# query rows a block of the recomputing attention: its transient scores are
# (B, H, MLA_Q_CHUNK, keys up to the block's end)
MLA_Q_CHUNK = 512


def init_mla(gen, cfg, *, lead=()):
    """W_q (no query LoRA), W_kva (the latent and the shared RoPE key), the
    latent's RMSNorm, W_kvb (per-head no-position keys and values) and
    W_o."""
    d, H, m = cfg.d_model, cfg.n_heads, cfg.mla
    return {
        "q": common.init_dense(gen, d, H * m.qk_dim, cfg.pdtype, lead=lead),
        "kv_a": common.init_dense(gen, d, m.kv_lora_rank + m.qk_rope_dim, cfg.pdtype,
                                  lead=lead),
        "kv_norm": common.init_rmsnorm(m.kv_lora_rank, cfg.pdtype, device=gen.device,
                                       lead=lead),
        "kv_b": common.init_dense(gen, m.kv_lora_rank, H * (m.qk_nope_dim + m.v_head_dim),
                                  cfg.pdtype, lead=lead),
        "o": common.init_dense(gen, H * m.v_head_dim, d, cfg.pdtype, lead=lead),
    }


def mla_attention(p, x, positions, cfg):
    """Causal MLA over x (B, S, D) at positions 0..S−1 (B, S): q = W_q h
    split into q_nope and q_pe a head; [c_kv; k_pe] = W_kva h, c_kv ←
    RMSNorm(c_kv); [k_nope; v] = W_kvb c_kv a head; YaRN RoPE on q_pe and
    on the one k_pe all heads share; softmax at
    :func:`common.mla_softmax_scale`; W_o.  Returns (B, S, D)."""
    B, S, _ = x.shape
    H, m = cfg.n_heads, cfg.mla
    q = common.dense(p["q"], x, cdtype=cfg.cdtype).reshape(B, S, H, m.qk_dim)
    q_nope, q_pe = q.split([m.qk_nope_dim, m.qk_rope_dim], dim=-1)
    c_kv, k_pe = common.dense(p["kv_a"], x, cdtype=cfg.cdtype).split(
        [m.kv_lora_rank, m.qk_rope_dim], dim=-1)
    c_kv = common.rmsnorm(p["kv_norm"], c_kv, eps=cfg.norm_eps)
    kv = common.dense(p["kv_b"], c_kv, cdtype=cfg.cdtype).reshape(
        B, S, H, m.qk_nope_dim + m.v_head_dim)
    k_nope, v = kv.split([m.qk_nope_dim, m.v_head_dim], dim=-1)
    inv = common.yarn_rope_freqs(cfg, x.device)
    q_pe = common.apply_rope_inv(q_pe, positions, inv, m.qk_rope_dim)
    k_pe = common.apply_rope_inv(k_pe[:, :, None, :], positions, inv, m.qk_rope_dim)
    q = torch.cat([q_nope, q_pe], dim=-1)
    k = torch.cat([k_nope, k_pe.expand(B, S, H, m.qk_rope_dim)], dim=-1)
    o = causal_attention(q, k, v, scale=common.mla_softmax_scale(cfg))
    return common.dense(p["o"], o.reshape(B, S, H * m.v_head_dim), cdtype=cfg.cdtype)


def causal_attention(q, k, v, *, scale: float, q_chunk: int = MLA_Q_CHUNK):
    """softmax(scale · q kᵀ, causal) v for q, k (B, S, H, dk) and v (B, S, H,
    dv) at positions 0..S−1; returns (B, S, H, dv).  Computed a block of
    ``q_chunk`` query rows at a time against the keys up to the block's end
    (the blocks above the diagonal are never computed), each row's softmax
    whole.  The backward keeps q, k, v, the output and each row's
    log-sum-exp only, and recomputes each block's probabilities from them,
    so no (S, S) tensor outlives its block.  Composes with
    ``torch.func.vmap(grad)`` (its vmap rule is generated from these torch
    ops) and with CUDA-graph capture (nothing waits on the host)."""
    return _CausalAttention.apply(q, k, v, float(scale), min(int(q_chunk), q.shape[1]))[0]


def _blocks(S: int, qc: int):
    return [(a, min(a + qc, S)) for a in range(0, S, qc)]


def _block_scores(qh, kh, a: int, b: int, scale: float):
    """Scores of query rows [a, b) against keys [0, b), (..., H, b − a, b),
    causally masked with NEG_INF."""
    s = (qh[..., a:b, :] @ kh[..., :b, :].transpose(-1, -2)) * scale
    rows = torch.arange(a, b, device=qh.device)[:, None]
    cols = torch.arange(b, device=qh.device)[None, :]
    return torch.where(cols <= rows, s, NEG_INF)


class _CausalAttention(torch.autograd.Function):
    """The blocks of :func:`causal_attention`: forward returns (out, lse),
    backward recomputes P = exp(S − lse) a block at a time (FlashAttention-2's
    backward in torch ops: dV = Pᵀ dO, dP = dO Vᵀ, dS = P ∘ (dP − rowsum(dO ∘
    O)), dQ = scale · dS K, dK = scale · dSᵀ Q)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(q, k, v, scale, qc):
        # (B, H, S, d) contiguous, so each block is a strided batch of matrices
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        S = q.shape[1]
        outs, lses = [], []
        for a, b in _blocks(S, qc):
            s = _block_scores(qh, kh, a, b, scale)
            lse = torch.logsumexp(s, dim=-1)
            outs.append(torch.exp(s - lse[..., None]) @ vh[..., :b, :])
            lses.append(lse)
        out = torch.cat(outs, dim=-2).transpose(1, 2)  # (B, S, H, dv)
        return out, torch.cat(lses, dim=-1)  # lse (B, H, S)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, scale, qc = inputs
        out, lse = output
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.qc = scale, qc
        ctx.mark_non_differentiable(lse)

    @staticmethod
    @once_differentiable
    def backward(ctx, dout, _dlse):
        # once differentiable: under ``torch.func.grad`` (create_graph=True)
        # nothing of this backward is recorded, so no block's probabilities
        # outlive it
        q, k, v, out, lse = ctx.saved_tensors
        scale, S = ctx.scale, q.shape[1]
        qh, kh, vh, doh = (t.transpose(1, 2).contiguous() for t in (q, k, v, dout))
        delta = (dout * out).sum(dim=-1).transpose(1, 2)  # (B, H, S)
        dqs, dk, dv = [], None, None
        for a, b in _blocks(S, ctx.qc):
            p = torch.exp(_block_scores(qh, kh, a, b, scale) - lse[..., a:b, None])
            do = doh[..., a:b, :]
            ds = p * (do @ vh[..., :b, :].transpose(-1, -2) - delta[..., a:b, None]) * scale
            dqs.append(ds @ kh[..., :b, :])
            # the keys [0, b) this block reaches, padded to S rows
            pad = (0, 0, 0, S - b)
            dk_b = F.pad(ds.transpose(-1, -2) @ qh[..., a:b, :], pad)
            dv_b = F.pad(p.transpose(-1, -2) @ do, pad)
            dk = dk_b if dk is None else dk + dk_b
            dv = dv_b if dv is None else dv + dv_b
        dq = torch.cat(dqs, dim=-2)
        return dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2), None, None
