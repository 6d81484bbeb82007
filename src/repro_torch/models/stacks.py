"""Model assembly: full LM stacks per architecture family.

Every family exposes the same entry points consumed by the FL engine and
the serving path:

    init(seed, cfg, device=None)            -> params
    loss(params, cfg, batch)                -> scalar loss
    prefill(params, cfg, batch)             -> (last_logits, cache)
    decode(params, cfg, cache, tokens)      -> (logits, cache)
    (plus ``registry.input_specs`` for shapes)

Layer stacks are stacked parameter trees, as in the JAX package; where it
runs ``lax.scan`` over the stack, a Python loop indexes layer i here, and
decode caches come back stacked (``{"layers": …, "t": …}``).  The JAX
package wraps every scanned train block in ``jax.checkpoint`` (remat); that
changes memory, not numbers, and ``torch.utils.checkpoint`` does not
compose with the simulator's ``torch.func.vmap(grad)``, so it is left out.
Cross-entropy is computed in sequence chunks so the (B, S, V) logits
tensor is never materialized.

``init`` draws from a ``torch.Generator(device).manual_seed(seed)`` on the
target device (the GPU unless ``device`` says otherwise), each stacked leaf
once at its full (L, …) shape.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, common, mamba, moe, rglru
from repro_torch.utils import resolve_device, tree_map

CE_CHUNK = 256


# --------------------------------------------------------------------------
# shared pieces
# --------------------------------------------------------------------------


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=resolve_device(device)).manual_seed(seed)


def _layer(tree, i: int):
    """Layer i of a stacked tree (views, no copy)."""
    return tree_map(lambda x: x[i], tree)


def _stack(trees: list):
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def _broadcast(tree, lead: tuple):
    """Each leaf repeated along new leading dims ``lead``."""
    return tree_map(lambda leaf: leaf.expand(*lead, *leaf.shape).clone(), tree)


def _t(value: int, device):
    return torch.tensor(value, dtype=torch.int32, device=device)


def _positions(B, S, offset=0, *, device=None):
    pos = torch.arange(S, dtype=torch.int32, device=device)[None] + offset
    return pos.expand(B, S)


def _init_dense_block(gen, cfg: ModelConfig, lead=()):
    dev = gen.device
    p = {
        "ln1": common.init_rmsnorm(cfg.d_model, cfg.pdtype, device=dev, lead=lead),
        "attn": attention.init_attention(gen, cfg, lead=lead),
        "ln2": common.init_rmsnorm(cfg.d_model, cfg.pdtype, device=dev, lead=lead),
    }
    if cfg.family == "moe":
        p["moe"] = moe.init_moe(gen, cfg, lead=lead)
    else:
        p["mlp"] = common.init_mlp(gen, cfg, lead=lead)
    return p


def _dense_block(p, x, positions, cfg: ModelConfig, *, collect_kv=False):
    h = common.rmsnorm(p["ln1"], x, eps=cfg.norm_eps)
    if cfg.sliding_window:
        a, kv = attention.sliding_window_attention(
            p["attn"], h, positions, cfg, window=cfg.sliding_window
        )
    else:
        a, kv = attention.full_attention(p["attn"], h, positions, cfg, causal=True)
    x = x + a
    h = common.rmsnorm(p["ln2"], x, eps=cfg.norm_eps)
    if "moe" in p:
        m, aux = moe.moe_ffn(p["moe"], h, cfg)
    else:
        m, aux = common.mlp(p["mlp"], h, cfg), torch.zeros((), device=x.device)
    x = x + m
    return x, aux, (kv if collect_kv else None)


def _dense_block_decode(p, x1, cache, pos, cfg: ModelConfig):
    h = common.rmsnorm(p["ln1"], x1, eps=cfg.norm_eps)
    a, cache = attention.decode_attention(
        p["attn"], h, cache, pos, cfg, window=cfg.sliding_window
    )
    x1 = x1 + a
    h = common.rmsnorm(p["ln2"], x1, eps=cfg.norm_eps)
    if "moe" in p:
        m, _ = moe.moe_ffn(p["moe"], h, cfg)
    else:
        m = common.mlp(p["mlp"], h, cfg)
    return x1 + m, cache


def _logits(params, cfg: ModelConfig, x):
    x = common.rmsnorm(params["norm"], x, eps=cfg.norm_eps)
    if cfg.tie_embeddings:
        return common.unembed(params["embed"], x, cdtype=cfg.cdtype)
    return common.dense(params["head"], x, cdtype=cfg.cdtype)


def _chunked_ce(params, cfg: ModelConfig, x, labels):
    """Mean CE without materializing (B, S, V).  x (B,S,D), labels (B,S)."""
    B, S, _ = x.shape
    c = min(CE_CHUNK, S)
    assert S % c == 0
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(S // c):
        logits = _logits(params, cfg, x[:, i * c:(i + 1) * c])
        total = total + common.cross_entropy(logits, labels[:, i * c:(i + 1) * c]) * (c / S)
    return total


def _cache_capacity(cfg: ModelConfig, total_len: int) -> int:
    w = cfg.sliding_window
    return min(total_len, w) if w else total_len


# Ring-buffer headroom reserved by prefill so subsequent decode steps do not
# evict live positions of full-attention caches.
PREFILL_HEADROOM = 128


# --------------------------------------------------------------------------
# dense / moe LM
# --------------------------------------------------------------------------


def init_lm(seed: int, cfg: ModelConfig, *, device=None):
    gen = _generator(seed, device)
    params = {
        "embed": common.init_embedding(gen, cfg.vocab, cfg.d_model, cfg.pdtype),
        "blocks": common.stack_layers(
            lambda g, lead: _init_dense_block(g, cfg, lead), gen, cfg.n_layers
        ),
        "norm": common.init_rmsnorm(cfg.d_model, cfg.pdtype, device=gen.device),
    }
    if not cfg.tie_embeddings:
        params["head"] = common.init_dense(gen, cfg.d_model, cfg.vocab, cfg.pdtype)
    return params


def lm_backbone(params, cfg: ModelConfig, tokens):
    B, S = tokens.shape
    x = common.embed(params["embed"], tokens, cdtype=cfg.cdtype)
    pos = _positions(B, S, device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_layers):
        x, a, _ = _dense_block(_layer(params["blocks"], i), x, pos, cfg)
        aux = aux + a
    return x, aux


def lm_loss(params, cfg: ModelConfig, batch):
    x, aux = lm_backbone(params, cfg, batch["tokens"])
    return _chunked_ce(params, cfg, x, batch["labels"]) + aux


def lm_prefill(params, cfg: ModelConfig, batch):
    tokens = batch["tokens"]
    B, S = tokens.shape
    cap = _cache_capacity(cfg, S + PREFILL_HEADROOM)
    x = common.embed(params["embed"], tokens, cdtype=cfg.cdtype)
    pos = _positions(B, S, device=x.device)
    caches = []
    for i in range(cfg.n_layers):
        x, _, (k, v) = _dense_block(_layer(params["blocks"], i), x, pos, cfg,
                                    collect_kv=True)
        caches.append(attention.fill_cache_from_prefill(
            attention.init_cache(cfg, B, cap, device=x.device), k, v, S))
    logits = _logits(params, cfg, x[:, -1:])
    return logits, {"layers": _stack(caches), "t": _t(S, x.device)}


def lm_init_cache(cfg: ModelConfig, batch_size: int, seq_len: int, *, device=None):
    """Cache stand-in for decode: full cache of `seq_len` tokens."""
    cap = _cache_capacity(cfg, seq_len)
    one = attention.init_cache(cfg, batch_size, cap, device=device)
    return {"layers": _broadcast(one, (cfg.n_layers,)), "t": _t(seq_len, device)}


def lm_decode(params, cfg: ModelConfig, cache, tokens):
    """tokens (B, 1) -> (logits (B, 1, V), new cache)."""
    x = common.embed(params["embed"], tokens, cdtype=cfg.cdtype)
    pos = cache["t"]
    caches = []
    for i in range(cfg.n_layers):
        x, c = _dense_block_decode(_layer(params["blocks"], i), x,
                                   _layer(cache["layers"], i), pos, cfg)
        caches.append(c)
    return _logits(params, cfg, x), {"layers": _stack(caches), "t": pos + 1}


# --------------------------------------------------------------------------
# DeepSeek-V2: MLA in every layer; ``first_dense`` leading layers with a dense
# SwiGLU, then DeepSeekMoE layers; an untied head
# --------------------------------------------------------------------------


def _init_ds_block(gen, cfg, moe_layer: bool, lead=()):
    dev = gen.device
    p = {
        "ln1": common.init_rmsnorm(cfg.d_model, cfg.pdtype, device=dev, lead=lead),
        "attn": attention.init_mla(gen, cfg, lead=lead),
        "ln2": common.init_rmsnorm(cfg.d_model, cfg.pdtype, device=dev, lead=lead),
    }
    if moe_layer:
        p["moe"] = moe.init_ds_moe(gen, cfg, lead=lead)
    else:
        p["mlp"] = common.init_mlp(gen, cfg, lead=lead)
    return p


def init_deepseek(seed: int, cfg, *, device=None):
    """{"embed", "dense": the leading layers stacked, "blocks": the MoE
    layers stacked, "norm", "head"}."""
    gen = _generator(seed, device)
    return {
        "embed": common.init_embedding(gen, cfg.vocab, cfg.d_model, cfg.pdtype),
        "dense": common.stack_layers(
            lambda g, lead: _init_ds_block(g, cfg, False, lead), gen, cfg.first_dense),
        "blocks": common.stack_layers(
            lambda g, lead: _init_ds_block(g, cfg, True, lead), gen,
            cfg.n_layers - cfg.first_dense),
        "norm": common.init_rmsnorm(cfg.d_model, cfg.pdtype, device=gen.device),
        "head": common.init_dense(gen, cfg.d_model, cfg.vocab, cfg.pdtype),
    }


def _ds_block(p, x, positions, cfg):
    x = x + attention.mla_attention(p["attn"], common.rmsnorm(p["ln1"], x, eps=cfg.norm_eps),
                                    positions, cfg)
    h = common.rmsnorm(p["ln2"], x, eps=cfg.norm_eps)
    if "moe" in p:
        m, aux, counters = moe.ds_moe_ffn(p["moe"], h, cfg)
        return x + m, aux, counters
    return x + common.mlp(p["mlp"], h, cfg), None, None


def deepseek_backbone(params, cfg, tokens):
    """(hidden states (B, S, D), the MoE layers' balance losses summed, their
    counters summed)."""
    B, S = tokens.shape
    x = common.embed(params["embed"], tokens, cdtype=cfg.cdtype)
    pos = _positions(B, S, device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    counters = None
    for i in range(cfg.first_dense):
        x, _, _ = _ds_block(_layer(params["dense"], i), x, pos, cfg)
    for i in range(cfg.n_layers - cfg.first_dense):
        x, a, c = _ds_block(_layer(params["blocks"], i), x, pos, cfg)
        aux = aux + a
        counters = c if counters is None else tree_map(torch.add, counters, c)
    return x, aux, counters


def deepseek_loss(params, cfg, batch):
    """(mean next-token CE + the balance losses, the MoE counters): the
    counters ride beside the loss out of the local update
    (``FLSimulator``'s gradient of a loss with counters)."""
    x, aux, counters = deepseek_backbone(params, cfg, batch["tokens"])
    return _chunked_ce(params, cfg, x, batch["labels"]) + aux, counters


# --------------------------------------------------------------------------
# VLM: groups of (cross_attn_every - 1) self layers + 1 gated cross layer
# --------------------------------------------------------------------------


def _init_cross_block(gen, cfg: ModelConfig, lead=()):
    dev = gen.device
    return {
        "ln1": common.init_rmsnorm(cfg.d_model, cfg.pdtype, device=dev, lead=lead),
        "xattn": attention.init_attention(gen, cfg, cross=True, lead=lead),
        "gate_a": torch.zeros(lead, dtype=cfg.pdtype, device=dev),
        "ln2": common.init_rmsnorm(cfg.d_model, cfg.pdtype, device=dev, lead=lead),
        "mlp": common.init_mlp(gen, cfg, lead=lead),
        "gate_m": torch.zeros(lead, dtype=cfg.pdtype, device=dev),
    }


def _cross_block(p, x, mem_k, mem_v, cfg: ModelConfig):
    h = common.rmsnorm(p["ln1"], x, eps=cfg.norm_eps)
    a = attention.cross_attention(p["xattn"], h, mem_k, mem_v, cfg)
    x = x + torch.tanh(p["gate_a"].float()).to(x.dtype) * a
    h = common.rmsnorm(p["ln2"], x, eps=cfg.norm_eps)
    m = common.mlp(p["mlp"], h, cfg)
    return x + torch.tanh(p["gate_m"].float()).to(x.dtype) * m


def _vlm_counts(cfg: ModelConfig):
    every = cfg.cross_attn_every
    return cfg.n_layers // every, every - 1


def init_vlm(seed: int, cfg: ModelConfig, *, device=None):
    gen = _generator(seed, device)
    n_groups, n_self = _vlm_counts(cfg)

    def init_group(g, lead):
        return {
            "selfs": common.stack_layers(
                lambda gg, ll: _init_dense_block(gg, cfg, ll), g, n_self, lead),
            "cross": _init_cross_block(g, cfg, lead),
        }

    return {
        "embed": common.init_embedding(gen, cfg.vocab, cfg.d_model, cfg.pdtype),
        "groups": common.stack_layers(init_group, gen, n_groups),
        "norm": common.init_rmsnorm(cfg.d_model, cfg.pdtype, device=gen.device),
        "head": common.init_dense(gen, cfg.d_model, cfg.vocab, cfg.pdtype),
    }


def vlm_backbone(params, cfg: ModelConfig, tokens, img_embeds):
    B, S = tokens.shape
    x = common.embed(params["embed"], tokens, cdtype=cfg.cdtype)
    pos = _positions(B, S, device=x.device)
    img = img_embeds.to(cfg.cdtype)
    n_groups, n_self = _vlm_counts(cfg)
    for gi in range(n_groups):
        gp = _layer(params["groups"], gi)
        for li in range(n_self):
            x, _, _ = _dense_block(_layer(gp["selfs"], li), x, pos, cfg)
        mk, mv = attention.project_memory(gp["cross"]["xattn"], img, cfg)
        x = _cross_block(gp["cross"], x, mk, mv, cfg)
    return x


def vlm_loss(params, cfg: ModelConfig, batch):
    x = vlm_backbone(params, cfg, batch["tokens"], batch["img_embeds"])
    return _chunked_ce(params, cfg, x, batch["labels"])


def vlm_prefill(params, cfg: ModelConfig, batch):
    tokens, img = batch["tokens"], batch["img_embeds"].to(cfg.cdtype)
    B, S = tokens.shape
    cap = _cache_capacity(cfg, S + PREFILL_HEADROOM)
    x = common.embed(params["embed"], tokens, cdtype=cfg.cdtype)
    pos = _positions(B, S, device=x.device)
    n_groups, n_self = _vlm_counts(cfg)
    group_caches, mks, mvs = [], [], []
    for gi in range(n_groups):
        gp = _layer(params["groups"], gi)
        self_caches = []
        for li in range(n_self):
            x, _, (k, v) = _dense_block(_layer(gp["selfs"], li), x, pos, cfg,
                                        collect_kv=True)
            self_caches.append(attention.fill_cache_from_prefill(
                attention.init_cache(cfg, B, cap, device=x.device), k, v, S))
        mk, mv = attention.project_memory(gp["cross"]["xattn"], img, cfg)
        x = _cross_block(gp["cross"], x, mk, mv, cfg)
        group_caches.append(_stack(self_caches))
        mks.append(mk)
        mvs.append(mv)
    logits = _logits(params, cfg, x[:, -1:])
    return logits, {"layers": _stack(group_caches),
                    "mem_kv": (torch.stack(mks), torch.stack(mvs)),
                    "t": _t(S, x.device)}


def vlm_init_cache(cfg: ModelConfig, batch_size: int, seq_len: int, *, device=None):
    n_groups, n_self = _vlm_counts(cfg)
    cap = _cache_capacity(cfg, seq_len)
    one = attention.init_cache(cfg, batch_size, cap, device=device)
    mem = torch.zeros((n_groups, batch_size, cfg.n_image_tokens, cfg.n_kv, cfg.hd),
                      dtype=cfg.cdtype, device=device)
    return {"layers": _broadcast(one, (n_groups, n_self)), "mem_kv": (mem, mem.clone()),
            "t": _t(seq_len, device)}


def vlm_decode(params, cfg: ModelConfig, cache, tokens):
    x = common.embed(params["embed"], tokens, cdtype=cfg.cdtype)
    pos = cache["t"]
    n_groups, n_self = _vlm_counts(cfg)
    mks, mvs = cache["mem_kv"]
    group_caches = []
    for gi in range(n_groups):
        gp, gc = _layer(params["groups"], gi), _layer(cache["layers"], gi)
        new_caches = []
        for li in range(n_self):
            x, nc = _dense_block_decode(_layer(gp["selfs"], li), x, _layer(gc, li), pos, cfg)
            new_caches.append(nc)
        x = _cross_block(gp["cross"], x, mks[gi], mvs[gi], cfg)
        group_caches.append(_stack(new_caches))
    return _logits(params, cfg, x), {
        "layers": _stack(group_caches),
        "mem_kv": cache["mem_kv"],
        "t": pos + 1,
    }


# --------------------------------------------------------------------------
# encoder-decoder (whisper): stub frontend supplies frame embeddings
# --------------------------------------------------------------------------


def _init_enc_block(gen, cfg: ModelConfig, lead=()):
    dev = gen.device
    return {
        "ln1": common.init_rmsnorm(cfg.d_model, cfg.pdtype, device=dev, lead=lead),
        "attn": attention.init_attention(gen, cfg, lead=lead),
        "ln2": common.init_rmsnorm(cfg.d_model, cfg.pdtype, device=dev, lead=lead),
        "mlp": common.init_mlp(gen, cfg, lead=lead),
    }


def _init_dec_block(gen, cfg: ModelConfig, lead=()):
    dev = gen.device
    return {
        "ln1": common.init_rmsnorm(cfg.d_model, cfg.pdtype, device=dev, lead=lead),
        "attn": attention.init_attention(gen, cfg, lead=lead),
        "lnx": common.init_rmsnorm(cfg.d_model, cfg.pdtype, device=dev, lead=lead),
        "xattn": attention.init_attention(gen, cfg, cross=True, lead=lead),
        "ln2": common.init_rmsnorm(cfg.d_model, cfg.pdtype, device=dev, lead=lead),
        "mlp": common.init_mlp(gen, cfg, lead=lead),
    }


def init_encdec(seed: int, cfg: ModelConfig, *, device=None):
    gen = _generator(seed, device)
    return {
        "enc_blocks": common.stack_layers(
            lambda g, lead: _init_enc_block(g, cfg, lead), gen, cfg.n_enc_layers
        ),
        "enc_norm": common.init_rmsnorm(cfg.d_model, cfg.pdtype, device=gen.device),
        "embed": common.init_embedding(gen, cfg.vocab, cfg.d_model, cfg.pdtype),
        "blocks": common.stack_layers(
            lambda g, lead: _init_dec_block(g, cfg, lead), gen, cfg.n_layers
        ),
        "norm": common.init_rmsnorm(cfg.d_model, cfg.pdtype, device=gen.device),
        "head": common.init_dense(gen, cfg.d_model, cfg.vocab, cfg.pdtype),
    }


def encode(params, cfg: ModelConfig, frame_embeds):
    x = frame_embeds.to(cfg.cdtype)
    B, F_, _ = x.shape
    pos = _positions(B, F_, device=x.device)
    for i in range(cfg.n_enc_layers):
        lp = _layer(params["enc_blocks"], i)
        h = common.rmsnorm(lp["ln1"], x, eps=cfg.norm_eps)
        a, _ = attention.full_attention(lp["attn"], h, pos, cfg, causal=False)
        x = x + a
        h = common.rmsnorm(lp["ln2"], x, eps=cfg.norm_eps)
        x = x + common.mlp(lp["mlp"], h, cfg)
    return common.rmsnorm(params["enc_norm"], x, eps=cfg.norm_eps)


def _dec_block(p, x, positions, memory, cfg: ModelConfig, *, collect_kv=False):
    h = common.rmsnorm(p["ln1"], x, eps=cfg.norm_eps)
    a, kv = attention.full_attention(p["attn"], h, positions, cfg, causal=True)
    x = x + a
    h = common.rmsnorm(p["lnx"], x, eps=cfg.norm_eps)
    mk, mv = attention.project_memory(p["xattn"], memory, cfg)
    x = x + attention.cross_attention(p["xattn"], h, mk, mv, cfg)
    h = common.rmsnorm(p["ln2"], x, eps=cfg.norm_eps)
    x = x + common.mlp(p["mlp"], h, cfg)
    return x, (kv if collect_kv else None), (mk, mv)


def encdec_loss(params, cfg: ModelConfig, batch):
    memory = encode(params, cfg, batch["frame_embeds"])
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = common.embed(params["embed"], tokens, cdtype=cfg.cdtype)
    pos = _positions(B, S, device=x.device)
    for i in range(cfg.n_layers):
        x, _, _ = _dec_block(_layer(params["blocks"], i), x, pos, memory, cfg)
    return _chunked_ce(params, cfg, x, batch["labels"])


def encdec_prefill(params, cfg: ModelConfig, batch):
    memory = encode(params, cfg, batch["frame_embeds"])
    tokens = batch["tokens"]
    B, S = tokens.shape
    cap = _cache_capacity(cfg, S + PREFILL_HEADROOM)
    x = common.embed(params["embed"], tokens, cdtype=cfg.cdtype)
    pos = _positions(B, S, device=x.device)
    caches, mks, mvs = [], [], []
    for i in range(cfg.n_layers):
        x, (k, v), (mk, mv) = _dec_block(_layer(params["blocks"], i), x, pos, memory, cfg,
                                         collect_kv=True)
        caches.append(attention.fill_cache_from_prefill(
            attention.init_cache(cfg, B, cap, device=x.device), k, v, S))
        mks.append(mk)
        mvs.append(mv)
    logits = _logits(params, cfg, x[:, -1:])
    return logits, {"layers": _stack(caches), "mem_kv": (torch.stack(mks), torch.stack(mvs)),
                    "t": _t(S, x.device)}


def encdec_init_cache(cfg: ModelConfig, batch_size: int, seq_len: int, *, device=None):
    cap = _cache_capacity(cfg, seq_len)
    one = attention.init_cache(cfg, batch_size, cap, device=device)
    mem = torch.zeros((cfg.n_layers, batch_size, cfg.enc_frames, cfg.n_kv, cfg.hd),
                      dtype=cfg.cdtype, device=device)
    return {"layers": _broadcast(one, (cfg.n_layers,)), "mem_kv": (mem, mem.clone()),
            "t": _t(seq_len, device)}


def encdec_decode(params, cfg: ModelConfig, cache, tokens):
    x = common.embed(params["embed"], tokens, cdtype=cfg.cdtype)
    pos = cache["t"]
    mks, mvs = cache["mem_kv"]
    caches = []
    for i in range(cfg.n_layers):
        lp, lc = _layer(params["blocks"], i), _layer(cache["layers"], i)
        h = common.rmsnorm(lp["ln1"], x, eps=cfg.norm_eps)
        a, nc = attention.decode_attention(lp["attn"], h, lc, pos, cfg)
        x = x + a
        h = common.rmsnorm(lp["lnx"], x, eps=cfg.norm_eps)
        x = x + attention.cross_attention(lp["xattn"], h, mks[i], mvs[i], cfg)
        h = common.rmsnorm(lp["ln2"], x, eps=cfg.norm_eps)
        x = x + common.mlp(lp["mlp"], h, cfg)
        caches.append(nc)
    return _logits(params, cfg, x), {
        "layers": _stack(caches),
        "mem_kv": cache["mem_kv"],
        "t": pos + 1,
    }


# --------------------------------------------------------------------------
# SSM (falcon-mamba)
# --------------------------------------------------------------------------


def init_mamba_lm(seed: int, cfg: ModelConfig, *, device=None):
    gen = _generator(seed, device)
    return {
        "embed": common.init_embedding(gen, cfg.vocab, cfg.d_model, cfg.pdtype),
        "blocks": common.stack_layers(
            lambda g, lead: mamba.init_mamba_layer(g, cfg, lead=lead), gen, cfg.n_layers
        ),
        "norm": common.init_rmsnorm(cfg.d_model, cfg.pdtype, device=gen.device),
        "head": common.init_dense(gen, cfg.d_model, cfg.vocab, cfg.pdtype),
    }


def mamba_loss(params, cfg: ModelConfig, batch):
    x = common.embed(params["embed"], batch["tokens"], cdtype=cfg.cdtype)
    for i in range(cfg.n_layers):
        x, _ = mamba.mamba_layer(_layer(params["blocks"], i), x, cfg)
    return _chunked_ce(params, cfg, x, batch["labels"])


def mamba_prefill(params, cfg: ModelConfig, batch):
    x = common.embed(params["embed"], batch["tokens"], cdtype=cfg.cdtype)
    states = []
    for i in range(cfg.n_layers):
        lp = _layer(params["blocks"], i)
        # conv tail (last d_conv-1 *pre-conv* activations) must come from the
        # layer input, so recompute the in_proj tail before running the layer.
        xn = common.rmsnorm(lp["norm"], x, eps=cfg.norm_eps)
        tail = common.dense(
            lp["in_proj"], xn[:, -(cfg.ssm.d_conv - 1):], cdtype=cfg.cdtype
        )
        conv_tail = torch.chunk(tail, 2, dim=-1)[0]
        x, h = mamba.mamba_layer(lp, x, cfg)
        states.append({"h": h, "conv": conv_tail})
    logits = _logits(params, cfg, x[:, -1:])
    return logits, {"layers": _stack(states), "t": _t(batch["tokens"].shape[1], x.device)}


def mamba_init_cache(cfg: ModelConfig, batch_size: int, seq_len: int, *, device=None):
    one = mamba.init_mamba_state(cfg, batch_size, device=device)
    return {"layers": _broadcast(one, (cfg.n_layers,)), "t": _t(seq_len, device)}


def mamba_decode(params, cfg: ModelConfig, cache, tokens):
    x = common.embed(params["embed"], tokens, cdtype=cfg.cdtype)
    states = []
    for i in range(cfg.n_layers):
        x, st = mamba.mamba_decode_layer(_layer(params["blocks"], i), x,
                                         _layer(cache["layers"], i), cfg)
        states.append(st)
    return _logits(params, cfg, x), {"layers": _stack(states), "t": cache["t"] + 1}


# --------------------------------------------------------------------------
# hybrid (recurrentgemma): (rec, rec, attn) groups + remainder rec layers
# --------------------------------------------------------------------------


def _hybrid_counts(cfg: ModelConfig):
    pat = len(cfg.rglru.block_pattern)  # 3
    return cfg.n_layers // pat, cfg.n_layers % pat


def _init_temporal_unit(gen, cfg: ModelConfig, kind: str, lead=()):
    dev = gen.device
    unit = {
        "ln1": common.init_rmsnorm(cfg.d_model, cfg.pdtype, device=dev, lead=lead),
        "ln2": common.init_rmsnorm(cfg.d_model, cfg.pdtype, device=dev, lead=lead),
    }
    if kind == "recurrent":
        unit["rec"] = rglru.init_rglru_block(gen, cfg, lead=lead)
    else:
        unit["attn"] = attention.init_attention(gen, cfg, lead=lead)
    unit["mlp"] = common.init_mlp(gen, cfg, lead=lead)
    return unit


def _temporal_unit_fwd(p, x, positions, cfg: ModelConfig, state=None):
    """One griffin layer: temporal mixer + MLP, both residual.
    Returns (x, new_state_or_kv)."""
    h = common.rmsnorm(p["ln1"], x, eps=cfg.norm_eps)
    if "rec" in p:
        o, hfin = rglru.rglru_block(p["rec"], h, cfg)
        out_state = hfin
    else:
        o, (k, v) = attention.sliding_window_attention(
            p["attn"], h, positions, cfg, window=cfg.rglru.local_window
        )
        out_state = (k, v)
    x = x + o
    h = common.rmsnorm(p["ln2"], x, eps=cfg.norm_eps)
    return x + common.mlp(p["mlp"], h, cfg), out_state


def init_hybrid(seed: int, cfg: ModelConfig, *, device=None):
    gen = _generator(seed, device)
    n_groups, rem = _hybrid_counts(cfg)

    def init_group(g, lead):
        return {
            f"u{i}": _init_temporal_unit(g, cfg, kind, lead)
            for i, kind in enumerate(cfg.rglru.block_pattern)
        }

    params = {
        "embed": common.init_embedding(gen, cfg.vocab, cfg.d_model, cfg.pdtype),
        "groups": common.stack_layers(init_group, gen, n_groups),
        "norm": common.init_rmsnorm(cfg.d_model, cfg.pdtype, device=gen.device),
        "head": common.init_dense(gen, cfg.d_model, cfg.vocab, cfg.pdtype),
    }
    if rem:
        params["rem"] = common.stack_layers(
            lambda g, lead: _init_temporal_unit(g, cfg, "recurrent", lead), gen, rem
        )
    return params


def hybrid_backbone(params, cfg: ModelConfig, tokens):
    B, S = tokens.shape
    x = common.embed(params["embed"], tokens, cdtype=cfg.cdtype)
    pos = _positions(B, S, device=x.device)
    n_groups, rem = _hybrid_counts(cfg)
    for gi in range(n_groups):
        gp = _layer(params["groups"], gi)
        for i in range(len(cfg.rglru.block_pattern)):
            x, _ = _temporal_unit_fwd(gp[f"u{i}"], x, pos, cfg)
    for ri in range(rem):
        x, _ = _temporal_unit_fwd(_layer(params["rem"], ri), x, pos, cfg)
    return x


def hybrid_loss(params, cfg: ModelConfig, batch):
    x = hybrid_backbone(params, cfg, batch["tokens"])
    return _chunked_ce(params, cfg, x, batch["labels"])


def _hybrid_unit_state(cfg: ModelConfig, kind: str, B: int, cap: int, device=None):
    if kind == "recurrent":
        return rglru.init_rglru_state(cfg, B, device=device)
    return attention.init_cache(cfg, B, cap, device=device)


def hybrid_init_cache(cfg: ModelConfig, batch_size: int, seq_len: int, *, device=None):
    n_groups, rem = _hybrid_counts(cfg)
    cap = min(seq_len, cfg.rglru.local_window)
    group_state = {
        f"u{i}": _hybrid_unit_state(cfg, kind, batch_size, cap, device)
        for i, kind in enumerate(cfg.rglru.block_pattern)
    }
    cache = {"groups": _broadcast(group_state, (n_groups,)), "t": _t(seq_len, device)}
    if rem:
        rs = rglru.init_rglru_state(cfg, batch_size, device=device)
        cache["rem"] = _broadcast(rs, (rem,))
    return cache


def _hybrid_rec_prefill(unit, x, cfg: ModelConfig):
    """A recurrent unit over the prompt: (x, its decode state)."""
    h = common.rmsnorm(unit["ln1"], x, eps=cfg.norm_eps)
    xb = common.dense(unit["rec"]["in_x"], h, cdtype=cfg.cdtype)
    conv_tail = xb[:, -(cfg.rglru.conv_width - 1):]
    o, hfin = rglru.rglru_block(unit["rec"], h, cfg)
    x = x + o
    hh = common.rmsnorm(unit["ln2"], x, eps=cfg.norm_eps)
    return x + common.mlp(unit["mlp"], hh, cfg), {"h": hfin, "conv": conv_tail}


def hybrid_prefill(params, cfg: ModelConfig, batch):
    tokens = batch["tokens"]
    B, S = tokens.shape
    cap = min(S + PREFILL_HEADROOM, cfg.rglru.local_window)
    x = common.embed(params["embed"], tokens, cdtype=cfg.cdtype)
    pos = _positions(B, S, device=x.device)
    n_groups, rem = _hybrid_counts(cfg)

    group_states = []
    for gi in range(n_groups):
        gp = _layer(params["groups"], gi)
        states = {}
        for i, kind in enumerate(cfg.rglru.block_pattern):
            unit = gp[f"u{i}"]
            if kind == "recurrent":
                x, states[f"u{i}"] = _hybrid_rec_prefill(unit, x, cfg)
                continue
            h = common.rmsnorm(unit["ln1"], x, eps=cfg.norm_eps)
            o, (k, v) = attention.sliding_window_attention(
                unit["attn"], h, pos, cfg, window=cfg.rglru.local_window
            )
            x = x + o
            states[f"u{i}"] = attention.fill_cache_from_prefill(
                attention.init_cache(cfg, B, cap, device=x.device), k, v, S
            )
            hh = common.rmsnorm(unit["ln2"], x, eps=cfg.norm_eps)
            x = x + common.mlp(unit["mlp"], hh, cfg)
        group_states.append(states)
    cache = {"groups": _stack(group_states), "t": _t(S, x.device)}
    if rem:
        rem_states = []
        for ri in range(rem):
            x, st = _hybrid_rec_prefill(_layer(params["rem"], ri), x, cfg)
            rem_states.append(st)
        cache["rem"] = _stack(rem_states)
    logits = _logits(params, cfg, x[:, -1:])
    return logits, cache


def _hybrid_unit_decode(unit, kind, x1, state, pos, cfg: ModelConfig):
    h = common.rmsnorm(unit["ln1"], x1, eps=cfg.norm_eps)
    if kind == "recurrent":
        o, st = rglru.rglru_decode_block(unit["rec"], h, state, cfg)
    else:
        o, st = attention.decode_attention(
            unit["attn"], h, state, pos, cfg, window=cfg.rglru.local_window
        )
    x1 = x1 + o
    hh = common.rmsnorm(unit["ln2"], x1, eps=cfg.norm_eps)
    return x1 + common.mlp(unit["mlp"], hh, cfg), st


def hybrid_decode(params, cfg: ModelConfig, cache, tokens):
    x = common.embed(params["embed"], tokens, cdtype=cfg.cdtype)
    pos = cache["t"]
    n_groups, rem = _hybrid_counts(cfg)
    group_states = []
    for gi in range(n_groups):
        gp, gstate = _layer(params["groups"], gi), _layer(cache["groups"], gi)
        new_states = {}
        for i, kind in enumerate(cfg.rglru.block_pattern):
            x, new_states[f"u{i}"] = _hybrid_unit_decode(
                gp[f"u{i}"], kind, x, gstate[f"u{i}"], pos, cfg)
        group_states.append(new_states)
    new_cache = {"groups": _stack(group_states), "t": pos + 1}
    if rem:
        rem_states = []
        for ri in range(rem):
            x, st = _hybrid_unit_decode(_layer(params["rem"], ri), "recurrent", x,
                                        _layer(cache["rem"], ri), pos, cfg)
            rem_states.append(st)
        new_cache["rem"] = _stack(rem_states)
    x = common.rmsnorm(params["norm"], x, eps=cfg.norm_eps)
    logits = common.dense(params["head"], x, cdtype=cfg.cdtype)
    return logits, new_cache
