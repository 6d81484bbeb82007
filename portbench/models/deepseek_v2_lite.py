"""DeepSeek-V2-Lite, one chip's share (``configs/deepseek_v2_lite_*.json``):
the benchmark's weights, the port's loss, its own weights (the layout to
match), the CPU tests' size and the FLOP count.

The configuration file holds the published ``config.json``'s keys, with the
layers, the experts held and the vocabulary cut to this chip's share (its
``reduced``); the router keeps ``n_routed_experts_published`` outputs.  The
plain model is ``portbench/reference/deepseek_v2_lite.py``; the port's is
``repro_torch.models.stacks.deepseek_loss`` through the model registry
(imported when the loss is asked for, so this file loads without the
port).
"""
from __future__ import annotations

import math

import torch


def _dims(cfg: dict) -> dict:
    d, H = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope, v = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    return dict(d=d, H=H, nope=nope, rope=rope, v=v, r=cfg["kv_lora_rank"],
                f=cfg["intermediate_size"], fe=cfg["moe_intermediate_size"],
                shared=cfg["n_shared_experts"] * cfg["moe_intermediate_size"],
                E=cfg["n_routed_experts_published"], held=cfg["n_routed_experts"],
                dense=cfg["first_k_dense_replace"],
                moe=cfg["num_hidden_layers"] - cfg["first_k_dense_replace"],
                V=cfg["vocab_size"])


def leaf_shapes(cfg: dict) -> dict[str, tuple]:
    """Every parameter's name ('a/b' for nested) and shape, in sorted order:
    the leading dense layers stacked under ``dense``, the MoE layers under
    ``blocks``; dense weights (d_in, d_out), experts (held, d_in, d_out)."""
    m = _dims(cfg)
    d, H = m["d"], m["H"]

    def block(n: int, ffn: dict) -> dict:
        out = {"attn/q/w": (n, d, H * (m["nope"] + m["rope"])),
               "attn/kv_a/w": (n, d, m["r"] + m["rope"]),
               "attn/kv_norm/scale": (n, m["r"]),
               "attn/kv_b/w": (n, m["r"], H * (m["nope"] + m["v"])),
               "attn/o/w": (n, H * m["v"], d), "ln1/scale": (n, d), "ln2/scale": (n, d)}
        out.update({k: (n, *s) for k, s in ffn.items()})
        return out

    dense = {"mlp/gate/w": (d, m["f"]), "mlp/up/w": (d, m["f"]), "mlp/down/w": (m["f"], d)}
    moe = {"moe/router/w": (d, m["E"]), "moe/gate": (m["held"], d, m["fe"]),
           "moe/up": (m["held"], d, m["fe"]), "moe/down": (m["held"], m["fe"], d),
           "moe/shared/gate/w": (d, m["shared"]), "moe/shared/up/w": (d, m["shared"]),
           "moe/shared/down/w": (m["shared"], d)}
    shapes = {"embed/table": (m["V"], d), "head/w": (d, m["V"]), "norm/scale": (d,)}
    shapes.update({f"dense/{k}": s for k, s in block(m["dense"], dense).items()})
    shapes.update({f"blocks/{k}": s for k, s in block(m["moe"], moe).items()})
    return dict(sorted(shapes.items()))


def init_params(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """N(0, 1) embedding rows, N(0, 1/fan_in) weights (fan_in the leaf's
    second-to-last size), RMSNorm scales 1: one normal draw on ``device``
    from ``seed``, cut into the leaves."""
    shapes = leaf_shapes(cfg)
    drawn = {k: s for k, s in shapes.items() if not k.endswith("scale")}
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(math.prod(s) for s in drawn.values()), generator=gen,
                       device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape in shapes.items():
        if name in drawn:
            scale = 1.0 if name == "embed/table" else shape[-2] ** -0.5
            out[name] = flat[at:at + math.prod(shape)].view(shape) * scale
            at += math.prod(shape)
        else:
            out[name] = torch.ones(shape, device=device)
    return out


def model_config(cfg: dict):
    """The port's ``DeepSeekConfig`` of a configuration file."""
    from repro_torch.configs.base import (DeepSeekConfig, DeepSeekMoEConfig, MLAConfig,
                                          YaRNConfig)

    y = cfg["rope_scaling"]
    return DeepSeekConfig(
        name="deepseek-v2-lite", family="deepseek", n_layers=cfg["num_hidden_layers"],
        d_model=cfg["hidden_size"], n_heads=cfg["num_attention_heads"],
        n_kv=cfg["num_key_value_heads"], d_ff=cfg["intermediate_size"],
        vocab=cfg["vocab_size"], rope_theta=float(cfg["rope_theta"]),
        norm_eps=cfg["rms_norm_eps"],
        mla=MLAConfig(kv_lora_rank=cfg["kv_lora_rank"], qk_nope_dim=cfg["qk_nope_head_dim"],
                      qk_rope_dim=cfg["qk_rope_head_dim"], v_head_dim=cfg["v_head_dim"]),
        yarn=YaRNConfig(factor=float(y["factor"]),
                        original_max_pos=y["original_max_position_embeddings"],
                        beta_fast=float(y["beta_fast"]), beta_slow=float(y["beta_slow"]),
                        mscale=y["mscale"], mscale_all_dim=y["mscale_all_dim"]),
        ds_moe=DeepSeekMoEConfig(
            n_routed=cfg["n_routed_experts_published"], top_k=cfg["num_experts_per_tok"],
            expert_d_ff=cfg["moe_intermediate_size"], n_shared=cfg["n_shared_experts"],
            routed_scale=float(cfg["routed_scaling_factor"]), n_held=cfg["n_routed_experts"],
            held_start=cfg["expert_shard"] * cfg["n_routed_experts"],
            capacity_factor=cfg["capacity_factor"], aux_alpha=cfg["aux_loss_alpha"]),
        first_dense=cfg["first_k_dense_replace"],
        source=cfg["source"])


def program_loss(cfg: dict):
    """The port's registry loss on a nested parameter dict and a minibatch:
    (loss, MoE counters); ``FLSimulator`` takes its clients in turn."""
    from repro_torch.models import get_model

    return get_model(model_config(cfg)).loss


def port_params(cfg: dict, seed: int) -> dict:
    """The port's own initial weights (nested), on the CPU: the layout
    :func:`init_params` has to match leaf for leaf."""
    from repro_torch.models import get_model

    return get_model(model_config(cfg)).init(seed, device="cpu")


def cpu_size(cfg: dict) -> dict:
    """The configuration the CPU tests run: every width, the layers, the
    experts (16 behind the router, the first 4 held), the vocabulary and the
    sequence cut so that a round takes a fraction of a second; the router's
    top-6, YaRN, the capacity factor and the balance weight as published."""
    small = dict(cfg, hidden_size=32, num_attention_heads=2, num_key_value_heads=2,
                 kv_lora_rank=16, qk_nope_head_dim=8, qk_rope_head_dim=8, v_head_dim=8,
                 intermediate_size=48, moe_intermediate_size=16, num_hidden_layers=3,
                 n_routed_experts_published=16, n_routed_experts=4,
                 vocab_size=64, data=dict(cfg["data"], vocab=64, seq_len=32))
    small["num_params"] = sum(math.prod(s) for s in leaf_shapes(small).values())
    return small


def forward_flops_per_sample(cfg: dict) -> int:
    """2 × the multiply-adds of one sequence of ``seq_len`` tokens: every
    layer's projections; the causal scores and value products at half of
    S² (the blocks above the diagonal are not computed); the dense SwiGLU;
    a MoE layer's shared SwiGLU, router and, for the routed experts, the
    top_k · held / published choices a token routed here; the head over
    the vocabulary's rows.  Norms, RoPE, softmax and the loss are not
    counted."""
    m = _dims(cfg)
    d, H, S = m["d"], m["H"], cfg["data"]["seq_len"]
    proj = (d * H * (m["nope"] + m["rope"]) + d * (m["r"] + m["rope"])
            + m["r"] * H * (m["nope"] + m["v"]) + H * m["v"] * d)
    layers = m["dense"] + m["moe"]
    per_token = layers * proj + m["dense"] * 3 * d * m["f"] + d * m["V"]
    routed = cfg["num_experts_per_tok"] * m["held"] / m["E"]
    per_token += m["moe"] * (3 * d * m["shared"] + d * m["E"] + routed * 3 * d * m["fe"])
    scores = layers * H * (m["nope"] + m["rope"] + m["v"]) * S * S / 2
    return int(2 * (per_token * S + scores))
