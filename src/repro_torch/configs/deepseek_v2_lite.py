"""DeepSeek-V2-Lite [deepseek]: 27L d_model=2048 16H MLA (kv_lora_rank 512,
no q-LoRA, qk 128 + 64 rope, v 128), YaRN (factor 40 over 4,096 positions),
layer 0 a dense SwiGLU of 10,944, layers 1–26 DeepSeekMoE (64 routed experts
of 1,408, greedy top-6, softmax, no renormalization; 2 shared), untied
vocabulary of 102,400; 15.7·10⁹ parameters.
[hf:deepseek-ai/DeepSeek-V2-Lite config.json; arXiv:2405.04434]"""
import dataclasses

from repro_torch.configs.base import DeepSeekConfig, DeepSeekMoEConfig, MLAConfig, YaRNConfig

CONFIG = DeepSeekConfig(
    name="deepseek-v2-lite", family="deepseek",
    n_layers=27, d_model=2048, n_heads=16, n_kv=16, d_ff=10944, vocab=102400,
    rope_theta=10_000.0, norm_eps=1e-6,
    mla=MLAConfig(kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128),
    yarn=YaRNConfig(factor=40.0, original_max_pos=4096, beta_fast=32.0, beta_slow=1.0,
                    mscale=0.707, mscale_all_dim=0.707),
    ds_moe=DeepSeekMoEConfig(n_routed=64, top_k=6, expert_d_ff=1408, n_shared=2,
                             routed_scale=1.0, n_held=64, held_start=0),
    first_dense=1,
    source="hf:deepseek-ai/DeepSeek-V2-Lite",
)

# the deployment one chip's share is cut from: each MoE layer's experts over
# EP chips, the vocabulary over the same chips, the layers over pipeline
# stages of STAGE_LAYERS (the first stage: the dense layer and four MoE layers)
EP = 8
STAGE_LAYERS = 5


def stage(*, expert_shard: int = 0) -> DeepSeekConfig:
    """One chip's share at published widths: the first pipeline stage (layer
    0 dense, layers 1–4 MoE), experts ``[8·s, 8·s + 8)`` of 64 for
    ``expert_shard`` s (the router keeps its 64 outputs and top-6), and an
    eighth of the vocabulary (12,800 rows of the embedding and the head)."""
    e = CONFIG.ds_moe
    return dataclasses.replace(
        CONFIG, n_layers=STAGE_LAYERS, vocab=CONFIG.vocab // EP,
        ds_moe=dataclasses.replace(e, n_held=e.n_routed // EP,
                                   held_start=expert_shard * (e.n_routed // EP)))


def reduced() -> DeepSeekConfig:
    """The CPU tests' size: every mechanism, small widths."""
    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv=4, d_ff=96, vocab=128,
        mla=MLAConfig(kv_lora_rank=16, qk_nope_dim=8, qk_rope_dim=8, v_head_dim=8),
        yarn=dataclasses.replace(CONFIG.yarn, original_max_pos=16),
        ds_moe=DeepSeekMoEConfig(n_routed=8, top_k=3, expert_d_ff=24, n_shared=2,
                                 n_held=8, held_start=0))
