"""The port's attention against the JAX package's, case for case as
``tests/test_attention.py`` checks the reference: blockwise (flash-style)
against quadratic with the same parametrisation, its gradients, the
sliding-window padding path and decode's ring-buffer eviction.  Each case
also holds the port's function against the JAX function on the same numpy
inputs.  Plus the MoE layer's routing and output against the JAX package's.

Tolerance: forward values atol 1e-5 + rtol 1e-5 against the JAX function;
gradients atol 1e-5 + rtol 1e-4.  The port's blockwise-vs-quadratic bars
are the reference test's (atol 2e-5, grads 5e-5).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JaxModelConfig
from repro.configs.base import MoEConfig as JaxMoEConfig
from repro.models import attention as jatt
from repro.models import common as jcommon
from repro.models import moe as jmoe
from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models import attention as att
from repro_torch.models import common, moe
from repro_torch.utils import from_jax_params, tree_flatten

FIELDS = dict(name="t", family="dense", n_layers=1, d_model=64, n_heads=4, n_kv=2,
              d_ff=128, vocab=64, head_dim=16)
CFG, JCFG = ModelConfig(**FIELDS), JaxModelConfig(**FIELDS)
FWD = dict(atol=1e-5, rtol=1e-5)
GRAD = dict(atol=1e-5, rtol=1e-4)


def _qkv(B, S, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, 4, 16)).astype(np.float32)
    k = rng.standard_normal((B, S, 2, 16)).astype(np.float32)
    v = rng.standard_normal((B, S, 2, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S)).copy()
    return q, k, v, pos


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _quad(q, k, v, pos, causal, window):
    """The reference test's quadratic oracle, in the port."""
    B, S = q.shape[:2]
    s = att._gqa_scores(q, k, CFG)
    m = torch.ones((B, 1, 1, S, S), dtype=torch.bool)
    if causal:
        m = m & (pos[:, None, None, :, None] >= pos[:, None, None, None, :])
    if window:
        m = m & (pos[:, None, None, None, :] > pos[:, None, None, :, None] - window)
    s = torch.where(m, s, att.NEG_INF)
    w = torch.softmax(s, -1)
    o = torch.einsum("bkgqs,bskh->bqkgh", w, v)
    return o.reshape(B, S, 64)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64), (True, 17),
                                           (False, 0)])
@pytest.mark.parametrize("chunks", [(64, 32), (32, 64), (128, 128)])
def test_blockwise_matches_quadratic(causal, window, chunks):
    q, k, v, pos = _qkv(2, 256)
    qc, kc = chunks
    tq, tk, tv, tpos = _t(q, k, v, pos)
    got = att.blockwise_gqa(tq, tk, tv, pos_q=tpos, pos_k=tpos, causal=causal,
                            window=window, cfg=CFG, q_chunk=qc, kv_chunk=kc)
    np.testing.assert_allclose(got.numpy(), _quad(tq, tk, tv, tpos, causal, window).numpy(),
                               atol=2e-5)
    want = jatt.blockwise_gqa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), pos_q=pos,
                              pos_k=pos, causal=causal, window=window, cfg=JCFG,
                              q_chunk=qc, kv_chunk=kc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)


def test_blockwise_grads_match():
    q, k, v, pos = _qkv(1, 128)
    tpos = torch.from_numpy(pos)

    def f_block(q, k, v):
        return att.blockwise_gqa(q, k, v, pos_q=tpos, pos_k=tpos, causal=True, window=0,
                                 cfg=CFG, q_chunk=32, kv_chunk=32).sum()

    def f_quad(q, k, v):
        return _quad(q, k, v, tpos, True, 0).sum()

    g1 = torch.func.grad(f_block, argnums=(0, 1, 2))(*_t(q, k, v))
    g2 = torch.func.grad(f_quad, argnums=(0, 1, 2))(*_t(q, k, v))
    for a, b in zip(g1, g2):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=5e-5)

    def j_block(q, k, v):
        return jatt.blockwise_gqa(q, k, v, pos_q=pos, pos_k=pos, causal=True, window=0,
                                  cfg=JCFG, q_chunk=32, kv_chunk=32).sum()

    gj = jax.grad(j_block, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for a, b in zip(g1, gj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD)


def _params(cfg_j, seed=0):
    p = jatt.init_attention(jax.random.key(seed), cfg_j)
    return p, from_jax_params(jax.tree.map(np.asarray, p), device="cpu")


@pytest.mark.parametrize("S", [77, 96, 128])
def test_swa_padding_path(S):
    """S not a multiple of the window (77, 96) and a multiple (128): the
    port's chunked SWA equals its quadratic window oracle and the JAX
    function's output and K/V."""
    cfg, jcfg = (dataclasses.replace(c, sliding_window=32) for c in (CFG, JCFG))
    jp, p = _params(jcfg)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, S, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (2, S)).copy()
    tx, tpos = _t(x, pos)
    out, (k, v) = att.sliding_window_attention(p, tx, tpos, cfg, window=32)
    assert out.shape == (2, S, 64) and k.shape[1] == S
    # oracle: quadratic with window mask
    qr = common.apply_rope(att._project_q(p, tx, cfg), tpos, cfg)
    kr = common.apply_rope(att._project_kv(p, tx, cfg)[0], tpos, cfg)
    vv = att._project_kv(p, tx, cfg)[1]
    s = att._gqa_scores(qr, kr, cfg)
    m = (tpos[:, None, None, :, None] >= tpos[:, None, None, None, :]) & (
        tpos[:, None, None, None, :] > tpos[:, None, None, :, None] - 32)
    w = torch.softmax(torch.where(m, s, att.NEG_INF), -1)
    o = torch.einsum("bkgqs,bskh->bqkgh", w, vv).reshape(2, S, 64)
    np.testing.assert_allclose(out.numpy(), common.dense(p["o"], o, cdtype=cfg.cdtype).numpy(),
                               atol=2e-5)
    jout, (jk, jv) = jatt.sliding_window_attention(jp, jnp.asarray(x), pos, jcfg, window=32)
    for a, b in ((out, jout), (k, jk), (v, jv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **FWD)


def test_full_attention_blockwise_path_matches_jax(monkeypatch):
    """Past BLOCKWISE_THRESHOLD (lowered here to 64) full attention takes
    the blockwise path in both packages."""
    monkeypatch.setattr(att, "BLOCKWISE_THRESHOLD", 64)
    monkeypatch.setattr(jatt, "BLOCKWISE_THRESHOLD", 64)
    jp, p = _params(JCFG)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 128, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(128, dtype=np.int32)[None], (2, 128)).copy()
    out, _ = att.full_attention(p, *_t(x, pos), CFG, causal=True)
    jout, _ = jatt.full_attention(jp, jnp.asarray(x), pos, JCFG, causal=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **FWD)


def test_cross_attention_matches_jax():
    jp, p = _params(JCFG)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 24, 64)).astype(np.float32)
    mem = rng.standard_normal((2, 40, 64)).astype(np.float32)
    mk, mv = att.project_memory(p, torch.from_numpy(mem), CFG)
    jmk, jmv = jatt.project_memory(jp, jnp.asarray(mem), JCFG)
    got = att.cross_attention(p, torch.from_numpy(x), mk, mv, CFG)
    want = jatt.cross_attention(jp, jnp.asarray(x), jmk, jmv, JCFG)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)


@pytest.mark.parametrize("prefill_len,capacity", [(40, 16), (10, 16), (16, 16), (30, 64)])
def test_fill_cache_from_prefill_matches_jax(prefill_len, capacity):
    """The ring written from a prefill, with and without a wrap."""
    rng = np.random.default_rng(6)
    k = rng.standard_normal((2, prefill_len, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, prefill_len, 2, 16)).astype(np.float32)
    got = att.fill_cache_from_prefill(att.init_cache(CFG, 2, capacity), *_t(k, v),
                                      prefill_len)
    want = jatt.fill_cache_from_prefill(jatt.init_cache(JCFG, 2, capacity), jnp.asarray(k),
                                        jnp.asarray(v), prefill_len)
    for key in ("k", "v", "pos"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))


def test_decode_ring_buffer_eviction_is_window_consistent():
    """With SWA, a full ring cache must attend to exactly the last W tokens;
    every step's output and cache equal the JAX package's."""
    cfg, jcfg = (dataclasses.replace(c, sliding_window=16) for c in (CFG, JCFG))
    jp, p = _params(jcfg)
    cache, jcache = att.init_cache(cfg, 1, 16), jatt.init_cache(jcfg, 1, 16)
    rng = np.random.default_rng(2)
    xs = rng.standard_normal((1, 40, 64)).astype(np.float32)
    jstep = jax.jit(lambda p_, x_, c_, t_: jatt.decode_attention(p_, x_, c_, t_, jcfg,
                                                                 window=16))
    # stream 39 tokens through decode, then check token 39 attends to 24..39
    for t in range(39):
        out, cache = att.decode_attention(p, torch.from_numpy(xs[:, t:t + 1]), cache,
                                          torch.tensor(t, dtype=torch.int32), cfg, window=16)
        jout, jcache = jstep(jp, xs[:, t:t + 1], jcache, jnp.int32(t))
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), **FWD)
    assert sorted(cache["pos"].tolist()) == list(range(23, 39))
    for key in ("k", "v"):
        np.testing.assert_allclose(cache[key].numpy(), np.asarray(jcache[key]), **FWD)
    np.testing.assert_array_equal(cache["pos"].numpy(), np.asarray(jcache["pos"]))


# -------------------------------------------------------------------- MoE

MOE_FIELDS = dict(name="m", family="moe", n_layers=1, d_model=32, n_heads=2, n_kv=2,
                  d_ff=48, vocab=64, head_dim=16)


@pytest.mark.parametrize("capacity_factor", [1.25, 8.0])
def test_moe_routing_and_output_match_jax(capacity_factor):
    """The top-k expert ids equal the reference's routing, and the layer's
    output and aux loss (with capacity drops at 1.25) match it."""
    cfg = ModelConfig(**MOE_FIELDS, moe=MoEConfig(n_experts=4, top_k=2,
                                                  capacity_factor=capacity_factor))
    jcfg = JaxModelConfig(**MOE_FIELDS, moe=JaxMoEConfig(n_experts=4, top_k=2,
                                                         capacity_factor=capacity_factor))
    jp = jmoe.init_moe(jax.random.key(0), jcfg)
    p = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    x = np.random.default_rng(7).standard_normal((3, 40, 32)).astype(np.float32)
    _, gate_vals, expert_ids = moe._route(p, torch.from_numpy(x), cfg)
    jprobs = jax.nn.softmax(jcommon.dense(jp["router"], jnp.asarray(x), cdtype=jnp.float32),
                            axis=-1)
    jgate, jids = jax.lax.top_k(jprobs, 2)
    np.testing.assert_array_equal(expert_ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(
        gate_vals.numpy(), np.asarray(jgate / jgate.sum(-1, keepdims=True)), **FWD)
    out, aux = moe.moe_ffn(p, torch.from_numpy(x), cfg)
    jout, jaux = jmoe.moe_ffn(jp, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **FWD)
    np.testing.assert_allclose(aux.item(), float(jaux), **FWD)
    if capacity_factor < 2:  # capacity 25 of 80 choices over 4 experts drops some
        C = moe._capacity(cfg, 40)
        counts = torch.nn.functional.one_hot(expert_ids.reshape(3, -1), 4).sum(1)
        assert int(counts.max()) > C


def test_moe_grads_under_vmap_match_jax():
    """The MoE layer under ``torch.func.vmap(grad)`` over clients, as the
    simulator runs it, against the JAX gradient client by client."""
    cfg = ModelConfig(**MOE_FIELDS, moe=MoEConfig(n_experts=4, top_k=2))
    jcfg = JaxModelConfig(**MOE_FIELDS, moe=JaxMoEConfig(n_experts=4, top_k=2))
    jp = jmoe.init_moe(jax.random.key(1), jcfg)
    p = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    xs = np.random.default_rng(8).standard_normal((3, 2, 24, 32)).astype(np.float32)

    def loss(params, x):
        out, aux = moe.moe_ffn(params, x, cfg)
        return (out * out).mean() + aux

    def jloss(params, x):
        out, aux = jmoe.moe_ffn(params, x, jcfg)
        return (out * out).mean() + aux

    grads = torch.func.vmap(torch.func.grad(loss), in_dims=(None, 0))(p, torch.from_numpy(xs))
    jgrads = jax.vmap(jax.grad(jloss), in_axes=(None, 0))(jp, jnp.asarray(xs))
    for g, w in zip(tree_flatten(grads)[0], jax.tree.leaves(jgrads)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD)
