"""DeepSeek-V2-Lite on the port (``configs/deepseek_v2_lite.py``,
``models/attention.py::mla_attention`` and ``causal_attention``,
``models/moe.py::ds_moe_ffn``, ``models/stacks.py::deepseek_loss``): each
piece against its plain formula at small sizes on the CPU, in f64 where the
comparison is of formulas (the port takes RMSNorm, the router and the loss
in f32 whatever the dtype, hence 1e-5 where those are in the path), and the
whole
ColRel local update against the benchmark's plain reference client by
client.  The JAX package has no such model."""
import dataclasses
import math

import numpy as np
import pytest
import torch

from portbench.models import deepseek_v2_lite as bench_model
from portbench.reference import deepseek_v2_lite as ref
from portbench.reference import fl as ref_fl
from repro_torch.configs import deepseek_v2_lite, registry
from repro_torch.fl.engine import PipelinedScanEngine, run_rounds_loop
from repro_torch.fl.simulator import FLSimulator, client_grad_fn, local_updates
from repro_torch.models import attention, common, get_model, moe
from repro_torch.obs import Tracer
from repro_torch.optim.sgd import ClientOpt


@pytest.fixture(autouse=True)
def _few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _cfg(**kw):
    return dataclasses.replace(deepseek_v2_lite.reduced(), **kw)


# -- the configuration ------------------------------------------------------

def test_published_config_counts_15_7_billion_parameters():
    cfg = registry.get_config("deepseek-v2-lite")
    assert cfg is deepseek_v2_lite.CONFIG
    assert cfg.param_count() == 15_706_484_224
    assert cfg.param_count() == pytest.approx(15.7e9, rel=0.01)
    # the port's MoE convention (embedding and head counted); less the input
    # table, DeepSeek's "2.4B activated"
    assert cfg.active_param_count() == 2_661_150_208
    assert cfg.active_param_count() - cfg.vocab * cfg.d_model == pytest.approx(2.4e9, rel=0.03)
    # the reference's list of architectures is left as it is
    assert "deepseek-v2-lite" not in registry.ARCHS and "deepseek-v2-lite" in registry.PORT_ONLY


@pytest.mark.parametrize("shard", range(deepseek_v2_lite.EP))
def test_stage_is_one_chips_share(shard):
    cfg = deepseek_v2_lite.stage(expert_shard=shard)
    e = cfg.ds_moe
    assert (cfg.n_layers, cfg.first_dense, cfg.vocab) == (5, 1, 12_800)
    assert (e.n_routed, e.top_k, e.n_held, e.held_start) == (64, 6, 8, 8 * shard)
    assert cfg.param_count() == 535_060_992
    # the benchmark's configuration file is the first share, at the same size
    spec = _bench_cfg()
    assert bench_model.model_config(spec) == dataclasses.replace(
        deepseek_v2_lite.stage(), source=spec["source"])
    assert sum(math.prod(s) for s in bench_model.leaf_shapes(spec).values()) == 535_060_992


def _bench_cfg():
    import json
    from pathlib import Path

    path = (Path(__file__).resolve().parents[1] / "portbench" / "configs"
            / "deepseek_v2_lite_ep8_stage0_n4.json")
    return json.loads(path.read_text())


def test_reference_constants_are_the_configurations():
    """What the plain reference cannot read from the weights' shapes is the
    configuration file's."""
    spec = _bench_cfg()
    y = spec["rope_scaling"]
    assert ref.TOP_K == spec["num_experts_per_tok"]
    assert ref.ROUTED_SCALE == spec["routed_scaling_factor"]
    assert ref.ROPE_THETA == spec["rope_theta"] and ref.RMS_EPS == spec["rms_norm_eps"]
    assert ref.YARN == {k: y[k] for k in ref.YARN}
    assert ref.AUX_ALPHA == spec["aux_loss_alpha"]
    assert ref.CAPACITY_FACTOR == spec["capacity_factor"]
    assert ref.HELD_START == spec["expert_shard"] * spec["n_routed_experts"]
    small = bench_model.cpu_size(spec)
    assert small["expert_shard"] == spec["expert_shard"]


# -- YaRN --------------------------------------------------------------------

def test_yarn_table_and_scale_against_their_closed_form():
    cfg = deepseek_v2_lite.CONFIG
    d, theta, L = 64, 10_000.0, 4096
    inv = common.yarn_rope_freqs(cfg)

    # the correction range: the pairs that turn 32 and 1 times over 4,096
    def pair(turns):
        return d * math.log(L / (2 * math.pi * turns)) / (2 * math.log(theta))

    low, high = math.floor(pair(32)), math.ceil(pair(1))
    assert (low, high) == (10, 23)
    want = []
    for i in range(d // 2):
        base_f = theta ** (-2 * i / d)
        t = min(max((i - low) / (high - low), 0.0), 1.0)
        want.append(base_f * (1 - t) + base_f / 40 * t)
    assert inv.dtype == torch.float32
    assert torch.equal(inv, torch.tensor(want, dtype=torch.float64).float())
    assert torch.equal(inv, ref.yarn_inv_freq(d).float())
    # below the range as RoPE, above it interpolated by the factor
    assert inv[0] == 1.0 and inv[-1] == pytest.approx(theta ** (-62 / 64) / 40, rel=1e-6)
    mscale = 0.1 * 0.707 * math.log(40) + 1
    assert common.mla_softmax_scale(cfg) == pytest.approx(192 ** -0.5 * mscale**2, rel=1e-15)
    # YaRN's factor on cos and sin is 1: the port leaves them unscaled
    assert cfg.yarn.mscale == cfg.yarn.mscale_all_dim


# -- the recomputing causal attention ---------------------------------------

def _naive_attention(q, k, v, scale):
    S = q.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    s = torch.where(torch.ones(S, S, dtype=torch.bool).tril(), s, -1e30)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)


@pytest.mark.parametrize("q_chunk", [4, 7, 16, 64])
def test_recomputing_attention_matches_autograd_through_the_naive_form(q_chunk):
    g = torch.Generator().manual_seed(q_chunk)
    B, S, H, dk, dv = 2, 16, 3, 12, 6  # key and value heads of different widths
    q, k, v = (torch.randn(B, S, H, d, generator=g, dtype=torch.float64) for d in (dk, dk, dv))
    w = torch.randn(B, S, H, dv, generator=g, dtype=torch.float64)

    def ours(q, k, v):
        return (attention.causal_attention(q, k, v, scale=0.4, q_chunk=q_chunk) * w).sum()

    def plain(q, k, v):
        return (_naive_attention(q, k, v, 0.4) * w).sum()

    torch.testing.assert_close(ours(q, k, v), plain(q, k, v), rtol=1e-12, atol=1e-12)
    got = torch.autograd.grad(ours(*(t.requires_grad_() for t in (q, k, v))), (q, k, v))
    want = torch.autograd.grad(plain(q, k, v), (q, k, v))
    for a, b in zip(got, want, strict=True):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


def test_recomputing_attention_under_vmap_of_grad():
    g = torch.Generator().manual_seed(3)
    n, B, S, H, dk, dv = 3, 2, 12, 2, 10, 4
    q, k, v = (torch.randn(n, B, S, H, d, generator=g) for d in (dk, dk, dv))
    w = torch.randn(B, S, H, dv, generator=g)

    def make(fn):
        return torch.func.vmap(torch.func.grad_and_value(
            lambda q, k, v: (fn(q, k, v) * w).sum(), argnums=(0, 1, 2)))

    (g1, v1) = make(lambda q, k, v: attention.causal_attention(q, k, v, scale=0.3,
                                                                q_chunk=5))(q, k, v)
    (g2, v2) = make(lambda q, k, v: _naive_attention(q, k, v, 0.3))(q, k, v)
    torch.testing.assert_close(v1, v2, rtol=1e-5, atol=1e-5)
    for a, b in zip(g1, g2, strict=True):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_recomputing_attention_keeps_no_score_matrix_for_backward():
    """What autograd holds for the backward is q, k, v, the output and the
    log-sum-exp: nothing of size S²."""
    S = 64
    q, k = (torch.randn(1, S, 2, 8, requires_grad=True) for _ in range(2))
    v = torch.randn(1, S, 2, 4, requires_grad=True)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t.numel()) or t,
                                                  lambda t: t):
        out = attention.causal_attention(q, k, v, scale=0.5, q_chunk=16)
    out.sum().backward()
    assert max(saved) <= S * 2 * 8 and len(saved) == 5


# -- MLA ---------------------------------------------------------------------

def _mla_plain(p, x, cfg):
    """MLA written out per head in f64: scores q_h·k_h over the 192 (here
    nope + rope) key dims, values of v_head_dim."""
    m, H = cfg.mla, cfg.n_heads
    B, S, _ = x.shape
    # the angles, their cos and sin in f32, as DeepSeek-V2's code takes them
    ang = torch.arange(S, dtype=torch.float32)[:, None] * common.yarn_rope_freqs(cfg)
    cos, sin = torch.cos(ang).double(), torch.sin(ang).double()

    def rope(t):  # (..., S, rope) pairs rotated
        out = torch.empty_like(t)
        out[..., 0::2] = t[..., 0::2] * cos - t[..., 1::2] * sin
        out[..., 1::2] = t[..., 1::2] * cos + t[..., 0::2] * sin
        return out

    a = x @ p["kv_a"]["w"]
    c = a[..., :m.kv_lora_rank]
    c = c / torch.sqrt((c * c).mean(-1, keepdim=True) + cfg.norm_eps) * p["kv_norm"]["scale"]
    k_pe = rope(a[..., m.kv_lora_rank:])
    kv = c @ p["kv_b"]["w"]
    q = x @ p["q"]["w"]
    scale = common.mla_softmax_scale(cfg)
    heads = []
    for h in range(H):
        qh = q[..., h * m.qk_dim:(h + 1) * m.qk_dim]
        qh = torch.cat([qh[..., :m.qk_nope_dim], rope(qh[..., m.qk_nope_dim:])], -1)
        kvh = kv[..., h * (m.qk_nope_dim + m.v_head_dim):(h + 1) * (m.qk_nope_dim + m.v_head_dim)]
        kh = torch.cat([kvh[..., :m.qk_nope_dim], k_pe], -1)
        vh = kvh[..., m.qk_nope_dim:]
        s = (qh @ kh.transpose(-1, -2)) * scale
        s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(), float("-inf"))
        heads.append(torch.softmax(s, -1) @ vh)
    return torch.cat(heads, -1) @ p["o"]["w"]


@pytest.mark.parametrize("widths", ["published_heads", "small"])
def test_mla_against_the_plain_formula(widths):
    if widths == "published_heads":  # 192-wide keys, 128-wide values, YaRN over 4,096
        cfg = dataclasses.replace(deepseek_v2_lite.CONFIG, d_model=48, n_heads=2,
                                  mla=dataclasses.replace(deepseek_v2_lite.CONFIG.mla,
                                                          kv_lora_rank=24))
        S = 24
    else:
        cfg, S = _cfg(), 20
    cfg = dataclasses.replace(cfg, param_dtype="float64", compute_dtype="float64")
    gen = torch.Generator().manual_seed(1)
    p = attention.init_mla(gen, cfg)
    p["kv_norm"]["scale"] = torch.rand(cfg.mla.kv_lora_rank, generator=gen,
                                       dtype=torch.float64) + 0.5
    x = torch.randn(2, S, cfg.d_model, generator=gen, dtype=torch.float64)
    pos = torch.arange(S).expand(2, S)
    got = attention.mla_attention(p, x, pos, dataclasses.replace(cfg))
    # the latent's RMSNorm is taken in f32
    torch.testing.assert_close(got, _mla_plain(p, x, cfg), rtol=1e-5, atol=1e-6)
    if widths == "published_heads":
        assert p["q"]["w"].shape == (48, 2 * 192) and p["o"]["w"].shape == (2 * 128, 48)


# -- DeepSeekMoE -------------------------------------------------------------

def _moe_cfg(n_held, held_start, **kw):
    cfg = _cfg(**kw)
    return dataclasses.replace(cfg, ds_moe=dataclasses.replace(
        cfg.ds_moe, n_routed=16, top_k=6, n_held=n_held, held_start=held_start))


def test_expert_shares_sum_to_the_uncut_layer():
    """Eight shares of 2 experts each: their routed parts, with the shared
    experts, the balance loss and the counts of what every share computes
    alike taken once, add up to the uncut layer's."""
    whole = _moe_cfg(16, 0, param_dtype="float64", compute_dtype="float64")
    gen = torch.Generator().manual_seed(5)
    p = moe.init_ds_moe(gen, whole)
    x = torch.randn(3, 40, whole.d_model, generator=gen, dtype=torch.float64)
    out, aux, counts = moe.ds_moe_ffn(p, x, whole)
    shared = common.mlp(p["shared"], x, whole)
    total, here, dropped = shared.clone(), 0, 0
    for s in range(8):
        cfg = dataclasses.replace(whole, ds_moe=dataclasses.replace(
            whole.ds_moe, n_held=2, held_start=2 * s))
        share = dict(p, gate=p["gate"][2 * s:2 * s + 2], up=p["up"][2 * s:2 * s + 2],
                     down=p["down"][2 * s:2 * s + 2])
        o, a, c = moe.ds_moe_ffn(share, x, cfg)
        total = total + (o - shared)
        here += int(c["moe.choices_here"])
        dropped += int(c["moe.choices_dropped"])
        assert torch.equal(a, aux)  # the balance loss is every share's alike
    torch.testing.assert_close(total, out, rtol=1e-12, atol=1e-12)
    assert here == int(counts["moe.choices_here"]) == 3 * 40 * 6
    assert dropped == int(counts["moe.choices_dropped"]) > 0


def test_counters_and_outputs_on_a_planted_routing():
    """Router and tokens set so that tokens 0–9 pick experts {2, 5} and 10–11
    pick {3, 0}; experts 2 and 3 are held.  Capacity ⌊1.25 · 12 · 2 / 8⌋ = 3:
    expert 2 keeps tokens 0–2 and drops 3–9, expert 3 keeps both of its."""
    cfg = _cfg(d_model=8, param_dtype="float64", compute_dtype="float64")
    cfg = dataclasses.replace(cfg, ds_moe=dataclasses.replace(
        cfg.ds_moe, n_routed=8, top_k=2, n_held=2, held_start=2))
    assert moe.ds_capacity(cfg, 12) == 3
    gen = torch.Generator().manual_seed(2)
    p = moe.init_ds_moe(gen, cfg)
    router = torch.zeros(8, 8, dtype=torch.float64)
    router[0, [2, 5]] = torch.tensor([10.0, 9.0], dtype=torch.float64)
    router[1, [3, 0]] = torch.tensor([10.0, 9.0], dtype=torch.float64)
    p["router"]["w"] = router
    x = torch.zeros(1, 12, 8, dtype=torch.float64)
    x[0, :10, 0] = 1.0
    x[0, 10:, 1] = 1.0
    x = x + 0.01 * torch.randn(1, 12, 8, generator=gen, dtype=torch.float64)
    out, _, counts = moe.ds_moe_ffn(p, x, cfg)
    assert int(counts["moe.choices_here"]) == 12 and int(counts["moe.choices_dropped"]) == 7
    probs = torch.softmax((x @ router).float(), -1)[0].double()  # the router is f32

    def expert(e, t):
        h = x[0, t]
        return (torch.nn.functional.silu(h @ p["gate"][e]) * (h @ p["up"][e])) @ p["down"][e]

    shared = common.mlp(p["shared"], x, cfg)[0]
    for t in range(12):
        want = shared[t].clone()
        if t < 3:
            want += probs[t, 2] * expert(0, t)
        elif t >= 10:
            want += probs[t, 3] * expert(1, t)
        torch.testing.assert_close(out[0, t], want, rtol=1e-6, atol=1e-7)


def test_ds_moe_against_the_plain_reference_layer():
    """The slab-gathered layer against the reference's loop over the held
    experts (first share of 16, top-6, as the CPU size routes)."""
    cfg = _moe_cfg(4, 0, param_dtype="float64", compute_dtype="float64")
    gen = torch.Generator().manual_seed(7)
    p = moe.init_ds_moe(gen, cfg)
    x = torch.randn(2, 32, cfg.d_model, generator=gen, dtype=torch.float64)
    out, aux, _ = moe.ds_moe_ffn(p, x, cfg)
    want, want_aux = ref._moe(p, x)
    # the port's router is f32
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(aux.double(), want_aux, rtol=1e-5, atol=1e-9)


# -- the whole model, and the ColRel local update ----------------------------

def _small_spec():
    return bench_model.cpu_size(_bench_cfg())


def test_loss_against_the_reference_with_counters_beside_it():
    spec = _small_spec()
    cfg = dataclasses.replace(bench_model.model_config(spec), param_dtype="float64",
                              compute_dtype="float64")
    x0 = {k: v.double() for k, v in bench_model.init_params(spec, 3, "cpu").items()}
    params = ref_fl.unflatten(x0)
    g = torch.Generator().manual_seed(4)
    tokens = torch.randint(0, spec["vocab_size"], (2, 32), generator=g)
    targets = torch.randint(0, spec["vocab_size"], (2, 32), generator=g)
    loss_fn = get_model(cfg).loss
    assert loss_fn.clients_in_turn
    got, counters = loss_fn(params, {"tokens": tokens, "labels": targets})
    want = ref.loss(params, tokens, targets)
    torch.testing.assert_close(got.double(), want, rtol=1e-6, atol=1e-6)
    # two MoE layers, two sequences, 32 tokens, 6 choices: a quarter of the
    # router's 16 experts held
    assert 0 < int(counters["moe.choices_here"]) < 2 * 2 * 32 * 6
    assert 0 <= int(counters["moe.choices_dropped"]) <= int(counters["moe.choices_here"])


def test_program_over_clients_matches_the_reference_client_by_client():
    spec = _small_spec()
    loss_fn = bench_model.program_loss(spec)
    x0 = bench_model.init_params(spec, 6, "cpu")
    params = ref_fl.unflatten(x0)
    n, T, b, S = 3, 2, 2, 32
    g = torch.Generator().manual_seed(8)
    tokens = torch.randint(0, spec["vocab_size"], (n, T, b, S + 1), generator=g)
    batch = {"tokens": tokens[..., :-1], "labels": tokens[..., 1:]}
    grad_fn = client_grad_fn(loss_fn)  # the clients in turn, through plain autograd
    deltas, (losses, counters) = local_updates(grad_fn, ClientOpt(weight_decay=1e-4), params,
                                               batch, 0.05, T)
    flat = ref_fl.flatten(deltas)
    for i in range(n):
        want, first = ref_fl.local_update(ref.loss, x0, tokens[i, ..., :-1],
                                          tokens[i, ..., 1:], lr=0.05, wd=1e-4)
        assert float(losses[i]) == pytest.approx(float(first), rel=2e-6)
        for key, d in want.items():
            torch.testing.assert_close(flat[key][i], d, rtol=2e-4, atol=2e-6)
    assert counters["moe.choices_here"].shape == (n,)


def test_clients_in_turn_match_the_vmapped_gradients():
    """The loss's clients taken in turn through plain autograd give the
    vmapped grad_and_value's gradients, values and counters."""
    spec = _small_spec()
    loss_fn = bench_model.program_loss(spec)
    assert loss_fn.clients_in_turn
    params = ref_fl.unflatten(bench_model.init_params(spec, 2, "cpu"))
    n = 3
    stacked = {k: v.expand(n, *v.shape) for k, v in ref_fl.flatten(params).items()}
    stacked = ref_fl.unflatten({k: v + 0.01 * torch.randn(v.shape) for k, v in stacked.items()})
    toks = torch.randint(0, spec["vocab_size"], (n, 2, 33), generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    g1, (v1, c1) = client_grad_fn(loss_fn)(stacked, batch)
    g2, (v2, c2) = torch.func.vmap(torch.func.grad_and_value(loss_fn, has_aux=True))(stacked,
                                                                                       batch)
    torch.testing.assert_close(v1, v2, rtol=1e-6, atol=1e-6)
    assert all(torch.equal(c1[k], c2[k]) for k in c2)
    for a, b in zip(ref_fl.flatten(g1).values(), ref_fl.flatten(g2).values(), strict=True):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)


def _sim_and_feed(spec, n=4):
    sim = FLSimulator(bench_model.program_loss(spec), n_clients=n, strategy="colrel_fused",
                      local_steps=1, client_opt=ClientOpt(weight_decay=1e-4),
                      relay_backend="hopper_fused", device="cpu")
    rng = np.random.default_rng(0)

    def next_batch():
        toks = rng.integers(0, spec["vocab_size"], size=(n, 1, 2, 33)).astype(np.int32)
        return {"tokens": toks[..., :-1], "labels": toks[..., 1:]}

    return sim, next_batch


def test_round_metrics_carry_the_counters_and_the_engine_counts_them():
    """The round's metrics carry the loss's counters summed over clients; a
    traced pipelined engine adds them to its tracer's counters; its
    trajectory stays the loop's, bit for bit."""
    from repro_torch import channels
    from repro_torch.core import topology

    spec = _small_spec()
    n = 4
    x0 = ref_fl.unflatten(bench_model.init_params(spec, 9, "cpu"))
    out = {}
    for kind in ("loop", "pipelined"):
        sim, next_batch = _sim_and_feed(spec, n)
        schedule = channels.StaticChannel(topology.ring(n, 1),
                                          np.array([0.3, 0.6, 0.9, 0.5], dtype=np.float32))
        policy = channels.StaleOptAlpha(sweeps=10)
        gen = torch.Generator().manual_seed(1)
        state = sim.init_server_state(x0)
        if kind == "loop":
            params, _, metrics, _ = run_rounds_loop(
                sim, gen, x0, state, schedule=schedule, rounds=3, next_batch=next_batch,
                lr=0.05, policy=policy)
            counts = {k: int(v.sum()) for k, v in metrics["counters"].items()}
        else:
            tracer = Tracer()
            eng = PipelinedScanEngine(sim, chunk=2, tracer=tracer)
            params, _, metrics, _ = eng.run_schedule(
                gen, x0, state, schedule=schedule, rounds=3, next_batch=next_batch,
                lr=0.05, policy=policy)
            counts = {k: int(v.sum()) for k, v in metrics["counters"].items()}
            assert dict(tracer.counters, **counts) == tracer.counters
        out[kind] = params, counts
    (p_loop, c_loop), (p_pipe, c_pipe) = out["loop"], out["pipelined"]
    assert c_loop == c_pipe and c_loop["moe.choices_here"] > 0
    assert all(torch.equal(a, b) for a, b in zip(ref_fl.flatten(p_loop).values(),
                                                 ref_fl.flatten(p_pipe).values()))


class _Event:
    def __init__(self):
        self.done = False

    def query(self):
        return self.done


def test_tracer_adds_device_counts_once_their_event_completes():
    tracer = Tracer()
    ev = _Event()
    tracer.device_count({"moe.choices_here": torch.tensor(5)}, ev)
    tracer.device_count({"moe.choices_here": torch.tensor(2)}, None)  # the CPU: at once
    assert tracer.counters == {"moe.choices_here": 2}
    ev.done = True
    assert tracer.counters == {"moe.choices_here": 7}
    assert tracer.counters == {"moe.choices_here": 7}  # added once


# -- engines that vmap the loss themselves ----------------------------------


@pytest.mark.parametrize("engine", ["async", "round_step", "fused_scan"])
def test_vmapping_engines_refuse_a_loss_that_takes_its_clients_in_turn(engine):
    from repro_torch.fl import distributed
    from repro_torch.fl.async_engine import AsyncRoundEngine

    spec = _small_spec()
    loss_fn = bench_model.program_loss(spec)
    with pytest.raises(ValueError, match="clients in turn"):
        if engine == "async":
            AsyncRoundEngine(_sim_and_feed(spec)[0])
        elif engine == "round_step":
            distributed.build_round_step(loss_fn, n_clients=4, local_steps=1)
        else:
            distributed.build_fused_scan_round_step(loss_fn, n_clients=4, local_steps=1)


# -- the cell ---------------------------------------------------------------
# portbench/test_portbench_cells.py runs dsv2lite.fig3_ring4_static at its CPU
# size against the reference and under the planted faults, as it runs every
# cell BENCHMARK.json lists


def test_cell_is_listed_on_fig3s_clients_1_2_6_10():
    from pathlib import Path

    from portbench import harness

    root = Path(__file__).resolve().parents[1]
    bench, cell, cfg, traffic = harness.load_cell(root, "dsv2lite.fig3_ring4_static")
    assert cfg["model"] == "deepseek_v2_lite" and cfg["data"]["kind"] == "lm_tokens"
    assert cfg["num_params"] == deepseek_v2_lite.stage(expert_shard=0).param_count()
    assert traffic["channel"]["p0"] == [0.1, 0.2, 0.5, 0.9]  # Fig. 3's clients 1, 2, 6, 10
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    assert sorted(conf["reduced"]) == sorted(cfg["reduced"])
    drop = {m["name"]: m for m in bench["per_layer"]}["moe_dropped_share"]
    assert drop["workloads"] == [cell["name"]]


def test_drop_share_reads_the_counters_and_nothing_without_them():
    from types import SimpleNamespace

    from portbench.metrics import moe_dropped_share

    ctx = SimpleNamespace(counters={"moe.choices_here": 400, "moe.choices_dropped": 3})
    assert moe_dropped_share.read(ctx) == pytest.approx(0.75)
    assert moe_dropped_share.read(SimpleNamespace(counters={})) is None
