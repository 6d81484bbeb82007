"""Each cell's path at a tiny size on the CPU against the plain reference:
sound runs come out correct, runs with the timed path broken underneath
come out not correct, and the result's line has the driver's keys.  The
control (the reference in TF32) needs the card."""
import json
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import calibrate, check, generator, harness
from portbench.reference import fl as ref_fl
from portbench.reference import opt_alpha

ROOT = Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [c["name"] for c in BENCH["workloads"]]
# cells whose files stay under portbench/ while BENCHMARK.json leaves them out
# (PERF.md, Open questions): name → (configuration, traffic mix); their path
# is still held to the reference here
SHELVED = {"mlp.fig5_stale": ("mlp3072_cifar_n10", "fig5_stale")}
ALL_CELLS = CELLS + [c for c in SHELVED if c not in CELLS]


def load(cell):
    """(BENCHMARK.json, the cell, its configuration, its traffic mix), a
    shelved cell's from its files."""
    if cell in CELLS:
        return harness.load_cell(ROOT, cell)
    config, mix = SHELVED[cell]
    cfg = json.loads((ROOT / "portbench" / "configs" / f"{config}.json").read_text())
    traffic = json.loads((ROOT / "portbench" / "traffic" / f"{mix}.json").read_text())
    return BENCH, {"name": cell, "config": config, "traffic": mix, "chips": 1}, cfg, traffic


@pytest.fixture(autouse=True)
def _few_threads():
    # the suite runs several workers side by side
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def tiny_run(cell, *, trace=False, seconds=0.01):
    """The cell at its model's CPU size (``models/<model>.py::cpu_size``), 1
    local step of 4 samples, 200 samples, 3 checked rounds and one-round
    blocks (the engine's chunks run eagerly on the CPU)."""
    bench, spec, cfg, traffic = load(cell)
    cfg = harness.model_module(cfg).cpu_size(cfg)
    cfg = dict(cfg, local_steps=1, local_batch=4, data=dict(cfg["data"], n_train=200))
    traffic = dict(traffic, check_calls=[1, 2], block_rounds=1)
    return harness.run_cell(spec, cfg, traffic, check.load_limits(ROOT, cell), seed=2**33 + 7,
                            seconds=seconds, trace=trace, device="cpu",
                            t_start=time.perf_counter(), bench=bench)


@pytest.mark.parametrize("cell", ALL_CELLS)
def test_tiny_cpu_run_matches_the_reference(cell):
    out = tiny_run(cell)
    assert out["correct"], out["check"]
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "check"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"rounds_per_s", "setup_s"}


def test_traced_line_carries_per_layer_metrics():
    out = tiny_run("resnet20.fig3_static", trace=True, seconds=1.0)
    assert list(out)[-1] == "check" and out["correct"]
    # the readers of host spans and counters read on the CPU; the device's
    # (idle share, kernel time, step_mfu) find nothing there and are left out
    assert set(out["metrics"]) == {"engine_dispatch_ms_per_round", "host_wait_ms_per_round",
                                   "host_prep_ms_per_round"}
    assert out["device"]["window_s"] > 0


def _state_unchanged(monkeypatch):
    from repro_torch.core.aggregation import ServerOpt

    monkeypatch.setattr(ServerOpt, "apply", lambda self, params, state, inc: (params, state))


def _half_batch(monkeypatch):
    from repro_torch.fl import simulator
    from repro_torch.utils import tree_map

    orig = simulator.local_updates

    def half(grad_fn, client_opt, params, batch, lr, steps):
        batch = tree_map(lambda x: x[:, :, : x.shape[2] // 2], batch)
        return orig(grad_fn, client_opt, params, batch, lr, steps)

    monkeypatch.setattr(simulator, "local_updates", half)


def _relay_left_out(monkeypatch):
    from repro_torch.core import relay

    monkeypatch.setattr(relay, "fused_coefficients", lambda A, tau: tau)


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "relay_left_out": _relay_left_out}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", ALL_CELLS)
def test_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    out = tiny_run(cell)
    assert not out["correct"], out["check"]


@pytest.mark.parametrize("cell", ALL_CELLS)
def test_reference_channel_and_relay_weights_follow_the_port(cell):
    """Each mix's channel states and relay matrices, worked out by the
    reference, against the port's schedule and policy, round by round."""
    _, _, cfg, traffic = load(cell)
    n, rounds = cfg["n_clients"], 40
    seeds = harness.inputs.sub_seeds(2**33 + 9)
    schedule, policy = generator.program_channel(traffic, n, seeds)
    states, matrices = generator.reference_channel(traffic, n, seeds, rounds)
    for r, (adj, p, active) in enumerate(states):
        port = schedule.next_round()
        assert np.array_equal(port.adj, adj) and np.array_equal(port.p, p), r
        assert port.active is None and active is None
        np.testing.assert_allclose(policy.relay_matrix(port), matrices[r], rtol=0, atol=1e-12)


def test_fig5_mix_draws_fig5s_channel():
    from repro_torch.bench.figures import fig5_schedule

    _, _, cfg, traffic = load("mlp.fig5_stale")
    ours, _ = generator.program_channel(traffic, cfg["n_clients"], {})
    fig5 = fig5_schedule(cfg["n_clients"], seed=0)
    for r in range(40):
        a, b = ours.next_round(), fig5.next_round()
        assert a.key() == b.key(), r


def test_reference_round_under_a_churn_mask_matches_the_port():
    """The reference's membership mask, which no cell uses yet, against the
    port's round on the same batch, τ, A and mask."""
    _, _, cfg, traffic = load("mlp.fig5_stale")
    cfg = dict(cfg, local_steps=2, local_batch=4, data=dict(cfg["data"], n_train=200))
    cell = harness.build(cfg, traffic, 2**33 + 5, "cpu")
    n = cfg["n_clients"]
    _, matrices = generator.reference_channel(traffic, n, cell.seeds, 1)
    batch = cell.next_batch()
    tau = torch.tensor([1, 0, 1, 1, 0, 1, 1, 0, 1, 1], dtype=torch.float32)
    active = np.ones(n, dtype=bool)
    active[[1, 4, 6]] = False
    out = {}
    for mask in (None, active):
        params, _, metrics = cell.sim.run_round(
            None, cell.params, cell.server_state, batch, cfg["lr"], A=matrices[0],
            active=mask, tau=tau)
        losses, x1, _ = ref_fl.run_rounds(
            cfg["model"], cell.x0, [(batch["images"], batch["labels"])], [tau],
            [matrices[0]], [mask], lr=cfg["lr"], wd=cfg["weight_decay"], device="cpu")
        flat = ref_fl.flatten(params)
        for k, v in x1.items():
            torch.testing.assert_close(flat[k], v, rtol=1e-5, atol=1e-6)
        assert float(metrics["loss"]) == pytest.approx(losses[0], rel=1e-6)
        out["all" if mask is None else "churn"] = losses[0], x1
    # the mask moves both the loss and the update
    assert out["all"][0] != out["churn"][0]
    assert not torch.equal(out["all"][1]["w1"], out["churn"][1]["w1"])


@pytest.mark.parametrize("fault", ["negative", "off_support", "biased"])
def test_opt_alpha_answers_are_held_to_the_guarantees(fault):
    rng = np.random.default_rng(3)
    p = rng.uniform(0.1, 0.9, size=8)
    adj = generator.base_graph({"channel": {"p0": list(p), "topology": {"kind": "ring",
                                                                          "k": 2}}}, 8)
    A = opt_alpha.optimize(p, adj, sweeps=40)  # sound: passes
    s0 = opt_alpha.variance_proxy(p, opt_alpha.initial_weights(p, adj))
    bad = A.copy()
    if fault == "negative":
        bad[np.unravel_index(A.argmax(), A.shape)] *= -1
    elif fault == "off_support":
        bad[0, 4] = 0.1  # clients 0 and 4 are not neighbours on ring(8, 2)
    else:
        bad[:, 2] *= 1.01
    with pytest.raises(ArithmeticError):
        opt_alpha.check_guarantees(p, adj, bad, s0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_in_tf32_is_not_correct(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: TF32 exists only on the card")
    dev = torch.device("cuda")
    limits = check.load_limits(ROOT, cell)
    r = calibrate.readings(cell, 2**33 + 11, dev, controls=True)
    assert check.verdict(r["program"], limits)
    assert not check.verdict(r["control_tf32"], limits)
    assert not check.verdict(r["half_batch"], limits)


# -- a language model that no file of the benchmark names -------------------

LM_CFG = {
    "model": "toy_lm", "model_shape": {"vocab": 64, "hidden": 32},
    "num_params": 64 * 32 + 32 * 64 + 64, "n_clients": 10, "local_steps": 2,
    "local_batch": 4, "lr": 0.5, "weight_decay": 1e-4, "server_lr": 1.0,
    "strategy": "colrel_fused", "relay_backend": "hopper_fused",
    "data": {"kind": "lm_tokens", "n_train": 200, "seq_len": 16, "vocab": 64,
             "n_streams": 8, "noise": 0.05, "partition": "iid"},
}
LM_LIMITS = {"first_loss_gap": 1e-5, "loss_gap": 1e-4, "first_update_gap": 1e-3,
             "change_gap": 1e-3}


def _lm_loss(params, tokens, targets):
    """An embedding and one linear head, mean next-token cross-entropy."""
    h = params["emb"][tokens.long()]
    logits = h @ params["head"]["w"] + params["head"]["b"]
    return torch.nn.functional.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                             targets.reshape(-1).long())


def _lm_modules():
    """The model file and the plain reference of the toy LM, as modules
    (what ``run_cell`` reads of them)."""
    import types

    model = types.ModuleType("portbench.models.toy_lm")

    def leaf_shapes(cfg):
        v, h = cfg["model_shape"]["vocab"], cfg["model_shape"]["hidden"]
        return {"emb": (v, h), "head/b": (v,), "head/w": (h, v)}

    def init_params(cfg, seed, device):
        shapes = leaf_shapes(cfg)
        gen = torch.Generator(device=device).manual_seed(seed)
        (v, h) = shapes["emb"]
        flat = torch.randn(2 * v * h, generator=gen, device=device)
        return {"emb": flat[: v * h].view(v, h), "head/b": torch.zeros(v, device=device),
                "head/w": flat[v * h:].view(h, v) * h**-0.5}

    model.leaf_shapes = leaf_shapes
    model.init_params = init_params
    model.program_loss = lambda cfg: lambda params, batch: _lm_loss(
        params, batch["tokens"], batch["labels"])
    model.forward_flops_per_sample = lambda cfg: 2 * 16 * 32 * 64
    reference = types.ModuleType("portbench.reference.toy_lm")
    reference.loss = _lm_loss
    return model, reference


def _lm_run(monkeypatch):
    model, reference = _lm_modules()
    monkeypatch.setitem(sys.modules, "portbench.models.toy_lm", model)
    monkeypatch.setitem(sys.modules, "portbench.reference.toy_lm", reference)
    traffic = json.loads((ROOT / "portbench" / "traffic" / "fig3_static.json").read_text())
    traffic = dict(traffic, check_calls=[1, 2], block_rounds=1)
    spec = {"name": "toy_lm.fig3_static", "config": "toy_lm", "traffic": "fig3_static",
            "chips": 1}
    return harness.run_cell(spec, LM_CFG, traffic, LM_LIMITS, seed=2**33 + 13, seconds=0.01,
                            trace=False, device="cpu", t_start=time.perf_counter(),
                            bench=BENCH)


def test_lm_configuration_runs_through_new_modules_alone(monkeypatch):
    out = _lm_run(monkeypatch)
    assert out["correct"], out["check"]
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_lm_broken_timed_path_is_not_correct(fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    out = _lm_run(monkeypatch)
    assert not out["correct"], out["check"]


def test_lm_reference_batches_are_the_loaders():
    """The reference's token batches equal what the port's loader gives
    its LM loss, round after round."""
    from repro_torch.data.loader import FederatedLoader

    seeds = harness.inputs.sub_seeds(2**33 + 15)
    ds, parts = harness.inputs.make_data(LM_CFG["data"], 10, seeds)
    assert harness.inputs.data_kind(LM_CFG["data"]).LM
    assert ds.inputs.shape == (200, 17) and ds.inputs.dtype == np.int32
    loader = FederatedLoader(ds, parts, seed=seeds["loader"])
    stream = ref_fl.batch_stream(ds, parts, seeds["loader"], 3, 2, 4, lm=True)
    for tokens, targets in stream:
        batch = loader.round_batch(2, 4, lm=True)
        assert tokens.shape == (10, 2, 4, 16)
        assert np.array_equal(batch["tokens"], tokens)
        assert np.array_equal(batch["labels"], targets)


def test_cifar_like_through_the_dispatch_is_the_frozen_copy():
    from portbench.data import cifar_like

    data = {"kind": "cifar_like", "n_train": 120, "n_classes": 10, "snr": 0.5,
            "partition": "iid"}
    seeds = harness.inputs.sub_seeds(2**33 + 17)
    ds, parts = harness.inputs.make_data(data, 10, seeds)
    frozen = cifar_like.cifar_like(120, n_classes=10, snr=0.5, seed=seeds["data"])
    assert not cifar_like.LM
    assert np.array_equal(ds.inputs, frozen.inputs) and np.array_equal(ds.labels, frozen.labels)
    for a, b in zip(parts, harness.inputs.iid_partition(120, 10, seed=seeds["partition"]),
                    strict=True):
        assert np.array_equal(a, b)


# -- the streamed reference against the straightforward one -----------------

def _local_update_out_of_place(loss_fn, x, images, labels, *, lr, wd):
    p = {k: v.clone().requires_grad_(True) for k, v in x.items()}
    first = None
    for t in range(images.shape[0]):
        loss = loss_fn(ref_fl.unflatten(p), images[t], labels[t])
        grads = torch.autograd.grad(loss, list(p.values()))
        with torch.no_grad():
            p = {k: (v - lr * (g + wd * v)).requires_grad_(True)
                 for (k, v), g in zip(p.items(), grads)}
        if first is None:
            first = loss.detach()
    return {k: (p[k].detach() - x[k]) for k in x}, first


def _rounds_all_deltas_then_sum(model, x0, batches, tau_list, A_list, active_list, *, lr, wd):
    """Every client's Δ first, then u = Σ_i coeff_i Δ_i in ascending i:
    (losses, x after each round)."""
    import importlib

    loss_fn = importlib.import_module(f"portbench.reference.{model}").loss
    x = {k: v.clone() for k, v in x0.items()}
    losses, xs = [], []
    for (images, labels), tau, A, active in zip(batches, tau_list, A_list, active_list,
                                                strict=True):
        n = images.shape[0]
        images, labels = torch.as_tensor(images), torch.as_tensor(labels)
        deltas, firsts = [], []
        for i in range(n):
            d, first = _local_update_out_of_place(loss_fn, x, images[i], labels[i], lr=lr,
                                                  wd=wd)
            deltas.append(d)
            firsts.append(first)
        A = torch.as_tensor(A, dtype=torch.float32)
        firsts = torch.stack(firsts)
        if active is None:
            w, loss = 1.0 / n, firsts.mean()
        else:
            a = torch.as_tensor(active, dtype=torch.float32)
            members = torch.clamp(a.sum(), min=1.0)
            w, loss = 1.0 / members, (firsts * a).sum() / members
            A, tau = A * a[:, None] * a[None, :], tau * a
        coeffs = w * (tau @ A)
        new_x = {}
        for k in x:
            u = torch.zeros_like(x[k])
            for i in range(n):
                u = u + coeffs[i] * deltas[i][k]
            new_x[k] = x[k] + u
        x = new_x
        losses.append(float(loss))
        xs.append({k: v.clone() for k, v in x.items()})
    return losses, xs


@pytest.mark.parametrize("churn", [False, True])
def test_streamed_reference_is_the_straightforward_one_bit_for_bit(churn):
    _, _, cfg, traffic = load("resnet20.fig3_static")
    n, T, b, k = cfg["n_clients"], 1, 4, 3
    seeds = harness.inputs.sub_seeds(2**33 + 19)
    ds, parts = harness.inputs.make_data(dict(cfg["data"], n_train=200), n, seeds)
    x0 = harness.model_module(cfg).init_params(cfg, seeds["params"], "cpu")
    states, matrices = generator.reference_channel(traffic, n, seeds, k)
    taus = ref_fl.taus(seeds["tau"], [p for _, p, _ in states], "cpu")
    active = np.ones(n, dtype=bool)
    active[[2, 7]] = False
    masks = [active if churn and r % 2 == 0 else None for r in range(k)]
    batches = list(ref_fl.batch_stream(ds, parts, seeds["loader"], k, T, b))
    kw = dict(lr=cfg["lr"], wd=cfg["weight_decay"])
    losses, x1, xk = ref_fl.run_rounds(cfg["model"], x0, batches, taus, matrices, masks,
                                       device="cpu", **kw)
    plain_losses, xs = _rounds_all_deltas_then_sum(cfg["model"], x0, batches, taus, matrices,
                                                   masks, **kw)
    assert losses == plain_losses
    for ours, theirs in ((x1, xs[0]), (xk, xs[-1])):
        assert list(ours) == list(theirs)
        assert all(torch.equal(ours[key], theirs[key]) for key in theirs)
