"""Each cell's path at a tiny size on the CPU against the plain reference:
sound runs come out correct, runs with the timed path broken underneath
come out not correct, and the result's line has the driver's keys.  The
control (the reference in TF32) needs the card."""
import json
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
    """The cell at 1 local step of 4 images, 200 images, 3 checked rounds and
    one-round blocks (the engine's chunks run eagerly on the CPU)."""
    bench, spec, cfg, traffic = load(cell)
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
        losses, xs = ref_fl.run_rounds(
            cfg["model"], cell.x0, [(batch["images"], batch["labels"])], [tau],
            [matrices[0]], [mask], lr=cfg["lr"], wd=cfg["weight_decay"], device="cpu")
        flat = ref_fl.flatten(params)
        for k, v in xs[0].items():
            torch.testing.assert_close(flat[k], v, rtol=1e-5, atol=1e-6)
        assert float(metrics["loss"]) == pytest.approx(losses[0], rel=1e-6)
        out["all" if mask is None else "churn"] = losses[0], xs[0]
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
