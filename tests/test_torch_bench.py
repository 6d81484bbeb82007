"""The port's bench harness (``repro_torch.bench``) against the JAX package's
``repro.bench``.  Oracle: ``tests/test_bench.py``.

* Registry: every ported spec equals the JAX spec field for field once the
  backend names are mapped; the ported scenarios are the whole JAX registry
  (the mesh and shard scenarios included; their runs are
  ``tests/test_torch_sharded_engine.py``).
* Bundles, equal and not just close: base graph and p, the schedule's
  ``ChannelState`` stream and ``segments()``, the policy's A per segment and
  the pre-generated batches, for every ported scenario cut to ≤ 16 rounds.
* The scenario MLP: loss and grad within 1e-6 of ``jax.value_and_grad``;
  ``bench_smoke`` through each package's ``EpochScanEngine.run_segment``
  within 1e-5 (JAX's initial params and τ handed over as arrays).
* The harness on the CPU (the kernel backends run their plain versions
  there): the bitwise and kernel gates pass and catch a perturbed final;
  the report keeps its schema; the CLI writes under ``build/bench_torch``.
"""
import dataclasses
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.bench import harness as jax_harness
from repro.bench import scenarios as jax_scenarios
from repro.fl.engine import EpochScanEngine as JaxEpochScanEngine
from repro_torch.bench import harness, report as report_lib, scenarios
from repro_torch.core.relay import EdgeRelay
from repro_torch.fl.engine import EpochScanEngine
from repro_torch.utils import from_jax_params, tree_flatten

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORTED = [s.name for s in scenarios.list_scenarios()]
CUT = 16


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    # the suite runs several test processes side by side
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _mapped(jspec) -> dict:
    """The JAX spec's fields with its backend names mapped to the port's."""
    d = dataclasses.asdict(jspec)
    for key in ("relay_backend", "check_backend"):
        d[key] = scenarios.BACKEND_FROM_JAX.get(d[key], d[key])
    return d


def _same_operand(t, j) -> bool:
    """A relay operand equal to the JAX package's: a dense matrix, or an
    EdgeRelay's indices and values (the port's also carries its layout)."""
    if isinstance(t, EdgeRelay):
        return all(np.array_equal(x, y) and np.asarray(x).dtype == np.asarray(y).dtype
                   for x, y in zip((t.rows, t.cols, t.vals), (j.rows, j.cols, j.vals)))
    return np.array_equal(t, j)


def _cut(spec, rounds=CUT):
    return dataclasses.replace(spec, rounds=min(spec.rounds, rounds))


# -------------------------------------------------------------- registry


@pytest.mark.parametrize("name", PORTED)
def test_ported_spec_equals_jax_spec(name):
    assert dataclasses.asdict(scenarios.get_scenario(name)) == _mapped(
        jax_scenarios.get_scenario(name)
    )


def test_ported_and_unported_make_the_jax_registry():
    jax_names = {s.name for s in jax_scenarios.list_scenarios()}
    assert scenarios.NOT_YET_PORTED == {}
    assert set(PORTED) == jax_names
    assert {"bench_smoke", "resnet20_cifar", "relay_sweep_1e7", "mesh8_smoke",
            "mesh_corr_500"} <= set(PORTED)


def test_spec_validation_and_registry_errors():
    base = scenarios.get_scenario("bench_smoke")
    for change, match in ((dict(step="ring"), "unknown step"),
                          (dict(engines=("loop", "fused")), "unknown engines"),
                          (dict(delay="poisson"), "only drives the async engine"),
                          (dict(engines=("loop", "async"), strategy="colrel"),
                           "async engine supports"),
                          (dict(relay_backend="segment"), "needs policy='sparse'"),
                          (dict(sampling="fixed_k"), "needs sample_k"),
                          (dict(sampling="uniform", sample_rate=0.0), "sample_rate"),
                          (dict(topology="geometric", geo_degree=0.0), "geo_degree"),
                          (dict(relay_backend="pallas"), "unknown relay_backend"),
                          (dict(check_backend="einsum"), "must differ"),
                          (dict(fading="corr_uplink"), "corr_uplink"),
                          (dict(model="vit"), "unknown model")):
        with pytest.raises(ValueError, match=match):
            dataclasses.replace(base, **change)
    with pytest.raises(KeyError, match="unknown scenario"):
        scenarios.get_scenario("no_such_scenario")
    with pytest.raises(ValueError, match="already registered"):
        scenarios.register(base)


# ---------------------------------------------------------------- bundles


@pytest.mark.parametrize("name", PORTED)
def test_bundle_equals_jax_bundle(name):
    tspec = _cut(scenarios.get_scenario(name))
    jspec = _cut(jax_scenarios.get_scenario(name))
    tb, jb = scenarios.build(tspec, device="cpu"), jax_scenarios.build(jspec)
    assert np.array_equal(tb.base_adjacency(), jb.base_adjacency())
    assert np.array_equal(tb.base_p(), jb.base_p())
    for ts, js in zip(tb.make_schedule().rounds(tspec.rounds),
                      jb.make_schedule().rounds(jspec.rounds), strict=True):
        assert (ts.round, ts.epoch_id) == (js.round, js.epoch_id)
        assert ts.key() == js.key()
    tpol, jpol = tb.make_policy(), jb.make_policy()
    for tseg, jseg in zip(tb.make_schedule().segments(tspec.rounds),
                          jb.make_schedule().segments(jspec.rounds), strict=True):
        assert (tseg.epoch_id, tseg.start_round, tseg.n_rounds) == (
            jseg.epoch_id, jseg.start_round, jseg.n_rounds)
        assert tseg.state.key() == jseg.state.key()
        assert _same_operand(tpol.relay_matrix(tseg.state), jpol.relay_matrix(jseg.state))
    assert dataclasses.asdict(tpol.stats) == dataclasses.asdict(jpol.stats)
    for tbatch, jbatch in zip(harness._pregenerate_batches(tb),
                              jax_harness._pregenerate_batches(jb), strict=True):
        assert tbatch.keys() == jbatch.keys()
        for key in tbatch:
            assert tbatch[key].dtype == jbatch[key].dtype
            assert np.array_equal(tbatch[key], jbatch[key])


def test_unported_bundle_branches_raise():
    """The bundle branches that raised until the sparse and async slices
    (geometric graph, cohort sampler, sparse policy, delays) now build the
    JAX package's objects; unknown values still raise."""
    from repro_torch import channels

    bundle = scenarios.build(scenarios.get_scenario("sample_sweep_smoke"), device="cpu")
    assert isinstance(bundle.make_policy(), channels.SparseOptAlpha)
    assert isinstance(bundle.make_schedule()._member, channels.CohortSampler)
    jb = jax_scenarios.build(jax_scenarios.get_scenario("async_smoke"))
    tb = scenarios.build(scenarios.get_scenario("async_smoke"), device="cpu")
    td, jd = tb.make_delays(), jb.make_delays()
    assert isinstance(td, channels.GeometricDelays)
    for _ in range(5):
        assert np.array_equal(td.sample(), jd.sample())
    for change in (dict(topology="torus"), dict(policy="greedy"), dict(delay="uniform")):
        bad = scenarios.build(dataclasses.replace(scenarios.get_scenario("bench_smoke"),
                                                  name="x"), device="cpu")
        object.__setattr__(bad.spec, *next(iter(change.items())))
        with pytest.raises(ValueError, match="unknown"):
            {"topology": bad.base_adjacency, "policy": bad.make_policy,
             "delay": bad.make_delays}[next(iter(change))]()


# ---------------------------------------------------------------- the MLP


def _mlp_pair(name):
    spec = scenarios.get_scenario(name)
    jb = jax_scenarios.build(jax_scenarios.get_scenario(name))
    tb = scenarios.build(spec, device="cpu")
    jparams = jb.init_fn(jax.random.key(spec.seed))
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
    return spec, jb, tb, jparams, tparams


@pytest.mark.parametrize("name", ["bench_smoke", "relay_sweep_smoke"])
def test_mlp_loss_and_grad_match_jax(name):
    spec, jb, tb, jparams, tparams = _mlp_pair(name)
    batch = jb.make_loader().round_batch(spec.local_steps, spec.local_batch)
    one = {k: v[0, 0] for k, v in batch.items()}  # client 0, step 0: (b, ...)
    jloss, jgrad = jax.value_and_grad(jb.loss_fn)(jparams, jax.tree.map(jnp.asarray, one))
    tloss, tgrad = torch.func.grad_and_value(tb.loss_fn)(
        tparams, {k: torch.as_tensor(v) for k, v in one.items()})[::-1]
    np.testing.assert_allclose(float(tloss), float(jloss), atol=1e-6, rtol=1e-6)
    for key in jgrad:
        np.testing.assert_allclose(tgrad[key].numpy(), np.asarray(jgrad[key]),
                                   atol=1e-6, rtol=1e-6)
    # init draws on the CPU from the seed: the same params every call
    assert all(torch.equal(a, b) for a, b in zip(tree_flatten(tb.init_fn(0))[0],
                                                 tree_flatten(tb.init_fn(0))[0]))
    assert tree_flatten(tb.init_fn(0))[0][0].device.type == "cpu"


def test_bench_smoke_engine_matches_jax_engine():
    name = "bench_smoke"
    spec, jb, tb, jparams, tparams = _mlp_pair(name)
    spec = _cut(spec)
    jb = jax_scenarios.build(_cut(jax_scenarios.get_scenario(name)))
    tb = scenarios.build(spec, device="cpu")
    jsim, tsim = jb.make_sim(), tb.make_sim()
    jeng = JaxEpochScanEngine(jsim, chunk=spec.chunk)
    teng = EpochScanEngine(tsim, chunk=spec.chunk)
    js, ts = jsim.init_server_state(jparams), tsim.init_server_state(tparams)
    jpol, tpol = jb.make_policy(), tb.make_policy()
    batches = iter(jax_harness._pregenerate_batches(jb))
    key = jax.random.key(spec.seed + 1)
    jlosses, tlosses = [], []
    n_segs = 0
    for jseg, tseg in zip(jb.make_schedule().segments(spec.rounds),
                          tb.make_schedule().segments(spec.rounds), strict=True):
        A = jpol.relay_matrix(jseg.state)
        tA = tpol.relay_matrix(tseg.state)
        key, taus = jeng.sample_taus(key, jseg.p, jseg.n_rounds)
        seg = [next(batches) for _ in range(jseg.n_rounds)]
        stacked = {k: np.stack([b[k] for b in seg]) for k in seg[0]}
        jparams, js, jm = jeng.run_segment(jparams, js, jax.tree.map(jnp.asarray, stacked),
                                           taus, spec.lr, A=A, active=jseg.active)
        tparams, ts, tm = teng.run_segment(tparams, ts, stacked, np.array(taus), spec.lr,
                                           A=tA, active=tseg.active)
        jlosses.append(np.asarray(jm["loss"]))
        tlosses.append(tm["loss"].numpy())
        n_segs += 1
    assert n_segs == CUT // spec.adj_every
    np.testing.assert_allclose(np.concatenate(tlosses), np.concatenate(jlosses),
                               atol=1e-5, rtol=1e-5)
    for w, g in zip(jax.tree.leaves(jparams), tree_flatten(tparams)[0], strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------- harness


@pytest.mark.parametrize("name", ["bench_smoke", "relay_sweep_smoke", "resnet20_cifar"])
def test_run_scenario_gates_pass_on_cpu(name, tmp_path):
    spec = scenarios.get_scenario(name)
    engines = None
    if name == "bench_smoke":
        spec = _cut(spec)
    elif name == "resnet20_cifar":
        # the paper's model at full width, cut in rounds and engines for the CPU
        spec, engines = dataclasses.replace(spec, rounds=3, chunk=2), ("loop", "scan")
    result = harness.run_scenario(spec, engines=engines, device="cpu",
                                  trace_dir=tmp_path if name == "relay_sweep_smoke" else None)
    runs = result["runs"]
    assert result["bitwise_match"] is True
    assert result["device"] == torch.device("cpu")
    want = set(engines or spec.engines)
    if spec.check_backend != "none":
        want.add(f"scan_{spec.check_backend}")
        check = result["kernel_check"]
        assert check["allclose"] is True and check["backend"] == spec.check_backend
        assert check["reference_backend"] == "einsum" and check["engine"] == "scan"
        assert 0.0 <= check["max_abs_diff"] <= 1e-5
    else:
        assert result["kernel_check"] is None
    assert set(runs) == want
    segs = list(scenarios.build(spec, device="cpu").make_schedule().segments(spec.rounds))
    for run in runs.values():
        # the CPU captures nothing: the scan engines count 0 captures, the
        # loop and the async engine none at all
        assert run.trace_count == (0 if run.engine.startswith(("scan", "pipelined")) else None)
        assert run.wall_s > 0 and run.compile_s >= 0
        assert run.final_loss == runs["loop"].final_loss and len(run.losses) == spec.rounds
        # on the CPU the wrappers run their plain versions: no launches
        assert run.kernel_launches == {"relay_mix_2d": 0, "fused_aggregate_2d": 0}
        want_dispatches = (spec.rounds if run.engine == "loop" else
                           sum(-(-s.n_rounds // spec.chunk) for s in segs))
        assert run.dispatches == want_dispatches
    assert runs["loop"].overlap_fraction is None
    if "pipelined" in runs:
        assert 0.0 <= runs["pipelined"].overlap_fraction <= 1.0
        assert runs["pipelined"].chunks_staged == runs["pipelined"].dispatches
    assert set(result["speedups"]) == want - {"loop"}
    assert result["model_params"] == {"bench_smoke": 698, "relay_sweep_smoke": 10_282,
                                      "resnet20_cifar": 272_282}[name]
    if name == "relay_sweep_smoke":
        for engine in spec.engines:
            assert (tmp_path / f"TRACE_{name}_{engine}.json").exists()
            assert runs[engine].telemetry["events"] > 0
        rep = report_lib.make_report(spec, result)
        assert set(rep["telemetry"]) == set(spec.engines)


def test_mesh_scenario_gates_pass_on_cpu(tmp_path):
    """mesh_corr_500 (cut to 50 rounds, with the hopper_fused check added):
    the three mesh steps bitwise equal, one call a round for the loop and
    one an epoch for the scan steps, the kernel check within 1e-5, a traced
    pass with the mesh spans."""
    spec = dataclasses.replace(scenarios.get_scenario("mesh_corr_500"), rounds=50,
                               check_backend="hopper_fused")
    result = harness.run_scenario(spec, device="cpu", trace_dir=tmp_path)
    runs = result["runs"]
    assert result["bitwise_match"] is True and result["shard_check"] is None
    assert result["kernel_check"]["allclose"] and result["kernel_check"]["max_abs_diff"] <= 1e-5
    segs = list(scenarios.build(spec, device="cpu").make_schedule().segments(spec.rounds))
    assert len(segs) == 2
    for name, run in runs.items():
        assert run.dispatches == (spec.rounds if name == "loop" else len(segs))
        assert run.final_loss == runs["loop"].final_loss and len(run.losses) == spec.rounds
    assert runs["pipelined"].chunks_staged == len(segs)
    assert result["model_params"] == 64 * 32 + 32 + 32 * 10 + 10
    spans = {e["name"] for e in json.loads(
        (tmp_path / "TRACE_mesh_corr_500_pipelined.json").read_text())["traceEvents"]}
    assert {"mesh.fused", "mesh.device"} <= spans


@pytest.mark.parametrize("gate", ["bitwise", "kernel"])
def test_gates_catch_a_perturbed_final(gate, monkeypatch):
    real = harness.run_engine

    def perturbed(bundle, name, batches, trace_dir=None):
        run, final = real(bundle, name, batches, trace_dir)
        hit = (name == "scan" and bundle.spec.relay_backend != "einsum") if gate == "kernel" \
            else name == "pipelined"
        if hit:
            final = dict(final, w1=final["w1"] + (1e-3 if gate == "kernel" else 1e-7))
        return run, final

    monkeypatch.setattr(harness, "run_engine", perturbed)
    match = "diverged bitwise" if gate == "bitwise" else "hopper_fused backend diverged"
    with pytest.raises(AssertionError, match=match):
        harness.run_scenario("relay_sweep_smoke", device="cpu")


def test_ttac_and_unported_engines():
    spec = dataclasses.replace(_cut(scenarios.get_scenario("bench_smoke"), 8),
                               ttac_target_loss=10.0)
    result = harness.run_scenario(spec, engines=("loop",), device="cpu")
    assert result["bitwise_match"] is None  # one engine: nothing to compare
    assert result["ttac"]["engines"]["loop"]["rounds_to_target"] == 1
    # the async engine (the last engine refused until the async slice) runs
    # and reports its time to accuracy; at delay 0 it joins the bitwise gate
    result = harness.run_scenario(spec, engines=("loop", "async"), device="cpu")
    assert result["bitwise_match"] is True and result["async_check"] is None
    ttac = result["ttac"]["engines"]
    assert ttac["async"]["rounds_to_target"] == ttac["loop"]["rounds_to_target"] == 1
    assert ttac["async"]["seconds_to_target"] > 0
    assert result["runs"]["async"].dispatches == spec.rounds


# ---------------------------------------------------------- report + gate

TINY = dataclasses.replace(_cut(scenarios.get_scenario("bench_smoke"), 8), name="tiny_test")


def _engine_run(rps):
    return harness.EngineRun(engine="x", wall_s=TINY.rounds / rps, compile_s=0.5,
                             rounds_per_sec=rps, trace_count=None, dispatches=8,
                             final_loss=1.0, kernel_launches={"relay_mix_2d": 0})


def _fake_result():
    return {"runs": {"loop": _engine_run(100.0), "scan": _engine_run(500.0)},
            "speedup": 5.0, "bitwise_match": True, "device": torch.device("cpu")}


def test_report_schema_and_roundtrip(tmp_path):
    rep = report_lib.make_report(TINY, _fake_result())
    assert rep["schema_version"] == report_lib.SCHEMA_VERSION == 1
    jax_keys = set(json.loads((ROOT / "BENCH_bench_smoke.json").read_text()))
    assert set(rep) >= (jax_keys - {"jax_version"}) | {"torch_version", "device"}
    assert "jax_version" not in rep
    assert rep["backend"] == "cpu" and rep["torch_version"] == torch.__version__
    assert rep["device"] == {"name": "cpu", "power_limit_w": None,
                             "cuda_version": torch.version.cuda}
    assert rep["spec"] == {k: list(v) if isinstance(v, tuple) else v
                           for k, v in dataclasses.asdict(TINY).items()}
    assert rep["engines"]["loop"]["trace_count"] is None
    assert rep["engines"]["loop"]["kernel_launches"] == {"relay_mix_2d": 0}
    path = report_lib.write_report(rep, tmp_path)
    assert path.name == "BENCH_tiny_test.json"
    assert report_lib.load_report(path) == rep
    path.write_text(json.dumps(dict(rep, schema_version=999)))
    with pytest.raises(ValueError, match="schema_version"):
        report_lib.load_report(path)


def test_gate_passes_itself_catches_slowdown_and_foreign_baselines():
    base = report_lib.make_report(TINY, _fake_result())
    assert report_lib.check_regression(base, base) == []

    def edited(**top):
        rep = json.loads(json.dumps(base))
        rep.update(top)
        return rep

    slow = edited()
    slow["engines"]["scan"]["rounds_per_sec"] /= 3.0
    assert any("scan" in f and "regressed" in f
               for f in report_lib.check_regression(slow, base, factor=2.0))
    ok = edited()
    ok["engines"]["scan"]["rounds_per_sec"] /= 1.5
    assert report_lib.check_regression(ok, base, factor=2.0) == []
    # a baseline with a trace count (the JAX package's) against the port's null
    counted = edited()
    counted["engines"]["scan"]["trace_count"] = 1
    assert report_lib.check_regression(base, counted) == []
    assert any("bit-identical" in f
               for f in report_lib.check_regression(edited(bitwise_match=False), base))
    assert any("speedup" in f
               for f in report_lib.check_regression(edited(speedup_rounds_per_sec=1.0), base))
    for other, what in ((edited(scenario="other"), "scenario"),
                        (edited(backend="cuda"), "backend"),
                        (edited(device=dict(base["device"], name="NVIDIA H100")), "device")):
        fails = report_lib.check_regression(other, base)
        assert len(fails) == 1 and fails[0].startswith(f"{what} mismatch")
    # the JAX package's recorded CPU baseline is not the port's
    jax_base = report_lib.load_report(ROOT / "benchmarks/baselines/BENCH_bench_smoke.json")
    port = report_lib.make_report(scenarios.get_scenario("bench_smoke"), _fake_result())
    assert report_lib.check_regression(port, jax_base) == [
        "device mismatch: report 'cpu' vs baseline None"]


def test_cli_writes_under_build_not_at_the_root(tmp_path, monkeypatch, capsys):
    from repro_torch.bench import run as run_cli

    assert run_cli.main(["--list"]) == 0
    listed = capsys.readouterr().out
    assert all(name in listed for name in PORTED)
    monkeypatch.chdir(tmp_path)
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    try:
        assert run_cli.main(["--scenario", "relay_sweep_smoke", "--device", "cpu",
                             "--engines", "loop,scan"]) == 0
        out = capsys.readouterr().out
        rep = report_lib.load_report(
            tmp_path / "build/bench_torch/BENCH_relay_sweep_smoke.json")
        # a baseline of another scenario fails the gate
        assert run_cli.main(["--scenario", "relay_sweep_smoke", "--device", "cpu",
                             "--engines", "loop", "--baseline",
                             str(ROOT / "benchmarks/baselines/BENCH_bench_smoke.json")]) == 1
    finally:
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark) = tf32
    assert "kernel check [hopper_fused]" in out and "device cpu" in out
    assert [p.name for p in tmp_path.iterdir()] == ["build"]
    assert rep["backend"] == "cpu" and set(rep["engines"]) == {"loop", "scan",
                                                              "scan_hopper_fused"}
