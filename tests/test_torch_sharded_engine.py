"""The port's sharded step and ``ShardedScanEngine`` on gloo worlds of CPU
ranks.  Oracle: ``tests/test_sharded_engine.py``.

In one process: the backend refusals under sharding
(``validate_sharded_backend``), shard-spec validation, the engine's mode
errors, the prefetcher's ``place`` hook, and the sharded step and engine on
a one-rank mesh.  On k = 2 and 4 gloo ranks:

* the sharded step, ``exchange="gather"``, bitwise equal to the one-rank
  fused scan step (params, losses, generator state) on the scenario MLP,
  with and without churn, on ``einsum`` and ``hopper_fused`` (whose plain
  version runs on the CPU); ``exchange="ring"`` and ``shard="d"`` within
  1e-5.  ResNet-20/GN's gather at k = 2 is bitwise with oneDNN off: with it
  on, the CPU's grouped convolution of the 3-channel stem rounds
  differently for 2 clients than for 4, so there the gather is held at
  1e-5 (the card pins its algorithms with deterministic cuDNN instead);
* the engine over a churned, shadowed schedule: gather bitwise equal to the
  one-rank walk in serial, inline and threaded staging, ring and d within
  1e-5, one call an epoch, the same generator state; each rank stages only
  its own clients' rows;
* ``mesh8_smoke`` through the bench harness on 8 ranks with its
  ``shard_check`` and kernel check, and the error a shard scenario gives
  in a process without ranks.
"""
import dataclasses

import numpy as np
import pytest
import torch

import torch_ranks
from repro_torch import channels
from repro_torch.bench import harness, scenarios
from repro_torch.channels.scheduler import SegmentPrefetcher
from repro_torch.core import topology
from repro_torch.fl import distributed
from repro_torch.fl.engine import ShardedScanEngine
from repro_torch.kernels.ops import validate_sharded_backend
from repro_torch.launch.mesh import make_client_mesh, run_ranks

# ------------------------------------------------- backend dispatch rules


def test_sharded_backend_gather_allows_kernels():
    for backend in ("einsum", "hopper", "hopper_fused"):
        assert validate_sharded_backend(backend, shard="clients", exchange="gather") == backend
    assert validate_sharded_backend("einsum", shard="d") == "einsum"
    assert validate_sharded_backend("einsum", shard="clients", exchange="ring") == "einsum"


@pytest.mark.parametrize("backend", ["hopper", "hopper_fused"])
def test_sharded_backend_ring_and_d_refuse_kernels(backend):
    with pytest.raises(ValueError, match="rotations"):
        validate_sharded_backend(backend, shard="clients", exchange="ring")
    with pytest.raises(ValueError, match="column slice"):
        validate_sharded_backend(backend, shard="d")


def test_sharded_backend_refuses_segment_everywhere():
    for kw in (dict(shard="clients"), dict(shard="clients", exchange="ring"), dict(shard="d")):
        with pytest.raises(ValueError, match="single-host only"):
            validate_sharded_backend("segment", **kw)
    with pytest.raises(ValueError, match="unknown relay_backend"):
        validate_sharded_backend("pallas", shard="clients")


# ------------------------------------------------------- spec validation


def _shard_spec(**kw):
    base = dict(name="t", n_clients=8, rounds=8, step="shard", devices=8)
    base.update(kw)
    return scenarios.ScenarioSpec(**base)


def test_shard_spec_valid_cases():
    assert _shard_spec().devices == 8
    assert _shard_spec(exchange="ring").exchange == "ring"
    assert _shard_spec(check_backend="hopper_fused").check_backend == "hopper_fused"
    assert _shard_spec(devices=2, shard="d").shard == "d"


def test_shard_spec_rejects_bad_configs():
    for kw, match in ((dict(devices=1), "devices >= 2"), (dict(n_clients=10), "divide"),
                      (dict(policy="none"), "relay policy"), (dict(strategy="colrel"), "fused"),
                      (dict(exchange="butterfly"), "unknown exchange"),
                      (dict(shard="rows"), "unknown shard"),
                      (dict(exchange="ring", relay_backend="hopper_fused"), "rotations"),
                      (dict(exchange="ring", check_backend="hopper_fused"), "rotations"),
                      (dict(devices=2, shard="d", relay_backend="hopper"), "column slice"),
                      (dict(sampling="fixed_k", sample_k=2), "sim path only"),
                      (dict(step="mesh", devices=1, churn="rotating"), "churn masks"),
                      (dict(step="mesh", devices=1, strategy="colrel"), "fused relay only")):
        with pytest.raises(ValueError, match=match):
            _shard_spec(**kw)


def test_engine_rejects_bad_modes():
    with pytest.raises(ValueError, match="prefetch"):
        ShardedScanEngine(lambda *a, **k: None, mesh=None, prefetch="eager")
    with pytest.raises(ValueError, match="shard"):
        ShardedScanEngine(lambda *a, **k: None, mesh=None, shard="rows")
    mesh = make_client_mesh()
    with pytest.raises(ValueError, match="unknown exchange"):
        distributed.build_sharded_scan_round_step(
            lambda p, b: 0, n_clients=4, local_steps=1, mesh=mesh, exchange="butterfly")
    with pytest.raises(ValueError, match="unknown shard"):
        distributed.build_sharded_scan_round_step(
            lambda p, b: 0, n_clients=4, local_steps=1, mesh=mesh, shard="rows")


def test_engine_requires_policy():
    eng = ShardedScanEngine(lambda *a, **k: None, mesh=None, prefetch="serial", device="cpu")
    schedule = channels.StaticChannel(topology.ring(4, 1), np.full(4, 0.9))
    with pytest.raises(ValueError, match="policy"):
        eng.run_schedule(torch.Generator(), {}, None, schedule=schedule, rounds=4,
                         next_batch=lambda: {}, lr=0.1)


# -------------------------------------------------- prefetcher place hook


def test_prefetcher_place_hook_replaces_default_transfer():
    """``place`` substitutes the transfer: the staged chunks carry exactly
    its output (the sharded engine cuts each chunk to its rank's clients
    this way)."""
    n, rounds, chunk = 4, 6, 3
    schedule = channels.StaticChannel(topology.ring(n, 1), np.full(n, 0.9, np.float32))
    counter = iter(range(rounds))
    placed = []

    def place(host):
        placed.append(host)
        return {k: torch.from_numpy(v) + 100.0 for k, v in host.items()}

    pf = SegmentPrefetcher(
        schedule, rounds, chunk=chunk,
        next_batch=lambda: {"c": np.full((n, 1), float(next(counter)), np.float32)},
        place=place,
    )
    items = list(pf)
    assert len(items) == rounds // chunk == len(placed)
    got = np.concatenate([it.batches["c"].numpy()[: it.n_rounds] for it in items])
    assert np.array_equal(got[:, 0, 0], 100.0 + np.arange(rounds))


# ------------------------------------------- one rank, in this process


def test_sharded_step_on_one_rank_equals_the_fused_step():
    """k = 1: the gather is the identity and the ring rotates nothing; the
    gather step is bitwise the fused scan step, the ring within 1e-5."""
    out = torch_ranks.sharded_cases(0, "mlp", 4, 2, 2, 3, [("clients", "gather", "einsum"),
                                                            ("clients", "ring", "einsum")],
                                    deterministic_conv=False)
    _check_sharded(out, [("clients", "gather", "einsum"), ("clients", "ring", "einsum")])


def test_shard_scenario_without_ranks_fails_with_the_mesh_error():
    spec = dataclasses.replace(scenarios.get_scenario("mesh8_smoke"), rounds=4)
    with pytest.raises(RuntimeError, match="need 8 devices"):
        harness.run_scenario(spec, engines=("loop", "scan"), device="cpu")


# ------------------------------------------------------- gloo ranks


def _check_sharded(out, cases):
    for label in ("full", "churn"):
        ref_p, ref_l, ref_g = out[(None, None, "einsum", label)]
        for shard, exchange, backend in cases:
            got_p, got_l, got_g = out[(shard, exchange, backend, label)]
            assert np.array_equal(got_g, ref_g)  # the same τ stream
            if exchange == "gather" and shard == "clients":
                assert all(np.array_equal(a, b) for a, b in zip(got_p, ref_p)), (backend, label)
                assert np.array_equal(got_l, ref_l)
            else:
                for a, b in zip(got_p, ref_p):
                    np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)
                np.testing.assert_allclose(got_l, ref_l, atol=1e-5, rtol=1e-5)


SHARDED_CASES = [("clients", "gather", "einsum"), ("clients", "gather", "hopper_fused"),
                 ("clients", "ring", "einsum"), ("d", None, "einsum")]


@pytest.mark.parametrize("k", [2, 4])
def test_sharded_step_against_the_one_rank_step(k):
    ranks = run_ranks(torch_ranks.sharded_cases, k, num_threads=1, timeout=300,
                      args=("mlp", 8, 2, 4, 3, SHARDED_CASES, False))
    for out in ranks:
        _check_sharded(out, SHARDED_CASES)
    for key in ranks[0]:  # every rank holds the same result
        assert all(np.array_equal(a, b) for a, b in zip(ranks[0][key][0], ranks[-1][key][0]))


def test_resnet_gather_is_bitwise_with_deterministic_convolutions():
    cases = [("clients", "gather", "einsum")]
    ranks = run_ranks(torch_ranks.sharded_cases, 2, num_threads=1, timeout=300,
                      args=("resnet20", 4, 2, 2, 2, cases, True))
    _check_sharded(ranks[0], cases)


ENGINE_MODES = [("clients", "gather", "serial"), ("clients", "gather", "inline"),
                ("clients", "gather", "thread"), ("clients", "ring", "inline"),
                ("d", "gather", "serial")]


@pytest.mark.parametrize("k", [2, 4])
def test_engine_against_the_one_rank_walk(k):
    ranks = run_ranks(torch_ranks.engine_cases, k, num_threads=1, timeout=300,
                      args=(ENGINE_MODES,))
    for rank, out in enumerate(ranks):
        ref_p, _, ref_g, segments = out["reference"]
        assert segments >= 2
        for shard, exchange, prefetch in ENGINE_MODES:
            got_p, losses, got_g, dispatches, staged = out[(shard, exchange, prefetch)]
            assert dispatches == segments and losses.shape == (16,)
            assert np.array_equal(got_g, ref_g)
            if (shard, exchange) == ("clients", "gather"):
                assert all(np.array_equal(a, b) for a, b in zip(got_p, ref_p)), prefetch
            else:
                for a, b in zip(got_p, ref_p):
                    np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)
            # staging: clients mode keeps the rank's 8/k clients of dim 1
            width = 8 // k if shard == "clients" else 8
            assert staged["inputs"].shape[1] == width
            if shard == "clients":
                whole = out[("d", "gather", "serial")][4]["inputs"]
                assert np.array_equal(staged["inputs"], whole[:, rank * width:(rank + 1) * width])
        gathered = [out[m][0] for m in ENGINE_MODES[:3]]
        assert all(all(np.array_equal(a, b) for a, b in zip(gathered[0], g)) for g in gathered)


def test_mesh8_smoke_passes_its_shard_check_on_8_ranks():
    ranks = run_ranks(torch_ranks.harness_scenario, 8, num_threads=1, timeout=600,
                      args=("mesh8_smoke",))
    shard_check, kernel_check, bitwise, runs = ranks[0]
    assert shard_check["allclose"] and shard_check["bitwise_among_sharded"]
    assert shard_check["devices"] == 8 and shard_check["exchange"] == "gather"
    assert shard_check["max_abs_diff"] <= harness.KERNEL_CHECK_ATOL
    assert kernel_check["backend"] == "hopper_fused" and kernel_check["allclose"]
    assert bitwise is None  # the shard gate replaces the bitwise gate
    assert set(runs) == {"loop", "scan", "pipelined", "scan_hopper_fused"}
    spec = scenarios.get_scenario("mesh8_smoke")
    for name, (losses, dispatches, _) in runs.items():
        assert len(losses) == spec.rounds and np.all(np.isfinite(losses))
        assert dispatches == (spec.rounds if name == "loop" else spec.rounds // spec.adj_every)
    assert all(r[0] == shard_check for r in ranks)  # the same gate on every rank
