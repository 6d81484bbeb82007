"""The port's channel layer (``repro_torch.channels``) against the JAX
package's ``repro.channels``: equal, not close.

For the same seeds every process family emits the same ``ChannelState``
stream (round, epoch_id, adj, p, active) and ``segments()`` cuts it the same
way; the relay policies give the same A, array for array, with the same
stats; ``SegmentPrefetcher`` yields the same items in the same order, inline
and threaded, with and without padding.  Oracles: ``tests/test_channels.py``,
``tests/test_churn.py``, ``tests/test_correlated.py``,
``tests/test_pipelined_engine.py``.
"""
import sys
import threading

import numpy as np
import pytest
import torch

from repro import channels as jax_channels
from repro.core import topology as jax_topology
from repro_torch import channels
from repro_torch.core import topology
from repro_torch.obs import Tracer

PKGS = {"torch": (channels, topology), "jax": (jax_channels, jax_topology)}
N = 8
P8 = np.linspace(0.25, 0.9, N)
ROUNDS = 40


def _corr_churn(ch, top):
    field = ch.ShadowingField(ch.circle_positions(N), corr_length=0.5, rho=0.8, seed=10)
    return ch.ChurnSchedule(
        membership=ch.RotatingCohorts(N, n_cohorts=4, hold=3),
        link_process=ch.ShadowedLinkProcess(top.ring(N, 2), field, threshold=0.8),
        p_process=ch.CoupledUplinkDrift(P8, field, gain=1.5),
        adj_every=2, p_every=3)


# one schedule per process family, built from either package's modules
FAMILIES = {
    "static": lambda ch, top: ch.StaticChannel(top.ring(N, 1), P8),
    "markov": lambda ch, top: ch.TimeVaryingChannel(
        link_process=ch.MarkovLinkProcess(top.ring(N, 2), p_up_to_down=0.3,
                                          p_down_to_up=0.5, seed=1), p=P8),
    "gilbert_elliott": lambda ch, top: ch.TimeVaryingChannel(
        link_process=ch.gilbert_elliott(top.ring(N, 2), stay_up=0.8, stay_down=0.6,
                                        init="up", seed=2), p=P8, adj_every=2),
    "mobility": lambda ch, top: ch.TimeVaryingChannel(
        link_process=ch.RandomWaypointMobility(N, radius=0.4, speed=0.1, seed=3), p=P8),
    "piecewise_drift": lambda ch, top: ch.TimeVaryingChannel(
        adj=top.ring(N, 1), p_process=ch.PiecewiseConstantDrift(P8, hold=2, seed=4)),
    "random_walk_drift": lambda ch, top: ch.TimeVaryingChannel(
        adj=top.ring(N, 1), p_process=ch.RandomWalkDrift(P8, sigma=0.05, seed=5),
        p_every=2),
    "markov_churn": lambda ch, top: ch.ChurnSchedule(
        membership=ch.MarkovChurn(N, p_leave=0.2, p_join=0.4, min_active=2, seed=6),
        link_process=ch.MarkovLinkProcess(top.ring(N, 2), p_up_to_down=0.3,
                                          p_down_to_up=0.5, seed=7),
        p_process=ch.PiecewiseConstantDrift(P8, hold=1, low=0.1, high=0.9, seed=8),
        adj_every=3, p_every=4),
    "rotating_churn": lambda ch, top: ch.ChurnSchedule(
        membership=ch.RotatingCohorts(N, n_cohorts=4, hold=3), adj=top.ring(N, 1), p=P8,
        active_every=2),
    "static_membership": lambda ch, top: ch.ChurnSchedule(
        membership=ch.StaticMembership([1, 1, 0, 1, 1, 1, 0, 1]), adj=top.ring(N, 2),
        p_process=ch.PiecewiseConstantDrift(P8, hold=3, seed=9)),
    "correlated": lambda ch, top: ch.CorrelatedChannel(
        top.ring(N, 2), P8, corr_length=0.3, couple_uplink=False, hold=2, seed=11),
    "correlated_uplink": lambda ch, top: ch.CorrelatedChannel(
        top.ring(N, 2), P8, corr_length=0.3, hold=2, seed=12),
    "correlated_mobility": lambda ch, top: ch.CorrelatedChannel(
        None, P8, corr_length=0.4, rho=0.7,
        mobility=ch.RandomWaypointMobility(N, radius=0.5, speed=0.05, seed=13), seed=14),
    "correlated_churn": _corr_churn,
}


def _schedule(family, pkg):
    return FAMILIES[family](*PKGS[pkg])


def _assert_states_equal(got, want):
    assert got.round == want.round and got.epoch_id == want.epoch_id
    assert got.adj.dtype == want.adj.dtype and np.array_equal(got.adj, want.adj)
    assert got.p.dtype == want.p.dtype and np.array_equal(got.p, want.p)
    assert (got.active is None) == (want.active is None)
    if got.active is not None:
        assert np.array_equal(got.active, want.active)
    assert got.key() == want.key()


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_state_stream_equals_jax(family):
    got = list(_schedule(family, "torch").rounds(ROUNDS))
    want = list(_schedule(family, "jax").rounds(ROUNDS))
    for g, w in zip(got, want, strict=True):
        _assert_states_equal(g, w)
    if family != "static" and family != "static_membership":
        assert want[-1].epoch_id > 1  # the family really varies


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_segments_partition_the_stream_as_jax(family):
    got = list(_schedule(family, "torch").segments(ROUNDS))
    want = list(_schedule(family, "jax").segments(ROUNDS))
    assert [(s.epoch_id, s.start_round, s.n_rounds) for s in got] == [
        (s.epoch_id, s.start_round, s.n_rounds) for s in want]
    for gs, ws in zip(got, want):
        for g, w in zip(gs.states, ws.states, strict=True):
            _assert_states_equal(g, w)
    # and they regroup the round stream exactly
    flat = [s for seg in got for s in seg.states]
    for g, w in zip(flat, _schedule(family, "torch").rounds(ROUNDS), strict=True):
        _assert_states_equal(g, w)


def test_geometry_helpers_equal_jax():
    pos = np.random.default_rng(0).random((N, 2))
    assert np.array_equal(channels.geometric_adjacency(pos, 0.35),
                          jax_channels.geometric_adjacency(pos, 0.35))
    assert np.array_equal(channels.circle_positions(N), jax_channels.circle_positions(N))
    assert np.array_equal(channels.spatial_covariance(pos, corr_length=0.2, sigma=1.5),
                          jax_channels.spatial_covariance(pos, corr_length=0.2, sigma=1.5))


def test_unchanged_adjacency_is_one_read_only_snapshot():
    sched = channels.StaticChannel(topology.ring(N, 1), P8)
    s0, s1, s2 = sched.rounds(3)
    assert s1.adj is s0.adj and s2.adj is s0.adj and not s0.adj.flags.writeable
    assert s0.key()[0] is s2.key()[0]  # the bytes are reused, not rebuilt
    assert s0.epoch_id == s2.epoch_id == 0


def test_segments_mark_epoch_boundaries_on_the_tracer():
    sched = _schedule("markov_churn", "torch")
    sched.tracer = Tracer()
    segs = list(sched.segments(ROUNDS))
    marks = [i for i in sched.tracer.instants if i.name == "segment"]
    assert [(m.attrs["epoch"], m.attrs["start_round"], m.attrs["n_rounds"]) for m in marks] == [
        (s.epoch_id, s.start_round, s.n_rounds) for s in segs]


def test_schedule_rejects_bad_channels():
    with pytest.raises(ValueError, match="exactly one of link_process / adj"):
        channels.TimeVaryingChannel(p=P8)
    with pytest.raises(ValueError, match="exactly one of p_process / p"):
        channels.TimeVaryingChannel(adj=topology.ring(N, 1))
    with pytest.raises(ValueError, match="adj_every"):
        channels.TimeVaryingChannel(adj=topology.ring(N, 1), p=P8, p_every=0)
    with pytest.raises(ValueError, match="p left"):
        next(channels.StaticChannel(topology.ring(N, 1), P8 + 0.5).rounds(1))
    with pytest.raises(ValueError, match="channel size mismatch"):
        next(channels.StaticChannel(topology.ring(N, 1), P8[:-1]).rounds(1))


# ----------------------------------------------------------------- policies


POLICIES = {
    "adaptive": dict(sweeps=20, warm_sweeps=8),
    "adaptive_lru2": dict(sweeps=20, warm_sweeps=8, cache_size=2),
    "adaptive_cold": dict(sweeps=20, warm_start=False),
    "adaptive_exact": dict(sweeps=20, warm_sweeps=8, method="exact"),
}


@pytest.mark.parametrize("family", ["markov_churn", "correlated_churn", "markov"])
@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_adaptive_opt_alpha_equals_jax(policy, family):
    got_pol = channels.AdaptiveOptAlpha(**POLICIES[policy])
    want_pol = jax_channels.AdaptiveOptAlpha(**POLICIES[policy])
    states = zip(_schedule(family, "torch").rounds(ROUNDS),
                 _schedule(family, "jax").rounds(ROUNDS), strict=True)
    for g, w in states:
        A, A_ref = got_pol.relay_matrix(g), want_pol.relay_matrix(w)
        assert A.dtype == A_ref.dtype and np.array_equal(A, A_ref)
        assert not A.flags.writeable
    assert got_pol.stats.__dict__ == want_pol.stats.__dict__
    assert got_pol.stats.solves > 3
    if family != "markov":  # the link state changes every round there
        assert got_pol.stats.cache_hits > 0
    if policy == "adaptive_lru2":
        assert got_pol.stats.evictions > 0


@pytest.mark.parametrize("family", ["markov_churn", "correlated_churn"])
def test_stale_opt_alpha_equals_jax(family):
    got_pol = channels.StaleOptAlpha(sweeps=20)
    want_pol = jax_channels.StaleOptAlpha(sweeps=20)
    for g, w in zip(_schedule(family, "torch").rounds(ROUNDS),
                    _schedule(family, "jax").rounds(ROUNDS), strict=True):
        A = got_pol.relay_matrix(g)
        assert np.array_equal(A, want_pol.relay_matrix(w))
        if g.active is not None:  # a departed slot carries nothing
            assert not A[~g.active].any() and not A[:, ~g.active].any()


def test_adaptive_policy_counts_on_the_tracer():
    tracer = Tracer()
    pol = channels.AdaptiveOptAlpha(sweeps=20, warm_sweeps=8, tracer=tracer)
    for state in _schedule("markov_churn", "torch").rounds(ROUNDS):
        pol.relay_matrix(state)
    st = pol.stats
    assert st.rounds == st.cache_hits + st.cache_misses and st.cache_misses == st.solves
    assert tracer.counters["opt_alpha.solves"] == st.solves
    assert tracer.counters["opt_alpha.cache_hits"] == st.cache_hits
    assert tracer.counters["opt_alpha.sweeps"] == st.sweeps_total
    assert len([s for s in tracer.spans if s.cat == "solve"]) == st.solves


# --------------------------------------------------------------- prefetcher


def _items(pkg, threaded, pad):
    ch = PKGS[pkg][0]
    rng = np.random.default_rng(5)

    def next_batch():
        return {"c": rng.standard_normal((N, 2, 3)).astype(np.float32),
                "y": rng.integers(0, 10, (N, 2)).astype(np.int32)}

    kw = dict(device="cpu") if pkg == "torch" else {}
    pre = ch.SegmentPrefetcher(_schedule("markov_churn", pkg), 23, chunk=4,
                               next_batch=next_batch, policy=ch.AdaptiveOptAlpha(sweeps=20),
                               pad_to_chunk=pad, threaded=threaded, **kw)
    items = list(pre)
    return items, pre.stats


@pytest.mark.parametrize("pad", [False, True], ids=["unpadded", "padded"])
@pytest.mark.parametrize("threaded", [False, True], ids=["inline", "thread"])
def test_prefetcher_items_equal_jax(threaded, pad):
    got, got_stats = _items("torch", threaded, pad)
    want, want_stats = _items("jax", threaded, pad)
    assert len(got) == len(want) > 6
    for g, w in zip(got, want):
        assert (g.segment.epoch_id, g.segment.start_round, g.segment.n_rounds) == (
            w.segment.epoch_id, w.segment.start_round, w.segment.n_rounds)
        assert (g.start, g.n_rounds, g.last_in_segment) == (w.start, w.n_rounds,
                                                            w.last_in_segment)
        assert np.array_equal(g.A, w.A)
        for name in ("c", "y"):
            assert isinstance(g.batches[name], torch.Tensor)
            assert g.batches[name].device.type == "cpu"
            assert np.array_equal(g.batches[name].numpy(), np.asarray(w.batches[name]))
            assert g.batches[name].shape[0] == (4 if pad else g.n_rounds)
    for field in ("chunks", "chunks_staged", "segments"):
        assert getattr(got_stats, field) == getattr(want_stats, field)
    assert 0.0 <= got_stats.overlap_fraction <= 1.0


class _Pending:
    """An in-flight marker whose work never completes (an event's query())."""

    def query(self):
        return False


def test_prefetcher_bills_staging_behind_an_inflight_chunk_as_hidden():
    rng = np.random.default_rng(0)
    pre = channels.SegmentPrefetcher(
        _schedule("markov", "torch"), 12, chunk=2,
        next_batch=lambda: {"c": rng.standard_normal((N, 2)).astype(np.float32)},
        device="cpu")
    for _ in pre:
        pre.note_inflight(_Pending())
    st = pre.stats
    # only the first chunk, staged before anything was in flight, waits
    assert st.wait_s == pytest.approx(st.first_wait_s) and st.first_wait_s > 0
    assert st.steady_overlap_fraction == 1.0 and st.chunks == st.chunks_staged > 1


def test_threaded_prefetcher_relays_worker_errors_and_restores_switch_interval():
    before = sys.getswitchinterval()
    calls = {"n": 0}

    def next_batch():
        calls["n"] += 1
        if calls["n"] == 5:
            raise RuntimeError("staging failed")
        return {"c": np.zeros((N, 2), np.float32)}

    pre = channels.SegmentPrefetcher(_schedule("markov", "torch"), 12, chunk=2,
                                     next_batch=next_batch, threaded=True, device="cpu")
    assert sys.getswitchinterval() <= 1e-3
    with pytest.raises(RuntimeError, match="staging failed"):
        for _ in pre:
            pass
    assert sys.getswitchinterval() == before
    assert not any(t.daemon and t.is_alive() and t.name.startswith("Thread")
                   for t in threading.enumerate() if t is not threading.current_thread())


def test_prefetcher_without_a_device_means_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        channels.SegmentPrefetcher(_schedule("static", "torch"), 4, chunk=2,
                                   next_batch=lambda: {})
