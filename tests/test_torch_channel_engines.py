"""The channel figures 5 and 6 through the port's three engines on the CPU.

``run_channel_figure`` with ``engine="scan"`` and ``"pipelined"`` (inline
and threaded prefetch) against the per-round loop on the port's own τ
stream, at the parity tests' size (the MLP at full width, 400 training
images, 6 rounds): every policy's per-round losses and final parameters are
bitwise equal to the loop's, as the reference's engines are to its loop;
accuracy is evaluated at each channel epoch's end; the engines ask the
adaptive policy once a segment, so they share its stats.
"""
import functools

import pytest
import torch

from repro_torch.bench import figures

SMALL = dict(rounds=6, n_train=400, seed=0)
N = 10
POLICIES = list(figures.channel_policies())
SCHEDULES = {"fig5": figures.fig5_schedule, "fig6": figures.fig6_schedule}
RUNS = {"scan": dict(engine="scan"),
        "pipelined_inline": dict(engine="pipelined", prefetch="inline"),
        "pipelined_thread": dict(engine="pipelined", prefetch="thread")}


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    # the suite runs several test processes side by side
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@functools.cache
def _run(figure, run):
    kw = {"engine": "loop"} if run == "loop" else RUNS[run]
    return figures.run_channel_figure(
        lambda: SCHEDULES[figure](N, seed=SMALL["seed"] + 7), **SMALL, device="cpu",
        eval_round=lambda r: r % 2 == 0 or r == SMALL["rounds"] - 1, **kw)


def _leaves(params):
    return [params[k] for k in sorted(params)]


@pytest.mark.parametrize("run", list(RUNS))
@pytest.mark.parametrize("figure", list(SCHEDULES))
def test_engines_are_bitwise_the_loop(figure, run):
    loop, got = _run(figure, "loop"), _run(figure, run)
    segments = list(SCHEDULES[figure](N, seed=7).segments(SMALL["rounds"]))
    ends = [s.start_round + s.n_rounds - 1 for s in segments]
    for policy in POLICIES:
        g, w = got[policy], loop[policy]
        assert g.losses == w.losses, policy
        assert all(torch.equal(a, b) for a, b in zip(_leaves(g.params), _leaves(w.params)))
        assert [r for r, _ in g.accs] == ends
        # an accuracy at a round the loop also evaluated is the loop's
        evaluated = dict(w.accs)
        assert all(a == evaluated[r] for r, a in g.accs if r in evaluated)
        assert len(g.round_ms) == SMALL["rounds"]
        assert 0 <= g.engine_counts["trace_count"] <= 2
    stats = got["colrel_adaptive"].policy.stats
    assert stats.rounds == len(segments)
    assert stats == _run(figure, "scan")["colrel_adaptive"].policy.stats
    assert loop["colrel_adaptive"].policy.stats.solves == stats.solves
    if run.startswith("pipelined"):
        assert got["colrel_adaptive"].engine_counts["dispatches"] == sum(
            -(-s.n_rounds // figures.HOLD) for s in segments)
