"""The beyond-paper correlated-shadowing sweep (``repro_torch.bench.figures
.fig_corr``) against the JAX package's ``benchmarks/fig_correlated.py`` on
the CPU.

The reference script's unchanged ``run(engine="loop")`` at a small size (the
MLP at full width, 400 training images, 6 rounds: three coherence intervals
of 2 rounds at each ℓ) against the port's ``fig_corr`` with the reference's
initial parameters and, for each ℓ, its τ stream handed over (the coupled
uplink moves p with the shadowing field, so every ℓ has its own stream).
At every ℓ every policy's per-round losses are within 1e-5 of the
reference's, with the same accuracy rounds and the same count of test
images right, and the ``sweep_mean`` row's two order checks equal the
reference's.  The channel equals the reference's state for state at every
ℓ.
"""
import contextlib
import functools
import io
import pathlib
import sys

import numpy as np
import pytest
import torch

from repro_torch.bench import figures
from test_torch_channel_figures import reference_init, reference_taus

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))  # the reference's benchmarks/ folder

from benchmarks import fig_correlated as ref  # noqa: E402

SMALL = dict(rounds=6, n_train=400, seed=0)
N = 10
TEST_IMAGES = 1000
POLICIES = list(figures.channel_policies())


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    # the suite runs several test processes side by side
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def printed(fn, **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = fn(**kw)
    return res, out.getvalue().splitlines()


@functools.cache
def _both():
    """((reference results, rows), (port results, rows)) of the sweep."""
    seed = SMALL["seed"]
    want = printed(ref.run, **SMALL, engine="loop")
    taus = {ell: reference_taus(ref.make_schedule(N, ell, seed=seed + 7), SMALL["rounds"], seed)
            for ell in ref.SWEEP}
    got = printed(figures.fig_corr, **SMALL, device="cpu", init_params=reference_init(seed),
                  taus=taus)
    return want, got


def images_right(accs):
    return [(r, round(a * TEST_IMAGES)) for r, a in accs]


def test_sweep_is_the_reference_sweep():
    assert figures.CORR_SWEEP == ref.SWEEP and figures.HOLD == ref.HOLD
    assert [figures.ell_label(e) for e in figures.CORR_SWEEP] == [
        ref.ell_label(e) for e in ref.SWEEP] == ["0", "0.2", "0.5", "inf"]


@pytest.mark.parametrize("ell", ref.SWEEP, ids=ref.ell_label)
@pytest.mark.parametrize("policy", POLICIES)
def test_corr_figure_matches_the_reference(ell, policy):
    (want, _), (got, _) = _both()
    assert list(got) == list(want)
    tag = f"{policy}@ell={ref.ell_label(ell)}"
    w, g = want[tag], got[tag]
    assert g.strategy == tag
    assert len(g.losses) == SMALL["rounds"] and np.isfinite(g.losses).all()
    np.testing.assert_allclose(g.losses, w.losses, atol=1e-5, rtol=0)
    # evaluated at each coherence interval's end; the count of the 1,000
    # test images right, not the f32 mean (XLA multiplies by 1/1000)
    assert [r for r, _ in g.accs] == [1, 3, 5]
    assert images_right(g.accs) == images_right(w.accs)


def test_sweep_mean_row_matches_the_reference():
    """Both order checks of the ``sweep_mean`` row equal the reference's, its
    accuracies equal and its mean final losses to one unit of the 4th
    decimal; every CSV row's name is the reference's."""
    (_, ref_rows), (_, rows) = _both()
    assert [r.split(",")[0] for r in rows] == [r.split(",")[0] for r in ref_rows]
    assert len(rows) == len(ref.SWEEP) * len(POLICIES) + 1

    def fields(row):
        name, _us, rest = row.split(",")
        assert name == "fig_corr/sweep_mean"
        return dict(kv.split("=") for kv in rest.split(";"))

    got, want = fields(rows[-1]), fields(ref_rows[-1])
    assert list(got) == list(want)
    for key in ("adaptive_ge_stale_ge_fedavg_acc", "adaptive_le_stale_le_fedavg_loss"):
        assert got[key] == want[key]
        assert got[key] in ("True", "False")
    for key in got:
        if key.startswith("acc_"):
            assert got[key] == want[key]
        elif key.startswith("loss_"):
            assert abs(float(got[key]) - float(want[key])) <= 1e-4 + 1e-9


def test_sweep_mean_line_orders():
    """The row's checks on hand-made results: accuracy ties within 1e-3 keep
    the order, loss must be ordered with adaptive ≤ stale ≤ FedAvg."""

    def res(accs, final_loss):
        return figures.FigureResult("", [1.0, final_loss], [(1, a) for a in accs], 0.0)

    def row(acc, loss):
        results = {f"{name}@ell=0": res(acc[name], loss[name]) for name in POLICIES}
        return figures.sweep_mean_line(results).split(";")[-2:]

    acc = {"colrel_adaptive": [0.9], "colrel_stale": [0.9005], "fedavg_dropout_blind": [0.9]}
    assert row(acc, {"colrel_adaptive": 0.1, "colrel_stale": 0.2, "fedavg_dropout_blind": 0.3}) == [
        "adaptive_ge_stale_ge_fedavg_acc=True", "adaptive_le_stale_le_fedavg_loss=True"]
    acc["colrel_stale"] = [0.902]
    assert row(acc, {"colrel_adaptive": 0.2, "colrel_stale": 0.1, "fedavg_dropout_blind": 0.3}) == [
        "adaptive_ge_stale_ge_fedavg_acc=False", "adaptive_le_stale_le_fedavg_loss=False"]


@pytest.mark.parametrize("ell", ref.SWEEP, ids=ref.ell_label)
def test_corr_schedule_equals_the_reference_state_for_state(ell):
    rounds = 24
    want = list(ref.make_schedule(N, ell, seed=7).rounds(rounds))
    got = list(figures.corr_schedule(N, ell, seed=7).rounds(rounds))
    assert len(got) == len(want) == rounds
    for g, w in zip(got, want):
        assert (g.round, g.epoch_id, g.active) == (w.round, w.epoch_id, None)
        np.testing.assert_array_equal(g.adj, w.adj)
        np.testing.assert_array_equal(g.p, w.p)
    # the shadowing moves the uplink: p is not the base profile every round
    assert any(not np.array_equal(g.p, got[0].p) for g in got)
