"""The paper's Figs. 2–4 protocol (``repro_torch.bench.figures``) against the
JAX package's ``benchmarks/common.py::run_figure`` on the CPU.

At a small size (the MLP, 400 training images, 3 rounds) and with the
reference's initial parameters (``init(jax.random.key(seed))``) and τ stream
handed over as arrays, every strategy of every figure gives per-round losses
within 1e-5 of the reference's and the same accuracies; the host data is the
same numpy on both sides.  Then the claim the MLP can gate (the reference's
own CPU runs at the MLP saturate Figs. 2 and 3): in Fig. 4, ColRel reaches
90% accuracy in fewer rounds than both FedAvg-dropout runs, with the port's
own τ, over seeds 0–2.  And the paper's model on the same path: one round of
Fig. 4 at ResNet-20/GN (100 training images, one local step of 4), every
strategy within 1e-5 in loss of the reference's and the same accuracy.
"""
import functools
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.bench import figures

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))  # the reference's benchmarks/ folder

from benchmarks import common as ref  # noqa: E402
from repro.fl.simulator import FLSimulator as JaxSimulator  # noqa: E402

SMALL = dict(model="mlp", rounds=3, n_train=400, seed=0)
# the paper's model through one round of Fig. 4: 10 images a client, one
# local step of 4 (the suite's time)
SMALL_RESNET = dict(model="resnet20", rounds=1, n_train=100, local_steps=1, local_batch=4,
                    seed=0)
CLAIM_ROUNDS = 10
TEST_IMAGES = 1000  # run_figure's held-out set


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    # the suite runs several test processes side by side
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _reference_taus(p, rounds, seed):
    """The reference's τ stream in ``run_figure``: one split of
    ``key(seed + 1)`` a round, drawn by its ``FLSimulator.sample_tau``."""
    sim = JaxSimulator(lambda params, batch: 0.0, n_clients=len(p), strategy="fedavg_blind",
                       p=p)
    key, taus = jax.random.key(seed + 1), []
    for _ in range(rounds):
        key, sub = jax.random.split(key)
        taus.append(np.asarray(sim.sample_tau(sub)))
    return np.stack(taus)


@functools.cache
def _both(figure):
    """(reference results, port results) of one figure at the small size."""
    setting = figures.figure_setting(figure)
    init, _, _ = ref.make_mlp()
    params = jax.tree.map(np.asarray, init(jax.random.key(SMALL["seed"])))
    want = ref.run_figure(**setting, **SMALL)
    got = figures.run_figure(
        **setting, **SMALL, device="cpu", init_params=params,
        taus=_reference_taus(setting["p"], SMALL["rounds"], SMALL["seed"]))
    return want, got


@functools.cache
def _both_resnet20():
    """(reference results, port results) of Fig. 4 at ResNet-20/GN, the
    reference's ``init(key(seed))`` and τ handed over."""
    from repro.configs import registry as creg
    from repro.models import registry as mreg

    setting = figures.figure_setting("fig4")
    init = mreg.get_model(creg.get_config("resnet20-cifar")).init
    params = jax.tree.map(np.asarray, init(jax.random.key(SMALL_RESNET["seed"])))
    want = ref.run_figure(**setting, **SMALL_RESNET)
    got = figures.run_figure(
        **setting, **SMALL_RESNET, device="cpu", init_params=params,
        taus=_reference_taus(setting["p"], SMALL_RESNET["rounds"], SMALL_RESNET["seed"]))
    return want, got


CASES = [(fig, name) for fig in figures.FIGURES
         for name in figures.figure_setting(fig)["strategies"]]


@pytest.mark.parametrize("figure,strategy", CASES)
def test_run_figure_matches_the_reference(figure, strategy):
    want, got = _both(figure)
    assert list(got) == list(want)
    w, g = want[strategy], got[strategy]
    assert len(g.losses) == SMALL["rounds"] and np.isfinite(g.losses).all()
    np.testing.assert_allclose(g.losses, w.losses, atol=1e-5, rtol=0)
    # equal accuracies: the same rounds and the same count of the 1,000 test
    # images right (the f32 means differ in the last bit: XLA multiplies the
    # count by 1/1000, torch divides)
    assert [r for r, _ in g.accs] == [r for r, _ in w.accs]
    assert [round(a * TEST_IMAGES) for _, a in g.accs] == [
        round(a * TEST_IMAGES) for _, a in w.accs]
    assert figures.rounds_to(g, 0.9) == ref.rounds_to(w, 0.9)


@pytest.mark.parametrize("strategy", list(figures.figure_setting("fig4")["strategies"]))
def test_run_figure_resnet20_matches_the_reference(strategy):
    """The paper's model on the figure path: Fig. 4's round (non-IID data,
    server momentum 0.9) gives the reference's loss within 1e-5 and, after
    the aggregation, the same count of test images right."""
    want, got = _both_resnet20()
    w, g = want[strategy], got[strategy]
    np.testing.assert_allclose(g.losses, w.losses, atol=1e-5, rtol=0)
    assert [r for r, _ in g.accs] == [r for r, _ in w.accs] == [0]
    assert [round(a * TEST_IMAGES) for _, a in g.accs] == [
        round(a * TEST_IMAGES) for _, a in w.accs]


@pytest.mark.parametrize("figure", figures.FIGURES)
def test_figure_csv_matches_the_reference(figure, capsys):
    """The derived CSV column as the reference prints it: early accuracy,
    rounds to 90% and final accuracy equal, the final loss (printed to 4
    decimals) one unit of its last digit apart at most; the µs column is
    each run's own."""
    want, got = _both(figure)
    ref.print_figure_csv(figure, want)
    ref_rows = capsys.readouterr().out.splitlines()
    figures.print_figure_csv(figure, got)
    rows = capsys.readouterr().out.splitlines()
    assert len(rows) == len(ref_rows) == len(want)

    def derived(row):
        name, _us, rest = row.split(",")
        return name, dict(kv.split("=") for kv in rest.split(";"))

    for row, ref_row in zip(rows, ref_rows):
        (name, fields), (ref_name, ref_fields) = derived(row), derived(ref_row)
        assert name == ref_name
        loss, ref_loss = float(fields.pop("final_loss")), float(ref_fields.pop("final_loss"))
        assert fields == ref_fields
        assert abs(loss - ref_loss) <= 1e-4 + 1e-9


def test_settings_are_the_reference_scripts():
    """Each figure's p, graph and strategies as its script builds them."""
    from benchmarks import fig2_homogeneous, fig3_ring, fig4_noniid  # noqa: F401
    from repro.core import connectivity, opt_alpha, topology

    s2 = figures.figure_setting("fig2")
    np.testing.assert_array_equal(s2["p"], np.full(10, 0.2))
    np.testing.assert_array_equal(s2["adj"], topology.fully_connected(10))
    np.testing.assert_array_equal(s2["strategies"]["colrel"][1],
                                  opt_alpha.optimize(np.full(10, 0.2), s2["adj"], sweeps=40).A)
    p = connectivity.paper_heterogeneous().p
    s3, s4 = figures.figure_setting("fig3"), figures.figure_setting("fig4")
    np.testing.assert_array_equal(s3["adj"], topology.ring(10, k=1))
    np.testing.assert_array_equal(s3["strategies"]["colrel_unoptimized"][1],
                                  opt_alpha.initial_weights(p, s3["adj"]))
    np.testing.assert_array_equal(s3["strategies"]["colrel_optimized"][1],
                                  opt_alpha.optimize(p, s3["adj"], sweeps=60).A)
    np.testing.assert_array_equal(s4["adj"], topology.ring(10, k=2))
    np.testing.assert_array_equal(s4["strategies"]["colrel_optimized"][1],
                                  opt_alpha.optimize(p, s4["adj"], sweeps=60).A)
    assert s4["non_iid"] and s4["server_momentum"] == 0.9
    assert "non_iid" not in s3 and "non_iid" not in s2
    assert [v[0] for v in s3["strategies"].values()] == [
        "no_dropout", "fedavg_blind", "fedavg_nonblind", "colrel_fused", "colrel_fused"]


def test_cli_prints_the_reference_rows(capsys):
    figures.main(["--figure", "fig3", "--model", "mlp", "--rounds", "1", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("# fig3 S(p,A): init=47.694 optimized=")
    assert [r.split(",")[0] for r in out[1:]] == [
        f"fig3/{name}" for name in figures.figure_setting("fig3")["strategies"]]


def test_cli_seed_is_run_figures_seed(capsys):
    figures.main(["--figure", "fig2", "--model", "mlp", "--rounds", "1", "--device", "cpu",
                  "--seed", "1"])
    rows = capsys.readouterr().out.splitlines()
    figures.fig2(rounds=1, model="mlp", device="cpu", seed=1)
    want = capsys.readouterr().out.splitlines()

    def without_us(lines):
        return [(r.split(",")[0], r.split(",")[2]) for r in lines]

    assert without_us(rows) == without_us(want)
    figures.fig2(rounds=1, model="mlp", device="cpu", seed=0)
    assert without_us(capsys.readouterr().out.splitlines()) != without_us(rows)


def test_run_figure_runs_repeatable_f32_on_the_gpu_only():
    """Every caller of ``run_figure`` trains in full f32 (the reference's
    HIGHEST) with deterministic cuDNN on the GPU; the caller's settings come
    back after."""
    b = torch.backends

    def flags():
        return (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32, b.cudnn.deterministic,
                b.cudnn.benchmark)

    saved = flags()
    try:
        (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32, b.cudnn.deterministic,
         b.cudnn.benchmark) = caller = (True, True, False, True)
        with figures._repeatable_f32(torch.device("cuda")):
            assert flags() == (False, False, True, False)
        assert flags() == caller
        with figures._repeatable_f32(torch.device("cpu")):
            assert flags() == caller
    finally:
        (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32, b.cudnn.deterministic,
         b.cudnn.benchmark) = saved


def test_run_figure_refuses_a_wrong_tau_shape():
    with pytest.raises(ValueError, match="taus shape"):
        figures.run_figure(**figures.figure_setting("fig2"), model="mlp", rounds=2,
                           n_train=40, device="cpu", taus=np.ones((3, 10)))


@pytest.mark.slow
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fig4_colrel_reaches_90pct_before_fedavg_dropout(seed):
    """Fig. 4 at the MLP with the port's own draws: ColRel reaches 90%
    accuracy, and in fewer rounds than blind and non-blind FedAvg-dropout
    (a run that never reaches it within the rounds counts as later)."""
    setting = figures.figure_setting("fig4")
    keep = ("fedavg_dropout_blind", "fedavg_dropout_nonblind", "colrel_optimized")
    setting["strategies"] = {k: setting["strategies"][k] for k in keep}
    res = figures.run_figure(**setting, model="mlp", rounds=CLAIM_ROUNDS, seed=seed,
                             device="cpu")
    r90 = {k: figures.rounds_to(v, 0.9) for k, v in res.items()}
    assert r90["colrel_optimized"] is not None, r90
    for k in keep[:2]:
        assert r90[k] is None or r90["colrel_optimized"] < r90[k], r90
