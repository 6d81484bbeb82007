"""The beyond-paper channel figures 5 and 6 (``repro_torch.bench.figures``)
against the JAX package's ``benchmarks/fig5_timevarying.py`` and
``benchmarks/fig6_churn.py`` on the CPU.

Each reference script's unchanged ``run(engine="loop")`` at a small size (the
MLP at full width, 400 training images, 6 rounds: three ``adj_every=2``
link epochs, a cohort shift at round 4 and a p change at round 5) against
the port's ``fig5``/``fig6`` with the reference's initial parameters and τ
stream handed over.  τ follows the round's drifting p, so the test rebuilds
the reference's per-round p from the schedule (host numpy, equal across the
packages) and draws the reference's τ along its ``key(seed + 1)`` split
chain.  Every policy's per-round losses are within 1e-5 of the reference's,
with the same accuracy rounds and the same count of test images right; the
OPT-α scheduler rows are equal as strings.  Also: the schedules equal the
reference's state for state, the model-only switch, the CLI's rows and
``--figure all``'s order against ``benchmarks/run.py``.
"""
import ast
import contextlib
import functools
import io
import pathlib
import sys

import jax
import numpy as np
import pytest
import torch

from repro_torch.bench import figures

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))  # the reference's benchmarks/ folder

from benchmarks import common as ref  # noqa: E402
from benchmarks import fig5_timevarying, fig6_churn  # noqa: E402
from repro.fl.simulator import FLSimulator as JaxSimulator  # noqa: E402

SMALL = dict(rounds=6, n_train=400, seed=0)
N = 10
TEST_IMAGES = 1000  # the figures' held-out set
REF = {"fig5": fig5_timevarying, "fig6": fig6_churn}
PORT_SCHEDULE = {"fig5": figures.fig5_schedule, "fig6": figures.fig6_schedule}
POLICIES = list(figures.channel_policies())


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    # the suite runs several test processes side by side
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def reference_taus(schedule, rounds: int, seed: int) -> np.ndarray:
    """The reference loop's τ stream over ``schedule``: one split of
    ``key(seed + 1)`` a round, drawn by its ``FLSimulator.sample_tau`` with
    the round's p."""
    sim = JaxSimulator(lambda params, batch: 0.0, n_clients=N, strategy="fedavg_blind",
                       p=None)
    key, taus = jax.random.key(seed + 1), []
    for state in schedule.rounds(rounds):
        key, sub = jax.random.split(key)
        taus.append(np.asarray(sim.sample_tau(sub, state.p)))
    return np.stack(taus)


def reference_init(seed: int):
    init, _, _ = ref.make_mlp()
    return jax.tree.map(np.asarray, init(jax.random.key(seed)))


def printed(fn, *args, **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = fn(*args, **kw)
    return res, out.getvalue().splitlines()


@functools.cache
def _both(figure):
    """((reference results, rows), (port results, rows)) of one figure."""
    seed = SMALL["seed"]
    want = printed(REF[figure].run, **SMALL, engine="loop")
    taus = reference_taus(REF[figure].make_schedule(N, seed=seed + 7), SMALL["rounds"], seed)
    got = printed(getattr(figures, figure), **SMALL, device="cpu",
                  init_params=reference_init(seed), taus=taus)
    return want, got


def images_right(accs):
    return [(r, round(a * TEST_IMAGES)) for r, a in accs]


@pytest.mark.parametrize("figure", ["fig5", "fig6"])
@pytest.mark.parametrize("policy", POLICIES)
def test_channel_figure_matches_the_reference(figure, policy):
    (want, _), (got, _) = _both(figure)
    assert list(got) == list(want) == POLICIES
    w, g = want[policy], got[policy]
    assert len(g.losses) == SMALL["rounds"] and np.isfinite(g.losses).all()
    np.testing.assert_allclose(g.losses, w.losses, atol=1e-5, rtol=0)
    # the same rounds evaluated and the same count of the 1,000 test images
    # right (the f32 means differ in the last bit: XLA multiplies the count
    # by 1/1000, torch divides)
    assert [r for r, _ in g.accs] == [0, 2, 4, 5]
    assert images_right(g.accs) == images_right(w.accs)


@pytest.mark.parametrize("figure", ["fig5", "fig6"])
def test_channel_figure_rows_match_the_reference(figure):
    """The CSV rows' names and accuracy fields, the final loss to one unit
    of its 4th decimal, and the OPT-α scheduler row equal as a string."""
    (_, ref_rows), (_, rows) = _both(figure)
    assert len(rows) == len(ref_rows) == len(POLICIES) + 1
    assert rows[-1].startswith(f"{figure}/opt_alpha_scheduler,0,rounds=6;")
    assert rows[-1] == ref_rows[-1]

    def derived(row):
        name, _us, rest = row.split(",")
        return name, dict(kv.split("=") for kv in rest.split(";"))

    for row, ref_row in zip(rows[:-1], ref_rows[:-1]):
        (name, fields), (ref_name, ref_fields) = derived(row), derived(ref_row)
        assert name == ref_name
        loss, ref_loss = float(fields.pop("final_loss")), float(ref_fields.pop("final_loss"))
        assert fields == ref_fields
        assert abs(loss - ref_loss) <= 1e-4 + 1e-9


@pytest.mark.parametrize("figure", ["fig5", "fig6"])
def test_schedule_equals_the_reference_state_for_state(figure):
    """Adjacency, p, the churn mask and the epoch id of every round, and the
    segments' bounds, equal to the reference script's ``make_schedule``."""
    rounds = 40
    want = list(REF[figure].make_schedule(N, seed=7).rounds(rounds))
    got = list(PORT_SCHEDULE[figure](N, seed=7).rounds(rounds))
    assert len(got) == len(want) == rounds
    for g, w in zip(got, want):
        assert (g.round, g.epoch_id) == (w.round, w.epoch_id)
        np.testing.assert_array_equal(g.adj, w.adj)
        np.testing.assert_array_equal(g.p, w.p)
        if w.active is None:
            assert g.active is None
        else:
            np.testing.assert_array_equal(g.active, w.active)
    bounds = [(s.start_round, s.n_rounds)
              for s in PORT_SCHEDULE[figure](N, seed=7).segments(rounds)]
    assert bounds == [(s.start_round, s.n_rounds)
                      for s in REF[figure].make_schedule(N, seed=7).segments(rounds)]
    if figure == "fig6":
        assert any(not s.active.all() for s in got)


@pytest.mark.parametrize("figure", figures.CHANNEL_FIGURES)
def test_model_other_than_the_mlp_prints_the_skip_row(figure):
    """The reference's own skip row, and nothing run."""
    from benchmarks import fig_correlated

    script = {**REF, "fig_corr": fig_correlated}[figure]
    want = printed(script.run, rounds=1, model="resnet20")
    got = printed(getattr(figures, figure), rounds=1, model="resnet20", device="cpu")
    assert got == want == ({}, [f"{figure}/skipped,0,reason="
                                f"{'churn' if figure == 'fig6' else 'channel'}"
                                "_study_is_mlp_only;model=resnet20"])


def test_cli_prints_the_reference_rows(capsys):
    figures.main(["--figure", "fig5", "--device", "cpu", "--rounds", "2"])
    rows = capsys.readouterr().out.splitlines()
    assert [r.split(",")[0] for r in rows] == [
        *(f"fig5/{name}" for name in POLICIES), "fig5/opt_alpha_scheduler"]


def test_cli_without_device_raises_where_there_is_no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        figures.main(["--figure", "fig5", "--engine", "pipelined", "--rounds", "1"])


def test_figures_are_run_py_figures():
    """ALL_FIGURES holds the names of ``benchmarks/run.py``'s FIGURES, in its
    order (read by ``ast``: run.py imports the JAX package's bench on use)."""
    tree = ast.parse((ROOT / "benchmarks" / "run.py").read_text())
    node = next(n for n in tree.body if isinstance(n, ast.Assign)
                and any(getattr(t, "id", None) == "FIGURES" for t in n.targets))
    assert list(figures.ALL_FIGURES) == list(ast.literal_eval(node.value))


def test_cli_all_runs_every_figure_in_run_py_order(monkeypatch):
    """``--figure all`` calls the six figures in ``run.py``'s order, each with
    the CLI's settings, and hands ``--engine`` to the channel figures only."""
    calls = []
    for name in figures.ALL_FIGURES:
        monkeypatch.setattr(figures, name, lambda name=name, **kw: calls.append((name, kw)))
    figures.main(["--figure", "all", "--engine", "scan", "--rounds", "3", "--device", "cpu",
                  "--seed", "2"])
    assert [name for name, _ in calls] == list(figures.ALL_FIGURES)
    for name, kw in calls:
        want = dict(rounds=3, model="mlp", device="cpu", relay_backend="einsum", seed=2)
        if name in figures.CHANNEL_FIGURES:
            want["engine"] = "scan"
        assert kw == want


def test_run_channel_figure_refuses_taus_for_an_engine():
    with pytest.raises(ValueError, match="loop only"):
        figures.run_channel_figure(lambda: figures.fig5_schedule(N), rounds=2,
                                   eval_round=lambda r: True, engine="scan", device="cpu",
                                   taus=np.ones((2, N)))
    with pytest.raises(ValueError, match="unknown engine"):
        figures.run_channel_figure(lambda: figures.fig5_schedule(N), rounds=2,
                                   eval_round=lambda r: True, engine="lax", device="cpu")
