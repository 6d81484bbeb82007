"""The port's learning-rate schedules (``repro_torch.optim.schedules``)
against the JAX package's, and the ``optim`` package's names."""
import numpy as np
import pytest

from repro.optim import schedules as jax_schedules
from repro_torch.optim import ClientOpt, schedules
from repro_torch.optim.sgd import ClientOpt as SgdClientOpt


@pytest.mark.parametrize("name, args, kwargs", [
    ("paper_lr", (1.0, 8), {}),
    ("paper_lr", (0.37, 3), {}),
    ("constant", (0.1,), {}),
    ("cosine", (1.0, 100), {}),
    ("cosine", (0.05, 37), {"final_frac": 0.25}),
])
def test_schedules_equal_jax(name, args, kwargs):
    got = getattr(schedules, name)(*args, **kwargs)
    want = getattr(jax_schedules, name)(*args, **kwargs)
    for r in (0, 1, 2, 10, 36, 37, 50, 99, 100, 150):
        assert got(r) == want(r)


def test_paper_schedule():
    lr = schedules.paper_lr(mu=1.0, T=8)
    assert np.isclose(lr(0), 4.0)
    assert np.isclose(lr(10), 4.0 / 81.0)
    assert lr(100) < lr(10) < lr(1)


def test_other_schedules():
    assert schedules.constant(0.1)(99) == 0.1
    c = schedules.cosine(1.0, 100)
    assert c(0) == pytest.approx(1.0)
    assert c(100) == pytest.approx(0.1)
    assert c(50) < c(10)


def test_optim_package_reexports():
    assert ClientOpt is SgdClientOpt
