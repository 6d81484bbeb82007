"""Collective bytes by (kind, source) (``repro_torch.launch.attribute``) on
the client-sharded round step over 2 gloo ranks: the gathered delta blocks
come from ``fl/distributed.py``, the ring's rotations and all-reduce from
``fl/ring.py``, each kind's total equal to what ``hlo_cost`` counts, and a
step without collectives attributes nothing."""
import pytest
import torch

from repro_torch.launch import attribute, hlo_cost
from repro_torch.launch.mesh import run_ranks

D = 64 * 32 + 32 * 10  # the attribution model: dim 64, width 32, 10 outputs


@pytest.mark.parametrize("exchange", ["gather", "ring"])
def test_sharded_step_collectives_attributed_to_their_source(exchange):
    n, rounds, k = 4, 2, 2
    m = n // k
    for attr in run_ranks(attribute.sharded_round_attribution, k,
                          args=(exchange, n, rounds), num_threads=1):
        loss_gather = {("all-gather", "fl/distributed.py:scan_rounds"): rounds * n * 4.0}
        if exchange == "gather":
            want = {("all-gather", "fl/distributed.py:scan_rounds"):
                    rounds * (n * D * 4.0 + n * 4.0)}
        else:
            want = {("collective-permute", "fl/ring.py:ring_relay_flat"):
                    rounds * (k - 1) * m * D * 4.0,
                    ("all-reduce", "fl/ring.py:ring_colrel_increment_flat"): rounds * D * 4.0,
                    **loss_gather}
        assert attr == want


def test_attribution_totals_match_the_cost_model():
    def step(x):
        return (x @ x).sum()

    x = torch.ones(8, 8)
    assert attribute.attribute(step, x) == {}
    assert hlo_cost.analyze(step, x)["collectives"] == {"total": 0.0}


def test_main_prints_the_top_entries(capsys):
    attr = attribute.main(["--ranks", "2", "--clients", "4", "--rounds", "1",
                           "--exchange", "ring", "--top", "2"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 3 and "collective-permute" in lines[1] and "fl/ring.py" in lines[1]
    assert len(attr) == 3
