"""The port's copies of the ColRel examples (``examples/torch_*.py``) run on
the CPU at a few rounds, each in its own process, and exit 0."""
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ["torch_quickstart.py", "torch_client_churn.py",
            "torch_timevarying_channel.py", "torch_correlated_shadowing.py"]


def test_every_torch_example_is_listed():
    assert sorted(p.name for p in (ROOT / "examples").glob("torch_*.py")) == sorted(EXAMPLES)


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs_on_the_cpu(name):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / name), "--device", "cpu", "--rounds", "6"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    assert "acc@6" in proc.stdout
