"""The port's copies of the examples (``examples/torch_*.py``) run on the
CPU, each in its own process, and exit 0: the ColRel examples at a few
rounds, the LM examples at a small size (the 3m preset for training, a
``reduced()`` config for serving) and a few rounds or tokens."""
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ["torch_quickstart.py", "torch_client_churn.py",
            "torch_timevarying_channel.py", "torch_correlated_shadowing.py"]
LM_EXAMPLES = {
    "torch_train_lm.py": ["--preset", "3m", "--rounds", "3", "--seq-len", "32",
                          "--log-every", "1"],
    "torch_serve_lm.py": ["--arch", "recurrentgemma-9b", "--batch", "2",
                          "--prompt-len", "24", "--new-tokens", "6"],
}


def test_every_torch_example_is_listed():
    assert sorted(p.name for p in (ROOT / "examples").glob("torch_*.py")) == sorted(
        EXAMPLES + list(LM_EXAMPLES))


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs_on_the_cpu(name):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / name), "--device", "cpu", "--rounds", "6"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    assert "acc@6" in proc.stdout


@pytest.mark.parametrize("name", sorted(LM_EXAMPLES))
def test_lm_example_runs_on_the_cpu(name, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    extra = ["--checkpoint", str(tmp_path / "lm.npz")] if "train" in name else []
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / name), "--device", "cpu",
         *LM_EXAMPLES[name], *extra],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    if "train" in name:
        assert "round    2 train_loss=" in proc.stdout and (tmp_path / "lm.npz").exists()
    else:
        assert "request 1: [" in proc.stdout
