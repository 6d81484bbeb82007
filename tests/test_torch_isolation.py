"""The PyTorch port stands alone: it imports neither jax nor the JAX package,
and its entry points never fall back to the CPU quietly."""
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
PORT_FILES = (sorted(PORT.rglob("*.py")) + sorted((ROOT / "examples").glob("torch_*.py"))
              + [ROOT / "chip_smoke.py"])
MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts).removesuffix(".__init__")
    for p in PORT.rglob("*.py")
)

_BLOCKED_IMPORTS = """
import importlib, sys
for name in ("jax", "jaxlib", "repro"):
    sys.modules[name] = None  # any import of these now raises ImportError
sys.path[:0] = [{src!r}, {root!r}]
for mod in {modules!r}:
    importlib.import_module(mod)
import chip_smoke
assert not any(m == "jax" or m.startswith(("jax.", "repro.")) for m in sys.modules
               if sys.modules[m] is not None)
print("ok", len({modules!r}))
"""


def test_port_imports_without_jax_or_repro():
    code = _BLOCKED_IMPORTS.format(src=str(ROOT / "src"), root=str(ROOT), modules=MODULES)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == f"ok {len(MODULES)}"
    assert "repro_torch.fl.simulator" in MODULES and len(MODULES) >= 25


_EACH_MODULE_FIRST = """
import importlib, sys
sys.path[:0] = [{src!r}]
for mod in {modules!r}:
    for name in [m for m in sys.modules if m == "repro_torch" or m.startswith("repro_torch.")]:
        del sys.modules[name]
    importlib.import_module(mod)
print("ok")
"""


def test_each_module_imports_first_without_a_cycle():
    """The package re-exports (core, fl, data, optim) must not make the
    import order matter: each module imports cleanly as the first one."""
    code = _EACH_MODULE_FIRST.format(src=str(ROOT / "src"), modules=MODULES)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import_in_source(path):
    text = path.read_text()
    bad = re.compile(r"^\s*(import jax|from jax|import repro\.|from repro\.|"
                     r"import repro\s*$|from repro import)", re.MULTILINE)
    assert not bad.search(text), f"{path} imports jax or the JAX package"


def test_simulator_without_device_runs_on_the_gpu_or_raises():
    from repro_torch.fl.simulator import FLSimulator
    from repro_torch.models.resnet import init_resnet20
    from repro_torch.configs.resnet20_cifar import CONFIG

    def loss(p, b):
        return p["w"].sum()

    if torch.cuda.is_available():
        assert FLSimulator(loss, n_clients=2, strategy="no_dropout").device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FLSimulator(loss, n_clients=2, strategy="no_dropout")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_resnet20(0, CONFIG)
    assert FLSimulator(loss, n_clients=2, strategy="no_dropout",
                       device="cpu").device.type == "cpu"
