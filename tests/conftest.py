import os
import sys

# Tests run on the single local CPU device (the 512-device override is
# strictly dry-run-only, per the launcher contract).
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running convergence tests (deselected by `make test-fast`)",
    )
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU (the PyTorch port's CUDA kernels); skips without one",
    )
