"""Where the port runs: on the GPU unless the caller asks for the CPU."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU: ``cuda`` when one is present, and an error when
    none is, never a quiet fall back to the CPU.  Pass ``device="cpu"`` to
    run on the CPU (the tests do)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: repro_torch runs on the GPU by default; pass "
            "device='cpu' to run on the CPU"
        )
    return torch.device("cuda")
