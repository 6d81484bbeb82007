"""The ColRel relay hot spot as hand-written CUDA kernels for Hopper:
Δ̃ = A·Δ (``relay_mix_2d``) and the fused τ-weighted PS reduction
u = c·Δ (``fused_aggregate_2d``).

Shape regime: A is tiny ((n, n), n ≈ 10 clients on the main path) and Δ is
long ((n, D), D = the model's parameter count).  The mix is bound by
device-memory bytes.  The fused reduction reads n·D elements once: at the
main-path shape (10, 272,282) f32 what bounds it is first the launch and the
ramp until enough loads are in flight, then the bytes; at (8, 10⁷) the
bytes.  Its kernel is built for that: one wave of blocks (the card's SMs ×
the kernel's resident blocks an SM, capped at the column tiles) striding
over column tiles, c staged in shared memory once a block, V columns a
thread read as one vector, and a chunk of origins' loads in flight before
the first FMA.  The vector is the widest of 16, 8 or 4 bytes that divides
Δ's base address, the output's and the row pitch D·sizeof(dtype) (else one
element): f32 at the main shape takes 8-byte loads, bf16 4-byte ones.
:func:`fused_aggregate_plan` reports the choice.  The design notes sit in
``csrc/relay_mix.cu``.

Each wrapper checks its operands and then, by the device of Δ:

* CUDA: launches its kernel on the current stream (the library is built at
  first use, see :mod:`repro_torch.kernels.build`) and counts the launch in
  :data:`LAUNCHES`.  A failed build or launch raises; there is no fallback.
  Under a CUDA graph capture the launch is recorded, and the graph's
  replays count it (:func:`count_launches`).
* CPU: runs the plain version in :mod:`repro_torch.kernels.ref` with the
  kernel's own dtype rules (weights rounded to Δ's dtype, f32 sums, result
  in Δ's dtype).

``relay_mix_2d`` is differentiable (a :class:`torch.autograd.Function`, the
counterpart of the Pallas kernel's ``custom_vjp``): dΔ = Aᵀ·g runs the same
kernel, dA = g·Δᵀ is a small f32 product cast to A's dtype.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref as _ref

# Launches of each CUDA kernel since the last reset_launches(); a CPU call,
# which runs the plain version, counts nothing.
LAUNCHES = {"relay_mix_2d": 0, "fused_aggregate_2d": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def count_launches(counts: dict) -> None:
    """Add ``counts`` to :data:`LAUNCHES`: a CUDA graph's replay launches
    the kernels its capture recorded without running their wrappers, so the
    code that replays it counts them here, once a replay."""
    for name, n in counts.items():
        LAUNCHES[name] += n


def _check(name: str, weights: torch.Tensor, delta: torch.Tensor, *, square: bool):
    if not isinstance(delta, torch.Tensor) or delta.dim() != 2:
        raise ValueError(f"{name}: Δ must be a 2-D (n, D) tensor")
    n = delta.shape[0]
    wshape = (n, n) if square else (n,)
    if delta.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: Δ dtype {delta.dtype} not in (float32, bfloat16)")
    if weights.dtype != torch.float32:
        raise TypeError(f"{name}: weights must be float32, got {weights.dtype}")
    if tuple(weights.shape) != wshape:
        raise ValueError(f"{name}: weights shape {tuple(weights.shape)} != {wshape}")
    if weights.device != delta.device:
        raise ValueError(f"{name}: weights on {weights.device}, Δ on {delta.device}")
    if delta.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {delta.device}")
    if not (delta.is_contiguous() and weights.is_contiguous()):
        raise ValueError(f"{name}: operands must be contiguous")


def _launch(name: str, weights: torch.Tensor, delta: torch.Tensor, out: torch.Tensor):
    n, D = delta.shape
    if out.numel() == 0:
        return out
    fn = getattr(build.library(), f"{name}_launch")
    stream = torch.cuda.current_stream(delta.device).cuda_stream
    with torch.cuda.device(delta.device):
        err = fn(weights.data_ptr(), delta.data_ptr(), out.data_ptr(), n, D,
                 _DTYPE_CODES[delta.dtype], stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")
    LAUNCHES[name] += 1
    return out


def _mix_forward(A: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    _check("relay_mix_2d", A, delta, square=True)
    if delta.device.type == "cpu":
        return _ref.relay_mix_2d(A.to(delta.dtype), delta)
    return _launch("relay_mix_2d", A, delta, torch.empty_like(delta))


class _RelayMix(torch.autograd.Function):
    @staticmethod
    def forward(ctx, A, delta):
        ctx.save_for_backward(A, delta)
        return _mix_forward(A, delta)

    @staticmethod
    def backward(ctx, g):
        # the mix is linear: dΔ = Aᵀ·g through the same kernel; dA = g·Δᵀ is
        # a small (n, n) reduction, as the JAX package's einsum outside its
        # kernel
        A, delta = ctx.saved_tensors
        g = g.contiguous()
        ddelta = _mix_forward(A.t().contiguous(), g)
        dA = (g.float() @ delta.float().t()).to(A.dtype)
        return dA, ddelta


def relay_mix_2d(A: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Δ̃ = A @ Δ for Δ of shape (n, D) → (n, D) in Δ's dtype."""
    return _RelayMix.apply(A, delta)


def fused_aggregate_2d(coeffs: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """u = coeffs @ Δ (coeffs = w·τᵀA, shape (n,)) → (D,) in Δ's dtype."""
    _check("fused_aggregate_2d", coeffs, delta, square=False)
    if delta.device.type == "cpu":
        return _ref.fused_aggregate_2d(coeffs.to(delta.dtype), delta)
    out = torch.empty(delta.shape[1], dtype=delta.dtype, device=delta.device)
    return _launch("fused_aggregate_2d", coeffs, delta, out)


def fused_aggregate_plan(delta: torch.Tensor) -> dict:
    """The launch :func:`fused_aggregate_2d` makes for this CUDA Δ (into an
    output from torch's allocator): ``vec_bytes`` (bytes a load),
    ``grid`` (blocks) and ``blocks_per_sm`` (resident blocks an SM).
    Launches nothing."""
    if delta.device.type != "cuda" or delta.dim() != 2 or delta.dtype not in _DTYPE_CODES:
        raise ValueError("fused_aggregate_plan: Δ must be a 2-D f32 or bf16 CUDA tensor")
    n, D = delta.shape
    out = torch.empty(D, dtype=delta.dtype, device=delta.device)
    plan = (ctypes.c_int * 3)()
    with torch.cuda.device(delta.device):
        err = build.library().fused_aggregate_2d_plan(
            delta.data_ptr(), out.data_ptr(), n, D, _DTYPE_CODES[delta.dtype], plan)
    if err != 0:
        raise RuntimeError(f"fused_aggregate_plan: CUDA error {err}")
    return {"vec_bytes": plan[0], "grid": plan[1], "blocks_per_sm": plan[2]}
