"""The ColRel relay hot spot as hand-written CUDA kernels for Hopper:
Δ̃ = A·Δ (``relay_mix_2d``) and the fused τ-weighted PS reduction
u = c·Δ (``fused_aggregate_2d``).

Shape regime: A is tiny ((n, n), n ≈ 10 clients on the main path) and Δ is
long ((n, D), D = the model's parameter count).  Both kernels read Δ in
vectors: the widest of 16, 8 or 4 bytes that divides Δ's base address, the
output's and the row pitch D·sizeof(dtype) (else one element); f32 at the
main shape (10, 272,282) takes 8-byte loads, bf16 4-byte ones.

``relay_mix_2d`` takes one of two paths by n (:func:`relay_mix_plan`
reports which, with its vectors, grid and threads):

* ``stream`` (n ≤ 32, every path the port drives).  Bound by device-memory
  bytes (n·D elements in, n·D out).  One wave of 128-thread blocks (the
  card's SMs × the kernel's resident blocks an SM, capped at the column
  tiles) striding over column tiles, the row passes spread over more blocks
  when the tiles are fewer than the SMs; each thread loads all n origins of
  one vector before its first FMA; A rounded and staged in shared memory
  once a block, behind the first tile's loads.
* ``slab`` (n > 32).  At n ≥ 80 the f32 FMAs bound it (n/4 flop a byte
  against the card's 20).  A block holds up to 128 rows × 128 columns of the
  output in 8 × 4 (n ≤ 64) or 16 × 4 register tiles and walks the origins
  in chunks of 32, each chunk's slab of Δ and of A copied into shared
  memory by cp.async, double-buffered; for n ≤ 128 each element of Δ is
  read from device memory once.

No tensor cores: TF32 would change the bits.  The fused reduction reads
n·D elements once: at the main shape what bounds it is first the launch and
the ramp until enough loads are in flight, then the bytes; at (8, 10⁷) the
bytes.  Its order is :func:`fused_splits`'s, a function of (n, D) alone:

* S = 1 (n ≤ 128 or D ≥ 131,072, every path but the sample sweeps): one
  ascending chain an element.  One wave of blocks striding over column
  tiles, c staged in shared memory once a block, and a chunk of origins'
  loads in flight before the first FMA.
* S > 1 (many clients at a small D): S ranges of at most 64 origins, each
  one chain into an f32 partial, the partials added in ascending order.  A
  block a (column tile, range), its range's rows staged in shared memory by
  cp.async; the last block of a tile to finish adds the tile's partials.
  The wrapper allocates the partials (``torch.empty`` on the current
  stream) and hands over tile counters that are zero and that the kernel
  leaves zero (:func:`_counters`).

:func:`fused_aggregate_plan` reports the launch.  The design notes sit in
``csrc/relay_mix.cu``.

Each wrapper checks its operands and then, by the device of Δ:

* CUDA: launches its kernel on the current stream (the library is built at
  first use, see :mod:`repro_torch.kernels.build`) and counts the launch in
  :data:`LAUNCHES`.  A failed build or launch raises; there is no fallback.
  Under a CUDA graph capture the launch is recorded, and the graph's
  replays count it (:func:`count_launches`).
* CPU: runs the plain version in :mod:`repro_torch.kernels.ref` with the
  kernel's own dtype rules (weights rounded to Δ's dtype, f32 sums in
  ascending origin order, result in Δ's dtype).

``relay_mix_2d`` is differentiable (a :class:`torch.autograd.Function`, the
counterpart of the Pallas kernel's ``custom_vjp``): dΔ = Aᵀ·g runs the same
kernel, dA = g·Δᵀ is a small f32 product cast to A's dtype.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, launch_counter
from repro_torch.kernels import count_launches  # noqa: F401 (relay_mix.count_launches)
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import reset_launches as _reset_launches
from repro_torch.kernels.ref import fused_splits

# Launches of each CUDA kernel since the last reset_launches(); a CPU call,
# which runs the plain version, counts nothing.  A graph's replays are
# counted by count_launches (:mod:`repro_torch.kernels`).
LAUNCHES = launch_counter("relay_mix_2d", "fused_aggregate_2d")

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


# The split kernel's tile counters: zeroed once, left zeroed by the kernel
# (the last block of a tile resets its counter).  Two launches that may run
# at once never share them: a buffer serves one stream's eager launches (a
# stream runs its launches in order), or one stream's launches within one
# CUDA graph capture (they run in order at every replay, and the graph's
# replays run in order).  A capture's buffer is zeroed inside the graph,
# once a replay, and held for the process (the graph may replay at any
# time).
_COUNTERS_LEN = 4096  # ints a buffer: tiles of 32 one-element vectors, D < 131,072
_counter_buffers: dict = {}  # (device index, stream, capture id or 0) -> int32 tensor


def _counters(device: torch.device, length: int) -> torch.Tensor:
    """Zeroed tile counters, at least ``length``, for a launch on the
    current stream of ``device``."""
    stream = torch.cuda.current_stream(device).cuda_stream
    key = (device.index, stream, build.library().stream_capture_id(stream))
    buf = _counter_buffers.get(key)
    if buf is None or buf.numel() < length:
        # on the current stream, so zeroed before the launch reads it
        buf = torch.zeros(max(length, _COUNTERS_LEN), dtype=torch.int32, device=device)
        _counter_buffers[key] = buf
    return buf


def reset_launches() -> None:
    _reset_launches(LAUNCHES)


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


def _launch(name: str, weights: torch.Tensor, delta: torch.Tensor, out: torch.Tensor,
            *extra):
    """``{name}_launch`` on the current stream; ``extra`` are the launcher's
    arguments between the dtype and the stream."""
    n, D = delta.shape
    if out.numel() == 0:
        return out
    fn = getattr(build.library(), f"{name}_launch")
    stream = torch.cuda.current_stream(delta.device).cuda_stream
    with torch.cuda.device(delta.device):
        err = fn(weights.data_ptr(), delta.data_ptr(), out.data_ptr(), n, D,
                 _DTYPE_CODES[delta.dtype], *extra, stream)
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
    """u = coeffs @ Δ (coeffs = w·τᵀA, shape (n,)) → (D,) in Δ's dtype, in
    :func:`fused_splits`'s order."""
    _check("fused_aggregate_2d", coeffs, delta, square=False)
    if delta.device.type == "cpu":
        return _ref.fused_aggregate_2d(coeffs.to(delta.dtype), delta)
    n, D = delta.shape
    out = torch.empty(D, dtype=delta.dtype, device=delta.device)
    splits = fused_splits(n, D)
    if splits == 1:
        return _launch("fused_aggregate_2d", coeffs, delta, out, 1, None, None, 0)
    length = ctypes.c_longlong()
    with torch.cuda.device(delta.device):
        nbytes = build.library().fused_aggregate_2d_workspace(D, splits, ctypes.byref(length))
        # on the current stream: a capture takes them from the graph's pool
        partials = torch.empty(nbytes, dtype=torch.uint8, device=delta.device)
        counters = _counters(delta.device, length.value)
    return _launch("fused_aggregate_2d", coeffs, delta, out, splits, partials.data_ptr(),
                   counters.data_ptr(), counters.numel())


def _plan(name: str, delta: torch.Tensor, size: int, *extra, rows: bool) -> list[int]:
    """The ``size`` ints that ``{name}_2d_plan`` fills for this Δ and an
    output from torch's allocator ((n, D) with ``rows``, else (D,));
    ``extra`` are its arguments between the dtype and the plan."""
    if delta.device.type != "cuda" or delta.dim() != 2 or delta.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}_plan: Δ must be a 2-D f32 or bf16 CUDA tensor")
    n, D = delta.shape
    out = torch.empty(delta.shape if rows else D, dtype=delta.dtype, device=delta.device)
    plan = (ctypes.c_int * size)()
    with torch.cuda.device(delta.device):
        err = getattr(build.library(), f"{name}_2d_plan")(
            delta.data_ptr(), out.data_ptr(), n, D, _DTYPE_CODES[delta.dtype], *extra, plan)
    if err != 0:
        raise RuntimeError(f"{name}_plan: CUDA error {err}")
    return list(plan)


def relay_mix_plan(delta: torch.Tensor) -> dict:
    """The launch :func:`relay_mix_2d` makes for this CUDA Δ: ``path``
    (``"stream"`` for n ≤ 32, ``"slab"`` beyond), ``vec_bytes`` (bytes a load
    of Δ), ``grid`` (blocks), ``blocks_per_sm`` (resident blocks an SM) and
    ``threads`` (a block).  Launches nothing."""
    path, vec_bytes, grid, blocks_per_sm, threads = _plan("relay_mix", delta, 5, rows=True)
    return {"path": {1: "stream", 2: "slab"}[path], "vec_bytes": vec_bytes, "grid": grid,
            "blocks_per_sm": blocks_per_sm, "threads": threads}


def fused_aggregate_plan(delta: torch.Tensor) -> dict:
    """The launch :func:`fused_aggregate_2d` makes for this CUDA Δ:
    ``splits`` (S, its origin ranges), ``vec_bytes`` (bytes a load),
    ``grid`` (blocks: one wave for S = 1, column tiles × S beyond),
    ``blocks_per_sm`` (resident blocks an SM), ``threads`` (a block) and
    ``tile`` (column vectors a tile).  Launches nothing."""
    splits = fused_splits(*delta.shape) if delta.dim() == 2 else 1
    vec_bytes, grid, blocks_per_sm, threads, tile = _plan("fused_aggregate", delta, 5, splits,
                                                          rows=False)
    return {"splits": splits, "vec_bytes": vec_bytes, "grid": grid,
            "blocks_per_sm": blocks_per_sm, "threads": threads, "tile": tile}
