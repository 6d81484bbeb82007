"""The fused relay-and-reduce kernel's device time a launch, in the cell:
the mean over the profiled window's launches of the CUDA kernels of
``src/repro_torch/kernels/csrc/relay_mix.cu`` whose names hold
``fused_aggregate`` (replayed inside the engine's chunk graphs).

It is a time and not a share of the memory roofline: in the cell the
kernel reads Δ just after the local update wrote it, and Δ fits in the
card's 50 MB L2 (10.9 MB for ResNet-20, 31.6 MB for the MLP), so the
device memory rate does not bound it.  Its byte bound, for comparison:
:func:`nbytes` over 3.35 TB/s.  A window that launched none has nothing
to read."""

KERNEL = "fused_aggregate"


def nbytes(n: int, D: int) -> int:
    """f32: Δ (n, D) read once, the update (D,) written once, the
    coefficients (n,) read once."""
    return (n + 1) * D * 4 + n * 4


def read(ctx):
    ops = [op for name, op in ctx.device_ops.items() if KERNEL in name]
    seconds, launches = sum(op[0] for op in ops), sum(op[1] for op in ops)
    if launches == 0 or seconds <= 0:
        return None
    return 1e6 * seconds / launches
