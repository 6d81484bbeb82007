"""The H100's published peaks, the least time a piece of work can take on
it, and the device's busy time.

``bound_ms`` is a frozen copy of ``src/repro_torch/bench/kernel_bench.py``
at commit c3a27a4, and ``device_busy_s`` of ``chip_smoke.py::device_busy_ms``
at the same commit (in seconds here): the union of the device activities'
intervals, each instant counted once, which does not double-count a CUDA
graph replay.
"""
from __future__ import annotations

import math

# NVIDIA's H100 SXM data sheet (dense rates, 700 W): the device memory rate
# and the f32 rate outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    """The least time the card could take: bytes over its memory rate or
    f32 operations over its f32 rate, whichever is larger, and which."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_busy_s(intervals) -> float:
    """Seconds in which some device activity ran: the union of the
    intervals (µs), each instant counted once."""
    busy_us, end = 0.0, -math.inf
    for lo, hi in intervals:
        busy_us += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    return busy_us / 1e6
