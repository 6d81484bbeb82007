"""The hand-written CUDA kernels for Hopper (``csrc/``): the relay kernels,
their plain torch versions (``ref``) and the backend dispatch (``ops``); and
ResNet-20/GN's client-batched convolutions (``conv``).

Each kernel module counts its wrappers' CUDA launches in a dict of its own
(``relay_mix.LAUNCHES``, ``conv.LAUNCHES``) made by :func:`launch_counter`;
a CPU call, which runs the plain version, counts nothing.  The functions
below see every such dict at once, so code that replays a CUDA graph
(``fl/engine.py::_ChunkGraph``) counts what its capture launched without
naming a kernel module."""
from __future__ import annotations

_LAUNCH_COUNTS: list[dict[str, int]] = []


def launch_counter(*names: str) -> dict[str, int]:
    """A kernel module's launch counts, one a kernel name, all zero."""
    counts = dict.fromkeys(names, 0)
    _LAUNCH_COUNTS.append(counts)
    return counts


def launches() -> dict[str, int]:
    """Every kernel's launches so far, by name (a copy)."""
    return {name: n for counts in _LAUNCH_COUNTS for name, n in counts.items()}


def reset_launches(counts: dict[str, int] | None = None) -> None:
    """Zero one module's ``counts``, or every kernel's."""
    for c in _LAUNCH_COUNTS if counts is None else (counts,):
        for name in c:
            c[name] = 0


def count_launches(counts: dict[str, int]) -> None:
    """Add ``counts`` (by kernel name) to the modules' counts: a CUDA graph's
    replay launches the kernels its capture recorded without running their
    wrappers, so the code that replays it counts them here, once a
    replay."""
    for c in _LAUNCH_COUNTS:
        for name in c.keys() & counts.keys():
            c[name] += counts[name]
