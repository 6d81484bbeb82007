"""Logical sharding hints: the *annotation* half of the sharding subsystem.

The PyTorch counterpart of the JAX package's ``sharding/hints.py``.
`launch/mesh.py` builds the meshes (the axis vocabulary: ``clients`` /
``data`` / ``model`` / ``pod``); `sharding/rules.py` is the table that
resolves specs for whole pytree families.  This module covers tensors born
*inside* model code (attention intermediates, KV blocks), whose layout only
the model author can name: model code annotates them with **logical** axis
names via :func:`hint`, and a launcher activates a logical→mesh mapping with
:func:`axis_rules`.  With no mapping active every hint is a no-op, so model
code stays mesh-agnostic.

Under a mapping, a hint that resolves moves a
``torch.distributed.tensor.DTensor`` to the placements the mapping names
(``redistribute``, one placement per mesh axis, as `sharding/rules.py`'s
``to_shardings`` builds them).  A plain tensor passes through unchanged:
eager torch has no partitioner to constrain, and the reference's hints are
constraint-only too — they never change a value.

Contract (pinned by ``tests/test_torch_hints.py``): unknown or ``None``
logical names mean "no constraint on this dim", as does a dim that the
mapped axes do not divide; under an active mapping a rank mismatch between
tensor and annotation is an error, not a silent skip; mappings nest (the
inner :func:`axis_rules` wins and the outer is restored on exit) because
they ride a `contextvars.ContextVar`, which is thread-safe for the
prefetcher's worker thread.
"""
from __future__ import annotations

import contextlib
import contextvars

from repro_torch.sharding import rules

_rules: contextvars.ContextVar = contextvars.ContextVar("sharding_hints", default=None)


@contextlib.contextmanager
def axis_rules(mesh, mapping: dict):
    """mapping: logical name -> mesh axis (str), tuple of axes, or None."""
    token = _rules.set((mesh, dict(mapping)))
    try:
        yield
    finally:
        _rules.reset(token)


def _spec(x, logical: tuple, mesh, mapping: dict) -> tuple | None:
    """The spec the mapping gives ``x``, or None when no dim resolves."""
    if x.ndim != len(logical):
        raise ValueError(f"hint rank mismatch: {tuple(x.shape)} vs {logical}")
    axes, ok = [], False
    for dim, name in zip(x.shape, logical):
        mapped = mapping.get(name) if name else None
        if mapped is None:
            axes.append(None)
            continue
        parts = (mapped,) if isinstance(mapped, str) else tuple(mapped)
        size = 1
        for a in parts:
            size *= mesh.shape[a]
        if dim % size == 0 and dim >= size:
            axes.append(mapped)
            ok = True
        else:
            axes.append(None)
    return tuple(axes) if ok else None


def hint(x, *logical):
    """Constrain ``x`` (rank len(logical)) to the active logical mapping.
    Unknown/None logical names mean 'no constraint on this dim'."""
    active = _rules.get()
    if active is None:
        return x
    mesh, mapping = active
    spec = _spec(x, logical, mesh, mapping)
    if spec is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    placements = rules._placements(spec, mesh)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)
