"""Pytree helpers for dicts, lists and tuples of tensors, and the raveled
view of a pytree as one contiguous buffer.

Leaf order follows ``jax.tree.flatten``: dict keys are visited in *sorted*
order at every level.  (``torch.utils._pytree`` keeps insertion order, so it
is not used here.)  With the same order, the port's ``(n, D)`` buffer from
:func:`stacked_ravel` matches the JAX package's column by column.  As in
``jax.tree``, a NamedTuple keeps its type through a map (an ``EdgeRelay``
comes back an ``EdgeRelay``) and ``None`` is a node without leaves.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch

# a treedef is a nested tuple: ("leaf",), ("none",), ("dict", keys,
# children), ("list", children), ("tuple", children) or ("namedtuple", type,
# children)
_LEAF = ("leaf",)
_NONE = ("none",)


def _walk(node, leaves: list):
    # module-level, not a closure: a recursive nested function refers to
    # itself through its cell, and the cycle would keep every leaf (a staged
    # chunk's batches, say) alive until the cyclic collector ran
    if node is None:
        return _NONE
    if isinstance(node, dict):
        keys = tuple(sorted(node))
        return ("dict", keys, tuple(_walk(node[k], leaves) for k in keys))
    if isinstance(node, tuple) and hasattr(type(node), "_fields"):
        return ("namedtuple", type(node), tuple(_walk(x, leaves) for x in node))
    if isinstance(node, (list, tuple)):
        kind = "list" if isinstance(node, list) else "tuple"
        return (kind, tuple(_walk(x, leaves) for x in node))
    leaves.append(node)
    return _LEAF


def tree_flatten(tree) -> tuple[list, tuple]:
    """(leaves, treedef), dict keys sorted at every level."""
    leaves: list = []
    return leaves, _walk(tree, leaves)


def _build(td, it):
    # module-level for the same reason as _walk
    if td == _LEAF:
        return next(it)
    if td == _NONE:
        return None
    if td[0] == "dict":
        return {k: _build(c, it) for k, c in zip(td[1], td[2])}
    if td[0] == "namedtuple":
        return td[1](*(_build(c, it) for c in td[2]))
    children = [_build(c, it) for c in td[1]]
    return children if td[0] == "list" else tuple(children)


def tree_unflatten(treedef: tuple, leaves) -> Any:
    it = iter(leaves)
    out = _build(treedef, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the treedef holds")
    return out


def tree_map(fn: Callable, tree, *rest):
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten(r) for r in rest]
    for leaves_r, td in others:
        if td != treedef:
            raise ValueError("tree_map: trees differ in structure")
    return tree_unflatten(
        treedef, [fn(*xs) for xs in zip(leaves, *(lr for lr, _ in others))]
    )


def tree_add(a, b):
    return tree_map(torch.add, a, b)


def tree_sub(a, b):
    return tree_map(torch.sub, a, b)


def tree_scale(s, a):
    return tree_map(lambda x: s * x, a)


def tree_axpy(s, x, y):
    """y + s * x, elementwise over matching pytrees."""
    return tree_map(lambda xe, ye: ye + s * xe, x, y)


def tree_dot(a, b) -> torch.Tensor:
    """Σ over leaves of Σ x·y, in f32: each leaf's sum, then the leaves
    added to 0 in flatten order, as the JAX package's ``tree.reduce``."""
    leaves = tree_flatten(tree_map(lambda x, y: torch.sum(x.float() * y.float()), a, b))[0]
    return sum(leaves, torch.tensor(0.0))


def tree_norm(a) -> torch.Tensor:
    return torch.sqrt(tree_dot(a, a))


def tree_zeros_like(a):
    return tree_map(torch.zeros_like, a)


def tree_size(a) -> int:
    """Total number of scalar parameters in the pytree."""
    return sum(int(x.numel()) for x in tree_flatten(a)[0])


def tree_cast(a, dtype: torch.dtype):
    return tree_map(lambda x: x.to(dtype), a)


def from_jax_params(tree, *, device=None):
    """A pytree of numpy arrays (for example a JAX pytree passed through
    ``np.asarray``) → the same structure of torch tensors on ``device``.
    bf16 arrays (numpy dtype name ``bfloat16``) keep their bits."""

    def conv(x):
        x = np.array(x)  # a writable, contiguous copy for torch to own
        if x.dtype.name == "bfloat16":
            return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16).to(device)
        return torch.from_numpy(x).to(device)

    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [conv(x) for x in leaves])


# --------------------------------------------------------------------------
# Raveled view: pytree ⇄ one contiguous buffer under a static TreeSpec
# --------------------------------------------------------------------------

# leaf dtypes a float32 buffer represents exactly (f32 has more mantissa and
# exponent bits than either half-precision format, so the ravel→unravel
# round trip is bit-exact for these)
_F32_EXACT = (torch.float32, torch.bfloat16, torch.float16)


@dataclasses.dataclass(frozen=True)
class TreeSpec:
    """Static description of a raveled pytree: everything needed to restore
    the structured view from the contiguous buffer."""

    treedef: tuple
    shapes: tuple  # per-leaf shapes, in flatten order
    dtypes: tuple  # per-leaf torch dtypes, in flatten order

    @property
    def sizes(self) -> tuple:
        return tuple(math.prod(s) for s in self.shapes)

    @property
    def total(self) -> int:
        """D — the total scalar count of the raveled buffer."""
        return sum(self.sizes)


def tree_spec(tree) -> TreeSpec:
    leaves, treedef = tree_flatten(tree)
    return TreeSpec(
        treedef=treedef,
        shapes=tuple(tuple(x.shape) for x in leaves),
        dtypes=tuple(x.dtype for x in leaves),
    )


def _check_exact(spec: TreeSpec, dtype: torch.dtype) -> None:
    for leaf_dtype in spec.dtypes:
        if leaf_dtype != dtype and not (
            dtype == torch.float32 and leaf_dtype in _F32_EXACT
        ):
            raise TypeError(
                f"leaf dtype {leaf_dtype} is not exactly representable in a "
                f"{dtype} buffer — the ravel round trip would not be bit-exact"
            )


def tree_ravel(tree, *, dtype: torch.dtype = torch.float32):
    """Flatten ``tree`` into one contiguous ``(D,)`` buffer.

    Returns ``(flat, spec)``; ``tree_unravel(spec, flat)`` restores the
    original leaves bit for bit (float32 covers f32, bf16 and f16 leaves).
    """
    leaves, _ = tree_flatten(tree)
    spec = tree_spec(tree)
    _check_exact(spec, dtype)
    if not leaves:
        return torch.zeros((0,), dtype=dtype), spec
    return torch.cat([x.reshape(-1).to(dtype) for x in leaves]), spec


def tree_unravel(spec: TreeSpec, flat: torch.Tensor, *, cast: bool = True):
    """Restore the structured view from a raveled ``(D,)`` buffer.

    ``cast=True`` returns each leaf in its original dtype (the bit-exact
    inverse of :func:`tree_ravel`); ``cast=False`` keeps the buffer dtype —
    the increment path, where aggregation math stays f32 and the server
    optimizer owns the final cast back to the parameter dtype.
    """
    if tuple(flat.shape) != (spec.total,):
        raise ValueError(f"buffer shape {tuple(flat.shape)} != ({spec.total},)")
    leaves = []
    offset = 0
    for shape, dtype, size in zip(spec.shapes, spec.dtypes, spec.sizes):
        seg = flat[offset:offset + size].reshape(shape)
        leaves.append(seg.to(dtype) if cast else seg)
        offset += size
    return tree_unflatten(spec.treedef, leaves)


def stacked_ravel(stacked, *, dtype: torch.dtype = torch.float32):
    """Ravel a stacked per-client pytree (leaves ``(n, ...)``) into one
    contiguous ``(n, D)`` buffer.

    Returns ``(buf, spec)`` where ``spec`` describes one client's tree
    (leading dim stripped): ``buf[i]`` is exactly
    ``tree_ravel(client_i_tree)[0]``.
    """
    leaves, treedef = tree_flatten(stacked)
    if not leaves:
        return torch.zeros((0, 0), dtype=dtype), TreeSpec(treedef, (), ())
    n = leaves[0].shape[0]
    for x in leaves:
        if x.shape[0] != n:
            raise ValueError(f"inconsistent leading (client) dim: {x.shape[0]} != {n}")
    spec = TreeSpec(
        treedef=treedef,
        shapes=tuple(tuple(x.shape[1:]) for x in leaves),
        dtypes=tuple(x.dtype for x in leaves),
    )
    _check_exact(spec, dtype)
    buf = torch.cat([x.reshape(n, -1).to(dtype) for x in leaves], dim=1)
    return buf, spec
