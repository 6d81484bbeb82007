"""Loop-aware cost model of a step: FLOPs, device-memory bytes and
collective bytes by kind.

The PyTorch counterpart of the JAX package's ``launch/hlo_cost.py``.  The
reference parses the compiled HLO text and multiplies each ``while`` body by
its trip count, because XLA's own cost analysis counts a loop body once.
Eager torch has no compiled module: :func:`analyze` runs the step under a
``TorchDispatchMode`` and counts every op the step dispatches, so a loop
over layers, chunks or rounds is counted once a trip by construction — the
multiplicity the reference's parser reconstructs.  Run it on ``meta``
tensors and nothing is allocated or computed (the dry run does); real
tensors work too (a collective needs them).

  * **FLOPs**: the matmul and convolution family (``mm``, ``addmm``,
    ``bmm``, ``baddbmm``, the convolutions and their backward, the fused
    attention ops), from the formulas of ``torch.utils.flop_counter`` —
    2·|out|·K for a product, as the reference counts a ``dot``.
  * **bytes**: operand plus result bytes of every op that is not a view or
    an allocation: an *unfused upper bound* of the device-memory traffic
    (the reference counts the operands and results of XLA's fused ops,
    whose internals stay on chip; eager torch writes every intermediate).
  * **collectives**: bytes by kind from the ``c10d`` and
    ``_c10d_functional`` ops, the size of each op's result as the
    reference counts it (an all-gather's gathered tensor, a
    reduce-scatter's block, a point-to-point receive's buffer).

The HLO-text helpers of the reference (``parse_computations``,
``build_def_shapes``, ``OpInfo``) have no counterpart: torch produces no HLO
text.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.utils import tree_flatten

# the reference's HLO dtype names, and torch's dtypes under the same names
DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1,
}

COLLECTIVES = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute",
)

# c10d / _c10d_functional op name → (collective kind, argument holding the
# result whose bytes count: "out" for the op's return, else an argument
# index)
_COLLECTIVE_OPS = {
    "allreduce_": ("all-reduce", 0),
    "allreduce_coalesced_": ("all-reduce", 0),
    "all_reduce": ("all-reduce", "out"),
    "all_reduce_coalesced": ("all-reduce", "out"),
    "allgather_": ("all-gather", 0),
    "_allgather_base_": ("all-gather", 0),
    "allgather_into_tensor_coalesced_": ("all-gather", 0),
    "all_gather_into_tensor": ("all-gather", "out"),
    "all_gather_into_tensor_coalesced": ("all-gather", "out"),
    "reduce_scatter_": ("reduce-scatter", 0),
    "_reduce_scatter_base_": ("reduce-scatter", 0),
    "reduce_scatter_tensor": ("reduce-scatter", "out"),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", "out"),
    "alltoall_": ("all-to-all", 0),
    "alltoall_base_": ("all-to-all", 0),
    "all_to_all_single": ("all-to-all", "out"),
    "recv_": ("collective-permute", 0),
}

# ops that move no device memory of their own: allocations without a
# write, and aliases
_NO_BYTES = {"empty", "empty_strided", "empty_like", "detach", "alias", "lift_fresh",
             "_local_scalar_dense", "set_", "resize_"}


def _tensors(tree) -> list:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _nbytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in _tensors(tree))


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collectives: dict = dataclasses.field(default_factory=dict)

    def add(self, other: "Cost", mult: float = 1.0):
        self.flops += mult * other.flops
        self.hbm_bytes += mult * other.hbm_bytes
        for k, v in other.collectives.items():
            self.collectives[k] = self.collectives.get(k, 0.0) + mult * v


class _CostMode(TorchDispatchMode):
    """Counts the ops dispatched under it into a :class:`Cost`; ``on_op``,
    if given, sees each op with its own cost (``launch/attribute.py``)."""

    def __init__(self, on_op=None):
        super().__init__()
        self.cost = Cost()
        self.on_op = on_op

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        own = Cost()
        packet = func.overloadpacket
        name = packet.__name__
        if packet in flop_registry:
            own.flops = float(flop_registry[packet](*args, **kwargs, out_val=out))
        if func.namespace in ("c10d", "_c10d_functional") and name in _COLLECTIVE_OPS:
            kind, where = _COLLECTIVE_OPS[name]
            own.collectives[kind] = float(_nbytes(out if where == "out" else args[where]))
        elif not (func.is_view or name in _NO_BYTES or func.namespace == "c10d"):
            own.hbm_bytes = float(_nbytes((args, kwargs)) + _nbytes(out))
        self.cost.add(own)
        if self.on_op is not None:
            self.on_op(func, own)
        return out


def analyze(fn, *args, **kw) -> dict:
    """Run ``fn(*args, **kw)`` and count what it dispatches: ``{"flops",
    "hbm_bytes", "collectives": {kind: bytes, ..., "total"}}``, the
    reference's keys.  Pass ``meta`` tensors to count without computing."""
    mode = _CostMode()
    with mode:
        fn(*args, **kw)
    cost = mode.cost
    return {
        "flops": cost.flops,
        "hbm_bytes": cost.hbm_bytes,
        "collectives": {**cost.collectives, "total": float(sum(cost.collectives.values()))},
    }
