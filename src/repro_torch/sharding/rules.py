"""Sharding rules: the one place pytree structure meets mesh axes.

The PyTorch counterpart of the JAX package's ``sharding/rules.py``.  Every
distributed entry point — the client-sharded round step
(`repro_torch.fl.distributed.build_sharded_scan_round_step`), its engine's
staging, the D-axis mode — resolves its layouts here, so "which dim lives
on which axis" is a table, not a convention scattered across call sites.

A **spec** is a plain tuple with one entry per dim of its leaf: ``None``
(replicated), an axis name, or a tuple of axis names (the dim split over
their product).  The JAX package's ``PartitionSpec`` is a tuple subclass, so
the two packages' specs compare as ``tuple(spec)``.  The rules, by pytree
family:

* **weights** (:func:`param_specs`): largest divisible dim → ``"model"``;
  in ``fsdp_tp`` mode a second divisible dim → ``"data"``.  Stacked-layer
  leading dims (under ``blocks``/``groups``/``rem``/``enc_blocks``/
  ``selfs``) are never sharded.  In the federated engines the parameters
  stay replicated — every client starts each round from the same global
  model.
* **train batches** (:func:`train_batch_specs`): leaves
  ``(n_clients, T, b, ...)`` — the client dim → the client axes.
* **round-stacked train batches** (:func:`round_batch_specs`): leaves
  ``(R, n_clients, T, b, ...)`` — dim 1 → the mesh's client axis.  The
  sharded engine stages each chunk by slicing this dim to the rank's
  clients, so a rank copies only its clients' bytes to its device.
* **the raveled (n, D) delta buffer** (:func:`flat_buffer_specs`): D-axis
  mode splits dim 1 over ``"model"`` when D divides, so each rank contracts
  its column slice.
* **serve batches / caches** (:func:`serve_batch_specs`,
  :func:`cache_specs`): batch dim → client axes; caches additionally shard
  the largest remaining divisible dim → ``"model"``.

:func:`to_shardings` turns a spec tree into ``torch.distributed.tensor``
placements for a mesh.  Rule resolution is pure shape arithmetic over any
object with ``axis_names`` and a ``shape`` dict — no process group is
touched (``tests/test_torch_sharding_rules.py``).

Spec trees are dicts and lists of specs: a tuple inside one is a spec, never
a container.
"""
from __future__ import annotations

STACK_KEYS = ("blocks", "groups", "rem", "enc_blocks", "selfs")


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a pytree of dicts, lists and tuples; ``path``
    is the tuple of dict keys and sequence indices from the root."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    return fn(path, tree)


def _map(fn, tree):
    return _map_with_path(lambda _, leaf: fn(leaf), tree)


def client_axes(mesh) -> tuple:
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def _entry(axes: tuple):
    """A spec entry for ``axes``: the bare name for one axis (as JAX's
    ``PartitionSpec`` normalizes it), the tuple for several."""
    return axes[0] if len(axes) == 1 else axes


def _param_spec(path, leaf, mesh, mode: str) -> tuple:
    model_n = mesh.shape["model"]
    data_n = mesh.shape["data"]
    # VLM group-stacks are two deep (groups, selfs): skip every stack dim
    skip = sum(1 for p in path if p in STACK_KEYS)
    dims = list(leaf.shape)
    spec = [None] * len(dims)
    # the model-sharded dim: the largest dim (idx >= skip) divisible by model_n
    cands = [
        (size, i) for i, size in enumerate(dims)
        if i >= skip and size % model_n == 0 and size >= model_n
    ]
    if cands:
        _, mi = max(cands)
        spec[mi] = "model"
        if mode == "fsdp_tp":
            cands2 = [
                (size, i) for i, size in enumerate(dims)
                if i >= skip and i != mi and size % data_n == 0 and size >= data_n
            ]
            if cands2:
                _, di = max(cands2)
                spec[di] = "data"
    return tuple(spec)


def param_specs(params, mesh, mode: str = "tp"):
    """Spec pytree for a parameter (or optimizer-state) pytree."""
    return _map_with_path(lambda path, leaf: _param_spec(path, leaf, mesh, mode), params)


def train_batch_specs(batch, mesh):
    """Round batches: leaves (n_clients, T, b, ...) — client dim sharded."""
    ca = _entry(client_axes(mesh))
    return _map(lambda leaf: (ca,) + (None,) * (leaf.ndim - 1), batch)


def shard_axis(mesh) -> str:
    """The client-shard axis of a mesh: ``"clients"`` on a client mesh
    (`launch.mesh.make_client_mesh`), else the first client axis of the
    production mesh layout."""
    return "clients" if "clients" in mesh.axis_names else client_axes(mesh)[0]


def round_batch_specs(batch, mesh):
    """Epoch-stacked round batches: leaves (R, n_clients, T, b, ...) — dim 1
    (the client dim) sharded over the mesh's client axis, the round dim and
    everything per-client replicated.  This is the staging layout of the
    sharded engine: each rank keeps exactly its clients' rows."""
    ax = shard_axis(mesh)
    return _map(lambda leaf: (None, ax) + (None,) * (leaf.ndim - 2), batch)


def flat_buffer_specs(mesh, *, n: int | None = None, d: int | None = None) -> tuple:
    """Spec of the raveled (n, D) delta buffer in D-axis mode: dim 1 →
    "model" when D divides the model-axis size (else fully replicated — a
    split that does not divide is worse than none).  ``n``/``d`` are the
    buffer dims when known; ``d=None`` defers the divisibility check to the
    caller."""
    model_n = mesh.shape.get("model", 1)
    if model_n <= 1:
        return (None, None)
    if d is not None and (d % model_n != 0 or d < model_n):
        return (None, None)
    return (None, "model")


def serve_batch_specs(batch, mesh):
    ca = client_axes(mesh)
    ca_size = 1
    for a in ca:
        ca_size *= mesh.shape[a]

    def spec(leaf):
        if leaf.ndim and leaf.shape[0] % ca_size == 0 and leaf.shape[0] >= ca_size:
            return (_entry(ca),) + (None,) * (leaf.ndim - 1)
        return (None,) * leaf.ndim  # e.g. global_batch = 1

    return _map(spec, batch)


def cache_specs(cache, mesh, batch_size: int):
    """KV caches / SSM states with leading stacked-layer dims.

    The batch dim is identified by exact size match against ``batch_size``.
    Batch → client axes; then the largest remaining divisible dim → "model";
    ``pos`` ring buffers shard their capacity dim over "model" to stay
    aligned with the k/v leaves.
    """
    ca = client_axes(mesh)
    model_n = mesh.shape["model"]
    ca_size = 1
    for a in ca:
        ca_size *= mesh.shape[a]

    def spec(path, leaf):
        if leaf.ndim == 0:
            return ()
        s = [None] * leaf.ndim
        if "pos" in path:  # (L[, G], cap): no batch dim
            if leaf.shape[-1] % model_n == 0:
                s[-1] = "model"
            return tuple(s)
        bi = None
        if batch_size % ca_size == 0:
            for i, size in enumerate(leaf.shape):
                if size == batch_size:
                    bi = i
                    break
        if bi is not None:
            s[bi] = _entry(ca)
        cands = [
            (size, i) for i, size in enumerate(leaf.shape)
            if i != bi and size % model_n == 0 and size >= model_n
            # leading layer-stack dims sit before the batch dim: never shard
            # them (caches always carry a stacked-layer dim 0)
            and (i > bi if bi is not None else i >= 1)
        ]
        if cands:
            _, mi = max(cands)
            s[mi] = "model"
        return tuple(s)

    return _map_with_path(spec, cache)


def local_shard(tree, spec_tree, mesh):
    """This rank's block of every leaf of ``tree`` under ``spec_tree`` (a
    matching tree of specs): each dim a spec puts on mesh axes is cut to
    the rank's contiguous block along them, the other dims kept whole.  The
    port's counterpart of placing an array under a ``NamedSharding`` — what
    a rank keeps of a tree every rank holds whole."""

    def cut(leaf, spec):
        index = []
        for dim, axes in enumerate(spec):
            if axes is None:
                index.append(slice(None))
                continue
            k, i = mesh.axis_size(axes), mesh.axis_index(axes)
            if leaf.shape[dim] % k:
                raise ValueError(f"dim {dim} of size {leaf.shape[dim]} does not "
                                 f"divide over {k} ranks of {axes}")
            size = leaf.shape[dim] // k
            index.append(slice(i * size, (i + 1) * size))
        return leaf[tuple(index)]

    def walk(node, spec):
        if isinstance(node, dict):
            return {k: walk(v, spec[k]) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            out = [walk(v, s) for v, s in zip(node, spec)]
            return out if isinstance(node, list) else tuple(out)
        return cut(node, spec)

    return walk(tree, spec_tree)


def _placements(spec: tuple, mesh) -> tuple:
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for axis in mesh.axis_names:
        dims = [i for i, e in enumerate(spec)
                if e == axis or (isinstance(e, tuple) and axis in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def to_shardings(spec_tree, mesh):
    """Each spec of a spec tree as ``torch.distributed.tensor`` placements:
    one per mesh axis, in ``mesh.axis_names`` order — ``Shard(dim)`` where
    the spec puts that axis on ``dim``, else ``Replicate()``."""

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return _placements(node, mesh)

    return walk(spec_tree)
