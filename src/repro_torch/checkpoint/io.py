"""Checkpointing: pytree <-> npz with '/'-joined key paths + JSON metadata.

Saves the PS global model, server-optimizer state and round counter so FL
training is resumable; restore round-trips exact dtypes/shapes.

Two layers:

* :func:`save` / :func:`restore` — one pytree ⇄ one atomic ``.npz``
  (tmp-file + ``os.replace``, so a crash mid-write leaves the previous
  snapshot intact) with an optional ``.meta.json`` sidecar.
* The **training-state layer** — :func:`save_training_state` /
  :func:`restore_training_state` bundle the full resumable state (params,
  optional server-optimizer state, the ``torch.Generator`` state and the
  round counter), and :func:`publish` / :func:`latest_checkpoint` add the
  continuous-training rotation: numbered ``ckpt_<round>.npz`` snapshots, an
  atomically-replaced ``LATEST`` pointer file, and keep-last-k pruning.  The
  serving loop (``repro_torch.launch.serve``) polls ``LATEST`` and reloads
  on change.

The file layout is the JAX package's, so each package restores the other's
params: an npz key is the leaf's path, a dict key or a list/tuple index at
each level, joined by '/' (dict keys sorted, as ``jax.tree_util`` flattens
them); a bf16 leaf is stored as its ``uint16`` bits under the ``__bf16__:``
prefix (npz has no bf16).  One field differs on purpose: the JAX package
stores its threefry key's data as ``rng_key``; this package stores
``torch.Generator.get_state()`` as a ``uint8`` array under ``rng_state`` and
names the generator's device in the sidecar (``"rng": {"impl": "torch",
"device": ...}``).  A threefry key cannot seed a torch generator, so
:func:`restore_training_state` refuses a JAX snapshot; its params still
load through ``restore(path, {"params": like})``.

Resuming mid-run is bitwise (``tests/test_torch_checkpoint.py``): restore
the state, rebuild the schedule/policy/batch stream from their seeds and
advance them to the saved round, and the continued trajectory equals the
uninterrupted one — params, metrics, and final generator state.
"""
from __future__ import annotations

import json
import os
import tempfile

import numpy as np
import torch

from repro_torch.utils import tree_flatten, tree_unflatten

_BF16_PREFIX = "__bf16__:"  # npz cannot store bfloat16 natively
_LATEST = "LATEST"
_RNG = "rng_state"


def _key_paths(tree) -> list[str]:
    """Each leaf's npz key, in ``tree_flatten`` order: the dict keys (sorted)
    and list/tuple indices on its path, '/'-joined."""
    keys: list[str] = []

    def walk(node, path):
        if node is None:
            return
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (str(k),))
        elif isinstance(node, (list, tuple)):
            for i, child in enumerate(node):
                walk(child, path + (str(i),))
        else:
            keys.append("/".join(path))

    walk(tree, ())
    return keys


def _to_numpy(leaf) -> tuple[str, np.ndarray]:
    """(key prefix, host array) of one leaf; a bf16 tensor becomes its
    ``uint16`` bits under the bf16 prefix."""
    if not isinstance(leaf, torch.Tensor):
        return "", np.asarray(leaf)
    leaf = leaf.detach().cpu()
    if leaf.dtype == torch.bfloat16:
        return _BF16_PREFIX, leaf.view(torch.int16).numpy().view(np.uint16)
    return "", leaf.numpy()


def _flatten(tree) -> dict[str, np.ndarray]:
    flat = {}
    for key, leaf in zip(_key_paths(tree), tree_flatten(tree)[0]):
        prefix, arr = _to_numpy(leaf)
        flat[prefix + key] = arr
    return flat


def save(path: str, tree, *, metadata: dict | None = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = _flatten(tree)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".", suffix=".tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, path)  # atomic
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    if metadata is not None:
        with open(path + ".meta.json", "w") as f:
            json.dump(metadata, f, indent=2)


def restore(path: str, like):
    """Restore into the structure of ``like`` (shapes validated).  Each leaf
    comes back a tensor on the device and in the dtype of ``like``'s leaf (a
    numpy leaf of ``like`` gives a CPU tensor)."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    leaves, treedef = tree_flatten(like)
    out = []
    for key, leaf in zip(_key_paths(like), leaves):
        leaf = torch.as_tensor(leaf)
        if _BF16_PREFIX + key in flat:
            arr = torch.from_numpy(flat[_BF16_PREFIX + key].view(np.int16)).view(torch.bfloat16)
        elif key in flat:
            arr = torch.from_numpy(flat[key])
        else:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: shape {tuple(arr.shape)} != expected {tuple(leaf.shape)}")
        out.append(arr.to(device=leaf.device, dtype=leaf.dtype))
    return tree_unflatten(treedef, out)


def load_metadata(path: str) -> dict:
    with open(path + ".meta.json") as f:
        return json.load(f)


# --------------------------------------------------------------------------
# Training-state layer: full resumable state + the latest-pointer rotation
# --------------------------------------------------------------------------


def save_training_state(path: str, *, params, server_state, generator: torch.Generator,
                        round: int, metadata: dict | None = None) -> None:
    """Save the full resumable state as one atomic snapshot.

    ``server_state`` may be None (momentum-free server optimizer) — recorded
    in the metadata so restore knows the expected structure.  ``generator``
    is the live τ generator; its state round-trips bit-exactly, and its
    device is recorded so that restore rebuilds it there.
    """
    tree = {"params": params, _RNG: generator.get_state()}
    if server_state is not None:
        tree["server_state"] = server_state
    meta = dict(metadata or {})
    meta.update({
        "round": int(round),
        "has_server_state": server_state is not None,
        "rng": {"impl": "torch", "device": str(generator.device)},
    })
    save(path, tree, metadata=meta)


def restore_training_state(path: str, *, params_like, server_state_like=None):
    """Restore a :func:`save_training_state` snapshot.

    Returns ``(params, server_state, generator, round)``; the generator is
    a new ``torch.Generator`` on the saved one's device, in its state.
    ``server_state_like`` is required exactly when the snapshot carries one
    (build it with ``server_opt.init(params_like)``); a momentum-free
    snapshot returns ``server_state=None``.
    """
    meta = load_metadata(path)
    rng = meta.get("rng", {})
    if rng.get("impl") != "torch":
        raise ValueError(
            f"{path} stores its RNG as 'rng_key', the JAX package's threefry "
            "key data: a threefry key cannot seed a torch.Generator.  Restore "
            "the params alone with restore(path, {'params': like})"
        )
    generator = torch.Generator(device=rng["device"])
    like = {"params": params_like, _RNG: generator.get_state()}
    if meta["has_server_state"]:
        if server_state_like is None:
            raise ValueError(
                f"{path} carries a server-optimizer state: pass "
                "server_state_like (e.g. server_opt.init(params_like))"
            )
        like["server_state"] = server_state_like
    tree = restore(path, like)
    generator.set_state(tree[_RNG])
    return (
        tree["params"],
        tree.get("server_state"),
        generator,
        int(meta["round"]),
    )


def _ckpt_name(round: int) -> str:
    return f"ckpt_{int(round):08d}.npz"


def publish(directory: str, *, params, server_state, generator: torch.Generator,
            round: int, keep: int = 3, metadata: dict | None = None) -> str:
    """Publish one training-state snapshot into ``directory`` and rotate the
    ``LATEST`` pointer atomically (tmp + ``os.replace``): a reader polling
    :func:`latest_checkpoint` sees either the previous snapshot or the new
    one, never a torn state.  Keeps the newest ``keep`` snapshots (0 ⇒ keep
    everything).  Returns the snapshot path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, _ckpt_name(round))
    save_training_state(
        path, params=params, server_state=server_state, generator=generator,
        round=round, metadata=metadata,
    )
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(os.path.basename(path) + "\n")
        os.replace(tmp, os.path.join(directory, _LATEST))  # atomic
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    if keep > 0:
        _prune(directory, keep=keep, current=os.path.basename(path))
    return path


def latest_checkpoint(directory: str) -> str | None:
    """The snapshot the ``LATEST`` pointer names, or None when the directory
    holds no published snapshot (missing pointer, or pointer to a snapshot
    already pruned away)."""
    pointer = os.path.join(directory, _LATEST)
    try:
        with open(pointer) as f:
            name = f.read().strip()
    except FileNotFoundError:
        return None
    path = os.path.join(directory, name)
    return path if name and os.path.exists(path) else None


def _prune(directory: str, *, keep: int, current: str) -> None:
    """Drop all but the newest ``keep`` numbered snapshots (and their
    sidecars).  The pointed-at snapshot is never pruned."""
    snaps = sorted(
        f for f in os.listdir(directory)
        if f.startswith("ckpt_") and f.endswith(".npz")
    )
    for name in snaps[:-keep]:
        if name == current:
            continue
        for victim in (name, name + ".meta.json"):
            full = os.path.join(directory, victim)
            if os.path.exists(full):
                os.unlink(full)
