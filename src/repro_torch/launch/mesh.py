"""Process meshes: the axes every sharded component agrees on.

The PyTorch counterpart of the JAX package's ``launch/mesh.py``.  There a
mesh is an array of JAX devices; here it is an array of ``torch.distributed``
ranks, laid out row-major over named axes, with the process group over
them.  :class:`Mesh` carries what `sharding/rules.py` reads (``axis_names``,
the ``shape`` dict) and what `fl/ring.py` and `fl/distributed.py` need to
talk (``group``, this rank's coordinates).  Collectives run over every
rank of a mesh: the axes they name must span it.
Three shapes:

* :func:`make_client_mesh` — the federated mesh: a 1-D ``("clients",)`` mesh
  where each rank owns a contiguous block of client slots.  This is what
  `build_sharded_scan_round_step` and the ``mesh8_*`` bench scenarios run
  on.
* :func:`make_production_mesh` — the ``(16 data, 16 model)`` mesh of the
  model zoo, optionally ``(2 pod, 16 data, 16 model)``.
* :func:`make_local_mesh` — a small ``(data, model)`` mesh (tests).

A :class:`MeshShape` is a mesh's axes and shape without ranks, for planning
a layout in one process (``make_production_mesh(shape_only=True)``).

Every mesh is built over the default process group, which the caller
initialises (``torch.distributed.init_process_group``) with the backend of
its choice — NCCL on GPUs, gloo on the CPU — before the mesh is made; every
rank of the world makes the same meshes in the same order.  A process that
initialised no group is a world of one rank: a one-rank mesh over it has no
group and its collectives are the identity.  A mesh larger than the world
raises, as the JAX package's does when the host has too few devices.

:func:`run_ranks` starts the ranks of a world on one host (the tests and the
bench CLI use it): one spawned process a rank, joined through a ``file://``
store in a temporary directory, so no port is opened.
"""
from __future__ import annotations

import math
import os
import queue
import shutil
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _world() -> tuple[int, int]:
    """(world size, this process's rank); (1, 0) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class MeshShape:
    """A mesh's named axes and shape, and one rank's place in it, without
    processes: what `sharding/rules.py` reads to resolve and cut layouts.
    The dry run (`launch/dryrun.py`) plans a 256- or 512-rank layout with
    one in one process; ``rank`` picks whose block ``local_shard`` cuts.
    ``group`` is None: it has no collectives."""

    def __init__(self, axis_names: tuple, shape: tuple, *, rank: int = 0):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.size = math.prod(self.shape.values())
        self.rank = rank
        self.group = None

    def coords(self, rank: int | None = None) -> dict:
        """The mesh coordinates of ``rank`` (default: this process)."""
        rank = self.rank if rank is None else rank
        idx = np.unravel_index(rank, tuple(self.shape.values()))
        return dict(zip(self.axis_names, (int(i) for i in idx)))

    def axis_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in _as_axes(axes))

    def axis_index(self, axes) -> int:
        """This rank's row-major index over ``axes`` (the JAX package's
        combined ``axis_index``)."""
        c, idx = self.coords(), 0
        for a in _as_axes(axes):
            idx = idx * self.shape[a] + c[a]
        return idx


class Mesh(MeshShape):
    """Ranks ``0 … size−1`` of the world as a row-major array of ``shape``
    over ``axis_names``.

    ``group`` is the process group over those ranks (None for a one-rank
    mesh in a process without a group).  A rank of the world outside the mesh
    has ``rank`` None and takes no part in its collectives.
    """

    def __init__(self, axis_names: tuple, shape: tuple):
        super().__init__(axis_names, shape)
        world, rank = _world()
        if world < self.size:
            raise RuntimeError(
                f"need {self.size} devices for mesh {tuple(self.shape.values())}, "
                f"have {world} — start {self.size} ranks and call "
                "torch.distributed.init_process_group in each before making the "
                "mesh"
            )
        self.rank = rank if rank < self.size else None
        if not (dist.is_available() and dist.is_initialized()):
            self.group = None  # one rank, no group: collectives are the identity
        elif self.size == world:
            self.group = dist.group.WORLD
        else:
            # a collective call: every rank of the world makes it
            self.group = dist.new_group(ranks=list(range(self.size)))

    def _group(self, axes):
        """The mesh's group, for collectives along ``axes``: the axes must
        span every rank, in the mesh's order (any other axis of size 1), so
        that a rank's index along them is its rank."""
        axes = _as_axes(axes)
        wide = tuple(a for a in self.axis_names if self.shape[a] > 1)
        if tuple(a for a in axes if self.shape[a] > 1) != wide:
            raise ValueError(f"collectives run over every rank of the mesh: axes {axes} "
                             f"do not span {self.shape} in its order")
        return self.group

    # -- collectives along axes (default: all of them), called by every rank
    # of the mesh; the identity on a one-rank mesh without a group

    def all_gather(self, x: torch.Tensor, axes=None) -> torch.Tensor:
        """Every rank's ``x`` along ``axes``, concatenated on dim 0 in index
        order (``all_gather(..., tiled=True)``)."""
        group = self._group(self.axis_names if axes is None else axes)
        if group is None:
            return x
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts)

    def all_reduce(self, x: torch.Tensor, axes=None) -> torch.Tensor:
        """The sum of every rank's ``x`` along ``axes`` (``psum``)."""
        group = self._group(self.axis_names if axes is None else axes)
        if group is None:
            return x
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    def rotate(self, x: torch.Tensor, axes) -> torch.Tensor:
        """Send ``x`` to the next index along ``axes`` and receive the
        previous index's (``ppermute`` by +1); no call on a one-rank axis."""
        k = self.axis_size(axes)
        if k == 1:
            return x
        group, i = self._group(axes), self.rank
        out = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x.contiguous(), (i + 1) % k, group),
               dist.P2POp(dist.irecv, out, (i - 1) % k, group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out


def _as_axes(axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def make_client_mesh(n_devices: int | None = None, *, axis: str = "clients") -> Mesh:
    """1-D mesh over ``n_devices`` ranks (default: the whole world), axis
    named ``"clients"`` — each rank owns one shard of the padded client dim.

    The sharded round step requires ``n_clients % n_devices == 0`` (it is
    validated at build time, not here: a mesh is just topology).
    """
    n = _world()[0] if n_devices is None else int(n_devices)
    return Mesh((axis,), (n,))


def make_production_mesh(*, multi_pod: bool = False, shape_only: bool = False) -> Mesh:
    """Single pod: 256 ranks as (16 data, 16 model).  Multi-pod: 2 × 256 as
    (2 pod, 16 data, 16 model); the client axes are ("pod", "data").
    ``shape_only`` gives the layout as a :class:`MeshShape`, without ranks
    (the dry run's)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return MeshShape(axes, shape) if shape_only else Mesh(axes, shape)


def make_local_mesh(data: int = 2, model: int = 2, *, pod: int = 0) -> Mesh:
    """Small mesh over the first ranks of the world (tests)."""
    shape = (pod, data, model) if pod else (data, model)
    axes = ("pod", "data", "model") if pod else ("data", "model")
    return Mesh(axes, shape)


def _rank_entry(fn, rank, world_size, backend, store, num_threads, args, results):
    try:
        if num_threads is not None:
            torch.set_num_threads(num_threads)
        if backend == "nccl":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(backend, init_method=f"file://{store}",
                                world_size=world_size, rank=rank)
        try:
            out = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn, world_size: int, *, backend: str = "gloo", args=(),
              timeout: float = 600.0, num_threads: int | None = None) -> list:
    """Run ``fn(rank, *args)`` on each of ``world_size`` spawned processes
    after ``torch.distributed.init_process_group(backend, ...)`` there, and
    return the results in rank order.

    ``fn`` must be importable by name (a module-level function) and return
    picklable host objects (numpy arrays, not tensors).  ``backend`` is the
    caller's choice: ``"gloo"`` for CPU tensors, ``"nccl"`` for GPUs (rank r
    on card r mod the card count).  ``num_threads`` sets each rank's torch
    CPU threads.  A rank that raises, dies, or outlives ``timeout`` seconds
    makes this raise after every rank has been stopped.
    """
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    workdir = tempfile.mkdtemp(prefix="repro_torch_ranks_")
    store = os.path.join(workdir, "store")
    procs = [ctx.Process(target=_rank_entry, daemon=True,
                         args=(fn, r, world_size, backend, store, num_threads, args, results))
             for r in range(world_size)]
    out: dict = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        # drain the queue before joining: a child blocks on exit until its
        # queued result has been read
        while len(out) < world_size:
            if time.monotonic() > deadline:
                raise TimeoutError(f"ranks {sorted(set(range(world_size)) - set(out))} "
                                   f"did not finish within {timeout} s")
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode} and no result")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
        return [out[r] for r in range(world_size)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        results.close()
        shutil.rmtree(workdir, ignore_errors=True)
