"""The port's device mesh and its collectives, on ``torch.distributed``.

The counterpart of ``jax.sharding.Mesh`` and of the collectives the JAX
package's ``shard_map`` bodies call (``jax.lax.psum``,
``all_gather(tiled=True)``, ``ppermute``; ``axis_index`` is
``Mesh.index``).  Every other
module of ``parallel/`` reaches the processes through this one.

A rank is one process (or, in the CPU tests, one thread with process
groups of its own).  A ``Mesh`` names its axes and their sizes, lays the
ranks out row-major over them, and holds this rank's coordinates and one
process group per axis: the ranks that differ from it along that axis
only, ordered by their index on it, so that a group's rank is the axis
index.  ``build_mesh`` builds the groups with ``dist.new_group``, which
every rank of the world calls for every group, members or not; a rank
outside the mesh gets a mesh it is not a ``member`` of.

Transport moves raw bytes (every tensor viewed as uint8), so no backend
sees a dtype it may lack (bf16, fp8).  Gloo takes CPU tensors only for
all-gather and send/recv, so on a gloo mesh a card's tensor is staged
through host memory: copied to the host, exchanged, copied back (the only
backend that runs several ranks on one card; NCCL refuses two ranks on
one device).  On an NCCL mesh tensors stay on the card.

``psum`` gathers the shards' partials and adds them in rank order on
every rank, in the partials' dtype, so that its bits do not depend on the
backend's reduction: every rank holds the same sum, and a single process
adding the same partials in the same order gets the same bits.

Each mesh counts the collectives it runs in ``counts`` (by kind: psum,
all_gather, ppermute, broadcast), one per call on an axis of size > 1,
and adds the host seconds each call takes to ``seconds`` (on the card,
the wait for the kernels before a staged copy included); both are this
rank's.
"""

from __future__ import annotations

import collections
import contextlib
import datetime
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT = datetime.timedelta(seconds=300)


class Mesh:
    """Axes ``names`` with ``sizes`` over the global ranks ``grid`` (an
    int array of that shape); ``rank`` is this process's global rank and
    ``groups`` maps each axis to this rank's process group along it
    (None on an axis of size 1, or outside the mesh).  ``backend`` is the
    groups' backend ("gloo" or "nccl")."""

    def __init__(self, names: Sequence[str], grid: np.ndarray, rank: int,
                 groups: Dict[str, object], backend: str = "gloo"):
        self.axis_names = tuple(names)
        self.grid = np.asarray(grid)
        assert self.grid.ndim == len(self.axis_names)
        self.rank = int(rank)
        self.groups = dict(groups)
        self.backend = backend
        where = np.argwhere(self.grid == self.rank)
        self.coords = (None if len(where) == 0 else
                       dict(zip(self.axis_names, map(int, where[0]))))
        self.counts: collections.Counter = collections.Counter()
        self.seconds: collections.Counter = collections.Counter()

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, map(int, self.grid.shape)))

    @property
    def member(self) -> bool:
        return self.coords is not None

    def index(self, axis: str) -> int:
        """This rank's index along ``axis`` (``jax.lax.axis_index``)."""
        if self.coords is None:
            raise ValueError(f"rank {self.rank} is not in this mesh")
        return self.coords[axis]

    def __repr__(self):
        return (f"Mesh({self.shape}, rank={self.rank}, "
                f"coords={self.coords}, backend={self.backend!r})")


def _lines(grid: np.ndarray, axis: int):
    """Every line of ``grid`` along ``axis``: the global ranks that share
    all other coordinates, in axis order."""
    moved = np.moveaxis(grid, axis, -1)
    return [tuple(int(r) for r in line)
            for line in moved.reshape(-1, grid.shape[axis])]


def build_mesh(names: Sequence[str], sizes: Sequence[int],
               ranks: Optional[Sequence[int]] = None) -> Mesh:
    """A mesh over the world's ranks ``ranks`` (the first prod(sizes) by
    default), row-major in ``names`` order.  A collective call: every
    rank of the world calls it, in the same order as every other mesh it
    builds.  Without a process group (one process) only a mesh of one
    rank can be built."""
    n = int(np.prod(sizes))
    if not dist.is_initialized():
        if n != 1:
            raise RuntimeError(
                f"a mesh of {n} ranks needs torch.distributed: call "
                f"parallel.multihost.initialize first")
        return Mesh(names, np.zeros(tuple(sizes), np.int64), 0, {})
    world = dist.get_world_size()
    ranks = list(range(n)) if ranks is None else [int(r) for r in ranks]
    if len(ranks) != n or n > world:
        raise ValueError(f"need {n} ranks, have {world} ({ranks})")
    grid = np.asarray(ranks, np.int64).reshape(tuple(sizes))
    me = dist.get_rank()
    groups = {}
    for axis, name in enumerate(names):
        if grid.shape[axis] == 1:
            continue
        for line in _lines(grid, axis):
            pg = dist.new_group(list(line))
            if me in line:
                groups[name] = pg
    return Mesh(names, grid, me, groups, backend=dist.get_backend())


def in_process_mesh(names: Sequence[str], sizes: Sequence[int], rank: int,
                    store, prefix: str = "mesh") -> Mesh:
    """This thread's mesh among ranks that are threads of one process,
    one gloo group per axis line built over ``store`` (a
    ``dist.HashStore`` the threads share): the CPU tests' stand-in for
    processes.  Each thread calls it with its own ``rank``, all at
    once (a group's constructor waits for its members)."""
    grid = np.arange(int(np.prod(sizes))).reshape(tuple(sizes))
    groups = {}
    for axis, name in enumerate(names):
        if grid.shape[axis] == 1:
            continue
        for j, line in enumerate(_lines(grid, axis)):
            if rank in line:
                sub = dist.PrefixStore(f"{prefix}/{name}/{j}", store)
                groups[name] = dist.ProcessGroupGloo(
                    sub, line.index(rank), len(line), TIMEOUT)
    return Mesh(names, grid, rank, groups, backend="gloo")


# ---------------------------------------------------------------------------
# transport: raw bytes, host-staged on a gloo mesh
# ---------------------------------------------------------------------------


def _staged(mesh: Mesh, x: torch.Tensor) -> bool:
    return mesh.backend != "nccl" and x.is_cuda


def _as_bytes(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().reshape(-1).view(torch.uint8)


def _from_bytes(b: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return b.view(like.dtype).reshape(like.shape)


def _group(mesh: Mesh, axis: str):
    pg = mesh.groups.get(axis)
    if pg is None:
        raise ValueError(f"rank {mesh.rank} has no group on axis {axis!r} "
                         f"of {mesh.shape}")
    return pg


@contextlib.contextmanager
def _collective(mesh: Mesh, kind: str):
    """Count one ``kind`` collective and add its host seconds."""
    mesh.counts[kind] += 1
    t0 = time.perf_counter()
    try:
        yield
    finally:
        mesh.seconds[kind] += time.perf_counter() - t0


def gather_parts(mesh: Mesh, axis: str, x: torch.Tensor):
    """Every rank's ``x`` along ``axis`` (same shape and dtype on all),
    as a list in axis order, on ``x``'s device.  Not counted (the
    collectives below count themselves)."""
    if mesh.shape[axis] == 1:
        return [x]
    pg = _group(mesh, axis)
    src = _as_bytes(x.detach())
    if _staged(mesh, x):
        src = src.cpu()
    outs = [torch.empty_like(src) for _ in range(mesh.shape[axis])]
    pg.allgather([outs], [src]).wait()
    return [_from_bytes(o.to(x.device), x) for o in outs]


def all_gather(mesh: Mesh, axis: str, x: torch.Tensor,
               dim: int = -1) -> torch.Tensor:
    """``jax.lax.all_gather(x, axis, axis=dim, tiled=True)``: the ranks'
    ``x`` concatenated along ``dim`` in axis order."""
    if mesh.shape[axis] == 1:
        return x
    with _collective(mesh, "all_gather"):
        return torch.cat(gather_parts(mesh, axis, x), dim=dim)


def psum(mesh: Mesh, axis: str, x: torch.Tensor) -> torch.Tensor:
    """``jax.lax.psum(x, axis)``: the ranks' ``x`` added in axis order, in
    ``x``'s dtype, the same bits on every rank."""
    if mesh.shape[axis] == 1:
        return x
    with _collective(mesh, "psum"):
        parts = gather_parts(mesh, axis, x)
        out = parts[0].clone()
        for p in parts[1:]:
            out += p
    return out


def broadcast(mesh: Mesh, axis: str, x: torch.Tensor,
              src: int) -> torch.Tensor:
    """Rank ``src``'s ``x`` (its index along ``axis``) on every rank of
    the axis; the other ranks' ``x`` gives only the shape and dtype."""
    if mesh.shape[axis] == 1:
        return x
    with _collective(mesh, "broadcast"):
        pg = _group(mesh, axis)
        buf = _as_bytes(x.detach())
        if _staged(mesh, x):
            buf = buf.cpu()
        elif mesh.index(axis) == src:
            buf = buf.clone()
        opts = dist.BroadcastOptions()
        opts.rootRank = int(src)
        opts.rootTensor = 0
        pg.broadcast([buf], opts).wait()
        return _from_bytes(buf.to(x.device), x)


def ppermute(mesh: Mesh, axis: str, x: torch.Tensor,
             perm: Sequence) -> torch.Tensor:
    """``jax.lax.ppermute(x, axis, perm)``: for each (src, dst) pair of
    axis indices, dst receives src's ``x``; a rank no pair sends to gets
    zeros.  Every rank of the axis calls it with the same ``perm``."""
    if mesh.shape[axis] == 1:
        return torch.zeros_like(x)
    with _collective(mesh, "ppermute"):
        pg = _group(mesh, axis)
        me = mesh.index(axis)
        staged = _staged(mesh, x)
        works, recv = [], None
        for src, dst in perm:
            if src == me:
                buf = _as_bytes(x.detach())
                works.append(pg.send([buf.cpu() if staged else buf],
                                     int(dst), 0))
        for src, dst in perm:
            if dst == me:
                recv = torch.empty(x.numel() * x.element_size(),
                                   dtype=torch.uint8,
                                   device="cpu" if staged else x.device)
                works.append(pg.recv([recv], int(src), 0))
        for w in works:
            w.wait()
        if recv is None:
            return torch.zeros_like(x)
        return _from_bytes(recv.to(x.device), x)
