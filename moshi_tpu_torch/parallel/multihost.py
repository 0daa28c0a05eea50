"""Several processes, one mesh: initialization and session routing.

Counterpart of ``moshi_tpu/parallel/multihost.py``.  Every process runs
the same program under ``torch.distributed``: ``initialize`` joins the
process group, ``global_mesh`` lays all its ranks out as (data, model),
and each process feeds and reads its rows of the session batch
(``local_batch_slice``).  A process is one rank (the JAX package's
process drives all its host's devices).

Usage (one process per rank):
    from moshi_tpu_torch.parallel import multihost
    multihost.initialize("localhost:29500", num_processes=2, process_id=i)
    mesh = multihost.global_mesh(model=1)     # data axis = the rest
    # shard params/state with parallel.sharding's specs, then serve
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from moshi_tpu_torch.parallel.mesh import TIMEOUT, Mesh
from moshi_tpu_torch.parallel.sharding import make_mesh


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None):
    """``dist.init_process_group``.  ``coordinator`` is an init method
    (``tcp://host:port``, ``file:///path``; a bare ``host:port`` means
    tcp), with the world's size and this process's rank; without it the
    environment's (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
    ``WORLD_SIZE``, as ``torchrun`` sets them) are read, and where there
    are none the run stays a single process.  ``backend``: "nccl" by
    default where a card is available, else "gloo" (several ranks on one
    card need "gloo": NCCL refuses two ranks on one device).  A process
    already initialized is left as it is."""
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if coordinator is not None:
        method = coordinator if "://" in coordinator else \
            f"tcp://{coordinator}"
        dist.init_process_group(backend, init_method=method,
                                world_size=num_processes, rank=process_id,
                                timeout=TIMEOUT)
        return
    try:
        dist.init_process_group(backend, timeout=TIMEOUT)
    except (ValueError, RuntimeError, KeyError):
        pass  # no cluster in the environment: a single-process run


def global_mesh(model: int = 1) -> Mesh:
    """(data, model) over every rank of the world (data = the rest); every
    rank calls it."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if n % model:
        raise ValueError(f"{n} ranks not divisible by model={model}")
    return make_mesh(data=n // model, model=model)


def local_batch_slice(global_batch: int, mesh: Optional[Mesh] = None) -> slice:
    """The rows of the global session batch this process owns: its
    share of an even split over the processes (the JAX package's rule),
    or, given ``mesh``, over its ``data`` axis (the rows the ranks of a
    model group share)."""
    if mesh is not None:
        per = global_batch // mesh.shape["data"]
        i = mesh.index("data")
    else:
        world = dist.get_world_size() if dist.is_initialized() else 1
        per = global_batch // world
        i = dist.get_rank() if dist.is_initialized() else 0
    return slice(i * per, (i + 1) * per)
