"""Multi-process runtime: one SPMD program over several processes.

Counterpart of :mod:`comms_tpu.parallel.multihost`, on
``torch.distributed`` with the gloo backend.  ``init()`` joins the
process group (env-driven, as ``torchrun`` sets ``MASTER_ADDR``,
``MASTER_PORT``, ``RANK`` and ``WORLD_SIZE``; or with an explicit
coordinator for manual bring-up), :func:`pod_mesh` builds the time mesh
over every shard of every process (:func:`process_mesh` a mesh of any
shape, as ``wideband2d.mesh_2d`` lays its grid), and :func:`host_feed`
turns each process's locally read block into one global sharded value,
with no bytes moved between processes (each process's chunk must be its
time slice).

Each process is one rank with its own CUDA context.  Its shards lie on
``cuda:(rank % device_count)``: on a machine with one card every process
shares it (the kernels of the contexts then run by time-slicing, so two
processes on one card record the overhead of the multi-process route,
not a speed-up); with one card a process they spread over the cards.
The halo exchanges and the all-to-alls between processes go through the
ring kernel into windows of the neighbour's memory mapped through CUDA
IPC (:mod:`comms_tpu_torch.kernels.halo_ring`); the sums and gathers
through gloo on host tensors (:mod:`.sharding`).  NCCL is not used: it
refuses two ranks on one card.  The group's timeout is short (a minute,
:data:`TIMEOUT_S`), so a dead peer fails a run instead of hanging it.

    torchrun --nproc-per-node 2 my_program.py     # env-driven init()

or in each process ``init("127.0.0.1:29500", num_processes=2,
process_id=rank)``.  :func:`shutdown` releases the IPC windows and
leaves the group.
"""

from __future__ import annotations

import datetime
import math
from typing import Optional

import torch
import torch.distributed as dist

from comms_tpu_torch.kernels import halo_ring as _HR
from comms_tpu_torch.parallel import sharding as sh

__all__ = ["init", "pod_mesh", "process_mesh", "host_feed",
           "is_coordinator"]

TIMEOUT_S = 60.0


def init(coordinator_address: Optional[str] = None,
         num_processes: Optional[int] = None,
         process_id: Optional[int] = None) -> None:
    """Join the process group (gloo).  Without arguments the environment
    names the coordinator and this process's place (``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, as ``torchrun`` sets them);
    with them, ``coordinator_address`` is ``host:port`` of rank 0.
    Idempotent: a call in a process that has joined returns.  The group's
    timeout is :data:`TIMEOUT_S`."""
    if dist.is_initialized():
        return
    timeout = datetime.timedelta(seconds=TIMEOUT_S)
    if coordinator_address is None:
        dist.init_process_group(backend="gloo", init_method="env://",
                                timeout=timeout)
        return
    if num_processes is None or process_id is None:
        raise ValueError("an explicit coordinator needs num_processes and "
                         "process_id")
    dist.init_process_group(backend="gloo",
                            init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes),
                            rank=int(process_id), timeout=timeout)


def shutdown() -> None:
    """Release the halo windows (every process closes its mappings before
    any frees its own) and leave the process group."""
    if not dist.is_initialized():
        return
    _HR.release_windows(barrier=True)
    dist.destroy_process_group()


def _world():
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def is_coordinator() -> bool:
    """Rank 0 (True before :func:`init`)."""
    return _world()[1] == 0


def process_mesh(shape, axis_names, device="cuda") -> sh.Mesh:
    """A mesh of ``shape`` (named ``axis_names``) over every process of
    the group, in rank order: each of the W processes owns size / W
    shards, contiguous in row-major shard order (the counterpart of a JAX
    mesh laid over ``jax.devices()``'s global list), process r's on
    ``cuda:(r % device_count)`` (or the CPU with ``device="cpu"``).
    Raises where W does not divide the shards.  Before :func:`init`, the
    one-process mesh with every shard on ``device``."""
    world, rank = _world()
    sizes = tuple(int(n) for n in shape)
    size = math.prod(sizes)
    if size < 1:
        raise ValueError(f"a mesh needs at least one shard, got {sizes}")
    if size % world:
        raise ValueError(f"a mesh of {size} shards does not divide over "
                         f"{world} processes")
    per = size // world
    kind = torch.device(device).type
    if kind == "cuda":
        count = torch.cuda.device_count()
        if count < 1:
            raise RuntimeError("a mesh on device='cuda' needs a CUDA device")
        if world > 1:
            torch.cuda.set_device(rank % count)
            devs = [f"cuda:{s // per % count}" for s in range(size)]
        else:
            devs = [device] * size
    elif kind == "cpu":
        devs = ["cpu"] * size
    else:
        raise ValueError(f"a mesh lies on CUDA or CPU devices, got {device}")
    return sh.Mesh(devs, sizes, axis_names,
                   owners=[s // per for s in range(size)], rank=rank)


def pod_mesh(name: str = "time", local_shards: int = 1,
             device="cuda") -> sh.Mesh:
    """1-D mesh over every shard of every process, in rank order:
    ``local_shards`` shards a process (the counterpart of each JAX
    process's device count), process r's on ``cuda:(r % device_count)``
    (or the CPU with ``device="cpu"``).  Before :func:`init`, the
    one-process mesh of ``local_shards`` shards."""
    n = int(local_shards)
    if n < 1:
        raise ValueError(f"a process needs at least one shard, got {n}")
    return process_mesh((_world()[0] * n,), (name,), device)


def host_feed(local_block, mesh: sh.Mesh, axis="time") -> sh.Sharded:
    """The global sharded value of each process's local blocks.

    Each process reads its own slice of the stream (its part of the
    global block, in time order by rank) and calls this with the local
    ``[n_local, ...]`` block (a tensor or a numpy array); the result is
    one :class:`~comms_tpu_torch.parallel.sharding.Sharded` value of
    global shape ``[n_local * processes, ...]`` laid out over ``axis``,
    this process's chunks on its shards' device.  ``axis`` names the one
    axis of a 1-D mesh or a tuple of axes whose flattened ring is the
    whole mesh in shard order (``("time", "chan")`` on ``mesh_2d``, as
    JAX's ``P(("time", "chan"))``).  No bytes cross between processes."""
    x = torch.as_tensor(local_block)
    n_dev = len(mesh.local)
    if x.shape[0] % n_dev:
        raise ValueError(
            f"local block length {x.shape[0]} must divide evenly over "
            f"{n_dev} local devices")
    if mesh.axis_size(axis) != mesh.size:
        raise ValueError(f"host_feed lays a block over a 1-D mesh; "
                         f"{mesh.shape} has more axes than {axis!r}")
    if mesh.rings(axis)[0] != list(range(mesh.size)):
        raise ValueError(f"the flattened ring over {axis!r} is not the "
                         f"mesh's shard order: its processes' slices would "
                         f"not be contiguous")
    chunks = torch.tensor_split(x, n_dev, dim=0)
    shards = [c.to(mesh.devices[s]) for c, s in zip(chunks, mesh.local)]
    procs = mesh.size // n_dev
    return sh.Sharded(shards, (x.shape[0] * procs,) + tuple(x.shape[1:]),
                      mesh, (axis,))
