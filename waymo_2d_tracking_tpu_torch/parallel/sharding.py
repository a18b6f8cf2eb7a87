"""Process groups, the device mesh and batch sharding (counterpart of
``parallel/sharding.py``), on ``torch.distributed``.

The JAX package drives every chip from one process through a
``jax.sharding.Mesh``. The port takes PyTorch's own idiom: one process a
card, a *rank*, all of them joined in one process group. ``make_mesh``
returns a ``DeviceMesh`` of shape (data, model) over the group's ranks,
``model_parallel == 1`` being pure data parallelism, as in JAX.

The backend is chosen by the caller, never by a fallback: NCCL for CUDA
devices, gloo for the CPU, or gloo for CUDA devices when asked for. NCCL takes
one rank a card, so two ranks that share a card are refused under NCCL
before any communicator is made (they talk over gloo instead). A rank's
device is ``cuda:{local_rank % device_count}``. Every process group has a
timeout.

With no process group yet, ``make_mesh`` makes a world of one on this
process's device, so a sharded path on one card is the unsharded path, as a
one-chip JAX mesh is.
"""
from __future__ import annotations

import datetime
import socket
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from waymo_2d_tracking_tpu_torch import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
BACKENDS = ("nccl", "gloo")
DEFAULT_TIMEOUT = datetime.timedelta(seconds=300)


def rank_device(device="cuda", local_rank: int = 0) -> torch.device:
    """The device of a rank: ``cuda:{local_rank % device_count}``, or the CPU
    when ``device`` names it. Raises for CUDA without a card."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    return dev


def default_backend(device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def check_devices(store, rank: int, world_size: int, device: torch.device, backend: str) -> None:
    """Every rank posts its (host, device) in the rendezvous store and reads
    the others'; under NCCL two ranks on one device raise, on every rank,
    before a communicator exists."""
    store.set(f"w2t/device/{rank}", f"{socket.gethostname()}/{device}")
    seen = [store.get(f"w2t/device/{r}").decode() for r in range(world_size)]
    if backend == "nccl" and len(set(seen)) < world_size:
        shared = sorted({d for d in seen if seen.count(d) > 1})
        raise ValueError(
            f"NCCL takes one rank a device, but ranks share {shared}; ranks on "
            "one card talk over backend='gloo'")


def init_process_group(rank: int, world_size: int, device="cuda", backend: Optional[str] = None,
                       store=None, init_method: Optional[str] = None,
                       timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> torch.device:
    """Join this process to the group as ``rank`` of ``world_size`` on
    ``device`` (``rank_device`` of it) and return the device. The rendezvous
    is ``store`` (e.g. a ``FileStore``) or ``init_method`` (``tcp://host:port``,
    ``file://path``); ``backend`` defaults to ``default_backend(device)``."""
    dev = rank_device(device, rank)
    backend = backend or default_backend(dev)
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("backend='nccl' needs CUDA devices; the CPU uses backend='gloo'")
    if store is None:
        if init_method is None:
            raise ValueError("give a rendezvous: store= or init_method=")
        store, _, _ = next(dist.rendezvous(init_method, rank, world_size, timeout=timeout))
    store.set_timeout(timeout)
    check_devices(store, rank, world_size, dev, backend)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world_size,
                            timeout=timeout)
    return dev


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1, device="cuda",
              backend: Optional[str] = None,
              timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> DeviceMesh:
    """``DeviceMesh`` of shape (world // model_parallel, model_parallel)
    named (data, model) over the process group; ``model_parallel=1`` is pure
    data parallelism. Without a process group, a world of one on this
    process's ``device``. ``n_devices`` names the world size the caller
    expects (a launch fixes it, so it cannot cut the world)."""
    if not dist.is_initialized():
        init_process_group(0, 1, device=device, backend=backend, store=dist.HashStore(),
                           timeout=timeout)
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"n_devices={n_devices}, but the process group has {world} ranks")
    if world % model_parallel:
        raise ValueError(f"{world} devices not divisible by model_parallel={model_parallel}")
    dev_type = resolve_device(device).type
    grid = torch.arange(world).reshape(world // model_parallel, model_parallel)
    return DeviceMesh(dev_type, grid, mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def check_mesh(mesh) -> DeviceMesh:
    """``mesh`` if it is a (data, model) ``DeviceMesh``; raises otherwise."""
    if not isinstance(mesh, DeviceMesh) or mesh.mesh_dim_names != (DATA_AXIS, MODEL_AXIS):
        raise TypeError(f"mesh must be a DeviceMesh named ({DATA_AXIS!r}, {MODEL_AXIS!r}) "
                        f"from parallel.sharding.make_mesh, got {type(mesh).__name__}")
    return mesh


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device in ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def data_group(mesh: DeviceMesh):
    """The process group along the data axis that holds this rank."""
    return mesh.get_group(DATA_AXIS)


def data_size(mesh: DeviceMesh) -> int:
    return mesh.size(0)


def data_index(mesh: DeviceMesh) -> int:
    """This rank's coordinate on the data axis."""
    return mesh.get_local_rank(DATA_AXIS)


def model_index(mesh: DeviceMesh) -> int:
    return mesh.get_local_rank(MODEL_AXIS)


def is_writer(mesh: DeviceMesh) -> bool:
    """True on the rank at (data 0, model 0), the one that writes shared files."""
    return dist.get_rank() == int(mesh.mesh[0, 0])


def _rows(x, r: int, d: int, device):
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    n = x.shape[0]
    if n % d:
        raise ValueError(f"leading axis {n} not divisible by the data axis size {d}")
    per = n // d
    return x[r * per:(r + 1) * per].to(device)


def shard_batch(batch, mesh: DeviceMesh):
    """This rank's rows of ``batch`` (a tensor, array, or a dict / list /
    tuple of them) along the data axis, on this rank's device: the JAX
    ``shard_batch`` array's addressable shard on this rank, in the same
    order (rank at data coordinate r holds rows [r*n/d, (r+1)*n/d))."""
    r, d, dev = data_index(mesh), data_size(mesh), mesh_device(mesh)

    def go(x):
        if isinstance(x, dict):
            return {k: go(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(go(v) for v in x)
        return _rows(x, r, d, dev)

    return go(batch)


def _tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def replicate(tree, mesh: DeviceMesh):
    """Broadcast the tensors of ``tree`` (a tensor, or dicts / lists of them,
    e.g. a ``TrainState``'s fields) from the rank at (data 0, model 0) to
    every rank, in place, so every rank holds the same bits. Returns
    ``tree``."""
    src = int(mesh.mesh[0, 0])
    for t in _tensors(tree):
        dist.broadcast(t.detach(), src)
    return tree


def barrier(mesh: DeviceMesh) -> None:
    """Wait for every rank of the mesh."""
    if mesh.device_type == "cuda" and dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()
