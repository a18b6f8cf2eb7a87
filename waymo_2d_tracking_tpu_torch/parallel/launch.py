"""Start ranks on one host and collect what they return.

``run_ranks(fn, world, *args)`` starts ``world`` processes with ``spawn``
(a forked child cannot use CUDA), joins each to one process group over a
``FileStore`` in a fresh directory (no port to race for), calls
``fn(rank, world, *args)`` in each and returns the ranks' results in rank
order. ``fn`` must be importable by name (a module-level function). With
``join=False`` the ranks join no group and ``fn`` does (e.g. through the
``W2T_*`` variables of ``parallel/multihost.py``).

No wait is open-ended: the group has a timeout, and the parent joins its
ranks within ``timeout`` seconds of its own. A rank that raises ends the
run: the parent terminates the other ranks and raises the rank's error, so
no rank is left waiting in a collective. On one card, several ranks share
``cuda:0`` and talk over gloo (``parallel/sharding.py``).
"""
from __future__ import annotations

import datetime
import os
import shutil
import tempfile
import time
from typing import Callable, List, Optional

import torch
import torch.multiprocessing as mp


def _rank_main(rank: int, fn: Callable, world: int, workdir: str, device: str,
               backend: Optional[str], timeout_s: float, threads: Optional[int], join: bool,
               args) -> None:
    import torch.distributed as dist

    from waymo_2d_tracking_tpu_torch.parallel.sharding import init_process_group

    if threads:
        torch.set_num_threads(threads)
    if join:
        store = dist.FileStore(os.path.join(workdir, "store"), world)
        init_process_group(rank, world, device=device, backend=backend, store=store,
                           timeout=datetime.timedelta(seconds=timeout_s))
    try:
        result = fn(rank, world, *args)
        tmp = os.path.join(workdir, f"rank{rank}.tmp")
        torch.save(result, tmp)
        os.replace(tmp, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable, world: int, *args, device: str = "cuda",
              backend: Optional[str] = None, timeout: float = 600.0,
              threads: Optional[int] = None, workdir: Optional[str] = None,
              join: bool = True) -> List:
    """Run ``fn(rank, world, *args)`` in ``world`` spawned ranks on
    ``device`` (each rank ``cuda:{rank % device_count}`` or the CPU) over
    ``backend`` (``parallel.sharding.default_backend`` of the device when
    None); returns each rank's result. ``threads``: ``torch.set_num_threads``
    in every rank. Raises the first rank error, or TimeoutError after
    ``timeout`` seconds."""
    own = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="w2t_ranks_")
    os.makedirs(workdir, exist_ok=True)
    ctx = mp.start_processes(
        _rank_main, args=(fn, world, workdir, device, backend, timeout, threads, join, args),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks of {fn.__name__} still running after "
                                   f"{timeout} s")
        return [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(10)
        if own:
            shutil.rmtree(workdir, ignore_errors=True)
