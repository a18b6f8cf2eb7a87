"""Several processes, on one host or many (counterpart of
``parallel/multihost.py``).

The JAX package starts one process a host with ``jax.distributed`` and
drives each host's chips from it. The port starts one process a card. Each
reads the same variables:

- ``W2T_COORDINATOR``: ``host:port`` where process 0 listens (TCP);
- ``W2T_NUM_PROCESSES``: the number of processes, one a card in all;
- ``W2T_PROCESS_ID``: this process's rank, 0 .. N-1, hosts in order, so the
  data axis is process-major as in JAX;
- ``W2T_BACKEND`` (optional): ``nccl`` or ``gloo``. Without it the backend
  follows the device the caller gives: NCCL for CUDA, gloo for the CPU.

A process takes ``cuda:{W2T_PROCESS_ID % device_count}``. Call
:func:`initialize_multihost` once before any collective, then build the mesh
with :func:`make_global_mesh`. Without the variables nothing happens, and
single-process runs are unchanged.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

from waymo_2d_tracking_tpu_torch.parallel.sharding import (
    DEFAULT_TIMEOUT,
    init_process_group,
    make_mesh,
)

_ENV_COORD = "W2T_COORDINATOR"       # host:port of process 0
_ENV_NPROC = "W2T_NUM_PROCESSES"
_ENV_PID = "W2T_PROCESS_ID"
_ENV_BACKEND = "W2T_BACKEND"


def initialize_multihost(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, device="cuda",
                         backend: Optional[str] = None,
                         timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> bool:
    """Join the process group from the arguments or the ``W2T_*`` variables
    (TCP rendezvous at the coordinator, with ``timeout``). Returns True when
    it did, False (doing nothing) when neither names a coordinator."""
    coordinator = coordinator or os.environ.get(_ENV_COORD)
    if coordinator is None:
        return False
    num_processes = int(num_processes or os.environ[_ENV_NPROC])
    process_id = int(process_id if process_id is not None else os.environ[_ENV_PID])
    init_process_group(process_id, num_processes, device=device,
                       backend=backend or os.environ.get(_ENV_BACKEND),
                       init_method=f"tcp://{coordinator}", timeout=timeout)
    return True


def make_global_mesh(model_parallel: int = 1, device="cuda"):
    """The (data, model) mesh over every process of the group."""
    return make_mesh(model_parallel=model_parallel, device=device)
