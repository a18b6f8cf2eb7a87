"""Ring-sharded appearance-gallery scoring (counterpart of ``parallel/ring.py``).

A long-horizon re-ID memory (every appearance of every lost track over a
drive) can outgrow one card. So the gallery is sharded over the mesh's data
axis, and so are the queries. Each rank keeps its gallery shard; the query
blocks travel around the ring. At each of ``world`` steps a rank scores the
visiting block against its own shard, keeps the running best, and passes
the block with its ``best_sim`` and ``best_idx`` on to rank + 1
(``dist.batch_isend_irecv``). After ``world`` steps every block is home
with its best over the whole gallery, and the per-query results are
gathered so that every rank returns the global answer, as JAX's call does.
Only (Q/world, E)-sized blocks cross; no rank holds the (Q, N) matrix.

JAX's rules are kept: invalid gallery entries score -2, which stands for
"nothing valid" (index -1); only a strictly larger score takes over the
best; the index is global (argmax in the shard plus ``rank * shard_size``);
and the visiting order is JAX's, a block starting at its own rank's shard.
So under exact ties the first shard visited wins, not the lowest index, and
the answer depends on the number of shards, as in JAX. At a world of one the
ring is the local product. The product is ``torch.matmul``: JAX leaves it to
XLA, outside any Pallas kernel.
"""
from __future__ import annotations

from typing import List, Tuple

import torch
import torch.distributed as dist

from waymo_2d_tracking_tpu_torch.parallel.collectives import all_gather_rows
from waymo_2d_tracking_tpu_torch.parallel.sharding import (
    check_mesh,
    data_group,
    data_index,
    data_size,
    shard_batch,
)

NOTHING = -2.0


def _pass_on(tensors: List[torch.Tensor], group, nxt: int, prv: int) -> List[torch.Tensor]:
    """Send ``tensors`` to rank ``nxt`` and receive their counterparts from
    ``prv`` (global ranks), in one batch of point-to-point ops."""
    # gloo's send and recv read host pointers (on the card a CUDA tensor gives
    # "Bad address"; its collectives take CUDA tensors): copy to the host and back
    host = dist.get_backend(group) == "gloo"
    out = [t.cpu() if host else t.contiguous() for t in tensors]
    into = [torch.empty_like(t) for t in out]
    ops = ([dist.P2POp(dist.isend, t, nxt, group, tag=i) for i, t in enumerate(out)]
           + [dist.P2POp(dist.irecv, t, prv, group, tag=i) for i, t in enumerate(into)])
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return [r.to(t.device) for r, t in zip(into, tensors)]


def ring_score_local(block: torch.Tensor, gallery_shard: torch.Tensor,
                     valid_shard: torch.Tensor, mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """A rank's part: its query block (Q_local, E) against the whole gallery
    around the ring, its own shard (S, E) with ``valid_shard`` (S,) resident.
    Returns (best_sim (Q_local,) float32, best_idx (Q_local,) int32, global
    gallery indices)."""
    group = data_group(mesh)
    n, me = data_size(mesh), data_index(mesh)
    nxt = dist.get_global_rank(group, (me + 1) % n)
    prv = dist.get_global_rank(group, (me - 1) % n)
    shard_size = gallery_shard.shape[0]
    q = block.shape[0]
    best_sim = torch.full((q,), NOTHING, dtype=torch.float32, device=block.device)
    best_idx = torch.full((q,), -1, dtype=torch.int32, device=block.device)
    for _ in range(n):
        # the block here now started at rank (me - step) mod n
        sims = torch.matmul(block, gallery_shard.T)
        sims = torch.where(valid_shard[None, :], sims, torch.full_like(sims, NOTHING))
        local_best = sims.amax(dim=1)
        local_arg = (torch.argmax(sims, dim=1) + me * shard_size).to(torch.int32)
        take = local_best > best_sim
        best_sim = torch.where(take, local_best, best_sim)
        best_idx = torch.where(take, local_arg, best_idx)
        if n > 1:
            block, best_sim, best_idx = _pass_on([block, best_sim, best_idx], group, nxt, prv)
    return best_sim, best_idx


def ring_gallery_topmatch(queries: torch.Tensor, gallery: torch.Tensor,
                          gallery_valid: torch.Tensor, mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """Best cosine match of each query against the ring-sharded gallery.

    queries (Q, E) and gallery (N, E), L2-normalised, Q and N divisible by
    the data axis size, gallery_valid (N,) bool: the same on every rank,
    which keeps only its shards. Returns (best_sim (Q,), best_idx (Q,)) on
    every rank, best_idx indexing the global gallery, -1 where nothing valid
    was seen."""
    mesh = check_mesh(mesh)
    block, shard, valid = shard_batch(
        [torch.as_tensor(queries).float(), torch.as_tensor(gallery).float(),
         torch.as_tensor(gallery_valid).bool()], mesh)
    best_sim, best_idx = ring_score_local(block, shard, valid, mesh)
    group = data_group(mesh)
    best_sim = all_gather_rows(best_sim, group)
    best_idx = all_gather_rows(best_idx, group)
    best_idx = torch.where(best_sim <= NOTHING, torch.full_like(best_idx, -1), best_idx)
    return best_sim, best_idx
