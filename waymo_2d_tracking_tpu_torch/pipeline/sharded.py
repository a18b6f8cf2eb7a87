"""Sharded fan-out of segments and contexts over the ranks (counterpart of
``pipeline/sharded.py``): ``w2t track --sharded``, ``track --multicam
--sharded`` and ``detect --sharded``.

The JAX package runs groups of mesh-size segments in lockstep in one
program, each chip stepping its own segment (``shard_map`` of the chunk
step, zero collectives). The port runs one process a card: the lockstep
groups are formed exactly as in JAX (by source resolution, in stream order,
a bucket flushing when full and at the end of the stream), and the rank at
data coordinate r runs slot r of each group through the port's own
unsharded driver: ``SegmentPipeline.run_segment`` for a segment (its
detections only for ``detect``), ``MultiCamPipeline.run_segments_group`` for
a context. A rank whose slot is empty waits for the group. So each segment's
records and ``.gallery.npz`` sidecar are those of ``run_segments`` by
construction: JAX's padding of a short segment by its last block and its
end-of-segment state snapshots belong to its single lockstep program and
have nothing to do here.

Each rank writes its own segment files. The rank at (data 0, model 0) alone
writes ``manifest.jsonl``: after each group it gathers the group's stats
rows from every rank (JAX's keys, ``shard`` the slot) and appends them in
group order, after the segments' files exist. After a first barrier (every
rank has left any earlier call, one that raised included) the writer alone
reads the done keys and broadcasts them; every rank then walks the same
(lazy) stream and decodes only its own slot; ``fail_after`` raises on every
rank at the same group. Ranks on the model axis other than 0 run nothing:
the axis is reserved, as in JAX.
"""
from __future__ import annotations

import os
from typing import Dict, Iterable, List, Optional

import torch.distributed as dist

from waymo_2d_tracking_tpu_torch.io_out import submission as subm
from waymo_2d_tracking_tpu_torch.parallel.sharding import (
    barrier,
    check_mesh,
    data_index,
    data_size,
    is_writer,
    make_mesh,
    model_index,
)
from waymo_2d_tracking_tpu_torch.pipeline.link import write_gallery_sidecar
from waymo_2d_tracking_tpu_torch.pipeline.manifest import (
    append_manifest,
    load_done_keys,
    segment_key,
)
from waymo_2d_tracking_tpu_torch.pipeline.run import SegmentFrames, SegmentPipeline

STAT_KEYS = ("context", "camera", "frames", "tracks", "records")


def _gather_group(mine: List[dict]) -> List[dict]:
    """Every rank's stats rows of one group, in slot order, on every rank."""
    rows: List = [None] * dist.get_world_size()
    dist.all_gather_object(rows, mine)
    return sorted((r for part in rows for r in part), key=lambda r: r["shard"])


class ShardedSegmentRunner:
    """Runs groups of up to ``data size`` segments, one a rank."""

    def __init__(self, pipeline: SegmentPipeline, mesh):
        self.pipeline = pipeline
        self.mesh = check_mesh(mesh)
        self.n_shards = data_size(mesh)
        self.slot = data_index(mesh) if model_index(mesh) == 0 else None

    def run_group(self, group: List[SegmentFrames], out_dir: str,
                  detections_only: bool = False) -> List[dict]:
        """Run this rank's slot of ``group`` (same-resolution segments): its
        JSONL (detections with ``detections_only``, else tracks with the
        ``.gallery.npz`` sidecar). Returns every slot's stats row, on every
        rank."""
        if len(group) > self.n_shards:
            raise ValueError(f"a group holds at most {self.n_shards} segments, got {len(group)}")
        mine = []
        if self.slot is not None and self.slot < len(group):
            seg = group[self.slot]
            records, stats = self.pipeline.run_segment(seg, detections_only=detections_only)
            seg_file = os.path.join(out_dir, f"{seg.context_name}_{seg.camera_name}.jsonl")
            subm.write_jsonl(seg_file, records)
            if not detections_only:
                write_gallery_sidecar(seg_file, self.pipeline.last_state)
            mine.append({**{k: stats[k] for k in STAT_KEYS}, "shard": self.slot})
        return _gather_group(mine)


class ShardedMultiCamRunner:
    """Runs groups of up to ``data size`` multi-camera contexts, one a rank,
    each through the shared-backbone ``MultiCamPipeline``."""

    def __init__(self, pipeline, mesh):
        self.pipeline = pipeline
        self.mesh = check_mesh(mesh)
        self.n_shards = data_size(mesh)
        self.slot = data_index(mesh) if model_index(mesh) == 0 else None

    def run_context_group(self, contexts: List[List[SegmentFrames]], out_dir: str) -> List[dict]:
        """Run this rank's context of ``contexts`` (each a list of
        ``num_cams`` per-camera segments with aligned timestamps): a JSONL
        and a sidecar a camera. Returns every slot's rows, on every rank."""
        if len(contexts) > self.n_shards:
            raise ValueError(f"a group holds at most {self.n_shards} contexts, "
                             f"got {len(contexts)}")
        mine = []
        if self.slot is not None and self.slot < len(contexts):
            for st in self.pipeline.run_segments_group(contexts[self.slot], out_dir):
                mine.append({**{k: st[k] for k in ("context", "camera", "frames", "records",
                                                    "tracks")}, "shard": self.slot})
        return _gather_group(mine)


def _drive(run_group, items: Iterable, keys_of, hw_of, g: int, out_dir: str, mesh,
           fail_after: Optional[int], what: str) -> List[dict]:
    """JAX's grouping loop: skip items whose keys are all done, bucket by
    source resolution, flush a bucket when it holds ``g`` items and every
    bucket at the end; rank (0, 0) appends each group's rows to the
    manifest."""
    os.makedirs(out_dir, exist_ok=True)
    # every rank has left any earlier call (one that raised too), so the
    # writer's appends are on disk; the writer alone reads the done keys and
    # sends them, so every rank skips the same items and meets the same
    # collectives
    barrier(mesh)
    box = [load_done_keys(out_dir) if is_writer(mesh) else None]
    dist.broadcast_object_list(box, src=int(mesh.mesh[0, 0]))
    done = box[0]
    all_stats: List[dict] = []
    n_run = 0

    def flush(group):
        nonlocal n_run
        if not group:
            return
        if fail_after is not None and n_run >= fail_after:
            raise RuntimeError(f"fault injection: stopping after {fail_after} {what}")
        stats = run_group(group, out_dir)
        if is_writer(mesh):
            append_manifest(out_dir, stats)
        all_stats.extend(stats)
        n_run += len(group)

    buckets: Dict = {}
    for item in items:
        if all(k in done for k in keys_of(item)):
            continue
        hw = hw_of(item)
        bucket = buckets.setdefault(hw, [])
        bucket.append(item)
        if len(bucket) == g:
            flush(bucket)
            buckets[hw] = []
    for bucket in buckets.values():
        flush(bucket)
    barrier(mesh)     # the manifest is whole on every rank's return
    return all_stats


def run_segments_sharded(pipeline: SegmentPipeline, segments: Iterable[SegmentFrames],
                         out_dir: str, mesh=None, fail_after: Optional[int] = None,
                         detections_only: bool = False) -> List[dict]:
    """Manifest-resumable sharded fan-out (``run_segments``' contract):
    groups of up to ``data size`` same-resolution segments, one a rank.
    ``segments`` is consumed lazily, the same stream on every rank.
    ``mesh`` defaults to ``make_mesh()`` on the pipeline's device;
    ``fail_after``: raise after N completed segments (resume test hook).
    Returns every segment's stats row, on every rank."""
    mesh = mesh if mesh is not None else make_mesh(device=pipeline.device.type)
    runner = ShardedSegmentRunner(pipeline, mesh)
    return _drive(
        lambda group, out: runner.run_group(group, out, detections_only=detections_only),
        segments, lambda s: [segment_key(s.context_name, s.camera_name)], SegmentFrames.source_hw, runner.n_shards, out_dir, mesh, fail_after, "segments")


def run_context_groups_sharded(pipeline, segments: Iterable[SegmentFrames], out_dir: str,
                               mesh=None, fail_after: Optional[int] = None) -> List[dict]:
    """Manifest-resumable sharded multicam fan-out (``run_context_groups``'
    contract): per-camera segments grouped into contexts (by
    ``context_name``, sorted), contexts bucketed by source resolution into
    groups of up to ``data size``, one context a rank. A context with fewer
    cameras than ``pipeline.num_cams`` raises. ``fail_after``: raise after N
    completed contexts."""
    mesh = mesh if mesh is not None else make_mesh(device=pipeline.device.type)
    runner = ShardedMultiCamRunner(pipeline, mesh)
    # a context's cameras may arrive interleaved: assemble contexts first;
    # each stays lazy (JPEG bytes decode in the rank that runs it)
    by_ctx: Dict[str, List[SegmentFrames]] = {}
    for seg in segments:
        by_ctx.setdefault(seg.context_name, []).append(seg)
    for ctx, segs in by_ctx.items():
        if len(segs) != pipeline.num_cams:
            raise ValueError(f"context {ctx} has {len(segs)} cameras, "
                             f"pipeline expects {pipeline.num_cams}")
    contexts = [by_ctx[c] for c in sorted(by_ctx)]
    return _drive(
        runner.run_context_group, contexts,
        lambda segs: [segment_key(s.context_name, s.camera_name) for s in segs],
        lambda segs: segs[0].source_hw(), runner.n_shards, out_dir, mesh, fail_after,
        "contexts")
