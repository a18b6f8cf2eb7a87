"""Multi-camera orchestration (counterpart of ``pipeline/multicam.py``, BASELINE
config 4).

All cameras of a chunk go through one shared-backbone detector batch of
``chunk x C`` images (camera = batch axis), so TTA and the NMS kernel see
the whole chunk at once: one NMS launch per chunk. Each camera keeps its own
tracker state; the states are stacked on a leading camera axis and the
tracker steps all cameras together (``tracker.track_step`` over (C, ...)),
one auction launch per association stage carrying C problems: the
counterpart of ``jax.vmap(track_step)``.

Chunks have a fixed size; the tail is padded by repeating the last real
frame (``pipeline/run.py repeat_pad``), and the pad frames' outputs are
cut. Outputs and the final per-camera states come back
to the host through ``RollingFetch``, each copy behind its chunk's tracker
event alone (``tracker/graph.py to_host``).

On the card the tracker steps replay a captured CUDA graph per frame
(``tracker/graph.py``), one per (config, camera count, shapes), on the
pipeline's tracker stream: the driver queues the next chunk's staging and
forward on its own stream while the tracker runs, so the forward fills the
SMs the auction leaves idle. Under
``decode_scale_denom > 1`` the chunk is downscaled (``area_downscale``)
where ``SegmentFrames.chunk_iter`` places it: on the card after the copy, at
source size. Cameras given as JPEG bytes are decoded on the host at the
scaled size. Under
``detector.quant='int8'`` the first real chunk's shared batch calibrates the
activation scales.

``run_segments_group`` is fed by ``data/prefetch.py DevicePrefetcher``, as
``pipeline/run.py run_segment`` is (the JAX package's driver stacks the
cameras on the driving thread instead): its worker thread takes each
camera's next chunk, gathers the cameras straight into a pinned buffer of
(chunk, cams, H, W, 3) and copies it to the card on a side stream while the
card computes the chunk before.

Under a profiler (``utils/profiling.py``) a group is the span ``w2t/group``,
holding ``w2t/prefetch_wait`` (the driving thread waiting for the worker's
next chunk), ``w2t/chunk`` per chunk (``w2t/staging``, ``w2t/detect``,
``w2t/track``), ``w2t/fetch`` and ``w2t/records``, with the counters of
``pipeline/run.py`` and the prefetcher's.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from waymo_2d_tracking_tpu_torch.config import Config
from waymo_2d_tracking_tpu_torch.data.prefetch import DevicePrefetcher
from waymo_2d_tracking_tpu_torch.data.preprocess import area_downscale, letterbox_batch
from waymo_2d_tracking_tpu_torch.io_out import submission as subm
from waymo_2d_tracking_tpu_torch.models.detector import DetectorRunner
from waymo_2d_tracking_tpu_torch.pipeline.link import write_gallery_sidecar
from waymo_2d_tracking_tpu_torch.pipeline.run import (
    RollingFetch,
    concat_host,
    count_detections,
    count_frames,
    count_tracks,
    dispatch_detect,
    repeat_pad,
)
from waymo_2d_tracking_tpu_torch.tracker import init_multicam_state
from waymo_2d_tracking_tpu_torch.tracker.graph import chunk_done, join, to_host, track_chunk
from waymo_2d_tracking_tpu_torch.types import Detections, TrackerState
from waymo_2d_tracking_tpu_torch.utils.profiling import span

__all__ = ["MultiCamPipeline", "init_multicam_state", "run_context_groups", "split_cameras"]


def split_cameras(dets: Detections, t: int, c: int) -> Detections:
    """(t * c, D, ...) detections of a time-major camera batch -> (t, c, D, ...)."""
    return Detections(**{
        f.name: getattr(dets, f.name).reshape((t, c) + getattr(dets, f.name).shape[1:])
        for f in dataclasses.fields(Detections)
    })


def _rig_chunks(iters):
    """The cameras' chunk iterators zipped: one list of per-camera
    (chunk, H, W, 3) blocks a chunk. Its ``finally`` closes every camera's
    iterator (a JPEG source's decoder), in the thread that iterates it."""
    try:
        yield from map(list, zip(*iters))
    finally:
        for it in iters:
            it.close()


class MultiCamPipeline:
    """Chunked multi-camera detect + track on ``device``.

    A chunk is frames_u8 (chunk, num_cams, H, W, 3) uint8; the detector sees
    (chunk * num_cams, ...), the tracker steps over the chunk's frames with
    every camera at once. ``state_dict``: detector weights
    (``weights.from_flax_numpy``); None draws seeded random weights.
    """

    def __init__(self, cfg: Config, num_cams: int = 5,
                 state_dict: Optional[Dict[str, torch.Tensor]] = None,
                 device="cuda", seed: int = 0):
        self.cfg = cfg
        self.num_cams = num_cams
        self.detector = DetectorRunner(cfg.detector, state_dict, device=device, seed=seed)
        self.device = self.detector.device
        self._graphs: Dict = {}    # captured tracker steps (tracker/graph.py)

    def chunk_step(self, states: TrackerState, frames_u8, src_hw, real: Optional[int] = None):
        """(states, (chunk, cams, H, W, 3) u8 at the size the chunk iterator
        gave, a host array or a tensor already on the device, ``src_hw`` the
        size after ``decode_scale_denom``) -> (states', outputs on the device
        (chunk, cams, S, ...), scale): one shared-backbone batch through the
        detector, then the camera-batched tracker, on the card on this
        pipeline's lane: read the states and outputs behind
        ``chunk_done(self._graphs, self.device)``. Frames larger than
        ``src_hw`` are downscaled on the device. ``real``: the chunk's real
        frames (the rest repeat the last), for the counters; None: all."""
        t, c = frames_u8.shape[:2]
        with span("chunk"):
            with span("staging"):
                if isinstance(frames_u8, np.ndarray):
                    frames_u8 = torch.from_numpy(np.ascontiguousarray(frames_u8))
                frames = frames_u8.reshape((t * c,) + tuple(frames_u8.shape[2:])).to(self.device)
                if tuple(frames.shape[1:3]) != tuple(src_hw):
                    frames = area_downscale(frames, self.cfg.pipeline.decode_scale_denom)
                images, scale = letterbox_batch(frames, src_hw, self.cfg.detector.image_size)
                self.detector.calibrate_once(images)
            with span("detect"):
                flat = dispatch_detect(self.detector, self.cfg, images)
            count_detections(flat, None if real is None else real * c,
                             self.cfg.tracker.birth_score_threshold)
            dets = split_cameras(flat, t, c)
            with span("track"):
                states, outputs = track_chunk(states, dets, self.cfg.tracker, self._graphs)
        return states, outputs, scale

    def run_segments_group(self, segments, out_dir: str) -> List[dict]:
        """Per-camera ``SegmentFrames`` of one context (equal timestamps and
        resolutions) -> one submission JSONL and one gallery sidecar per
        camera in ``out_dir``; returns the per-camera stats."""
        with span("group"):
            return self._run_segments_group(segments, out_dir)

    def _run_segments_group(self, segments, out_dir: str) -> List[dict]:
        cfg = self.cfg
        chunk = cfg.pipeline.chunk_frames
        sd = cfg.pipeline.decode_scale_denom
        segments = sorted(segments, key=lambda s: s.camera_name)
        assert len({tuple(s.timestamps) for s in segments}) == 1, (
            "multicam group needs aligned timestamps"
        )
        assert len(segments) == self.num_cams
        ctx = segments[0].context_name
        t_total = segments[0].num_frames
        count_frames(t_total, chunk, self.num_cams)

        states = init_multicam_state(cfg, self.num_cams, device=self.device)
        iters = [s.chunk_iter(chunk, sd, self.device) for s in segments]
        fetcher = RollingFetch(depth=cfg.pipeline.prefetch_depth)
        src_hw = segments[0].scaled_hw(sd)
        scale = 1.0
        with DevicePrefetcher(_rig_chunks(iters), depth=cfg.pipeline.prefetch_depth,
                              device=self.device) as prefetcher:
            for i, frames in enumerate(prefetcher):    # (chunk, cams, H, W, 3)
                states, outputs, scale = self.chunk_step(states, frames, src_hw,
                                                         min(chunk, t_total - i * chunk))
                fetcher.push(outputs, chunk_done(self._graphs, self.device))
        outputs_host = fetcher.finish()
        with span("fetch"):
            final_states = to_host(states, chunk_done(self._graphs, self.device))
        total_scale = float(scale) / sd

        with span("records"):
            stacked = concat_host(outputs_host, t_total)
            count_tracks(stacked)
            os.makedirs(out_dir, exist_ok=True)
            stats = []
            for ci, seg in enumerate(segments):
                records = subm.records_from_track_outputs(
                    stacked[:, ci], ctx, seg.timestamps, seg.camera_name,
                    scale=total_scale, interp_max_gap=cfg.pipeline.interp_max_gap,
                )
                path = os.path.join(out_dir, f"{ctx}_{seg.camera_name}.jsonl")
                subm.write_jsonl(path, records)
                write_gallery_sidecar(path, final_states, cam_index=ci)
                stats.append({"context": ctx, "camera": seg.camera_name,
                              "frames": seg.num_frames, "records": len(records),
                              "tracks": len({r.object_id for r in records})})
        return stats

    def run(self, frames: np.ndarray, states: Optional[TrackerState] = None):
        """Track a multi-camera clip, frames (T, cams, H, W, 3) uint8 on the
        host, taken at the size given (as in the JAX package, no decode
        downscale). Returns (states on the device, host TrackOutputs (T,
        cams, S), scale)."""
        cfg = self.cfg
        chunk = cfg.pipeline.chunk_frames
        t_total = frames.shape[0]
        src_hw = tuple(frames.shape[2:4])
        if states is None:
            states = init_multicam_state(cfg, self.num_cams, device=self.device)
        fetcher = RollingFetch(depth=cfg.pipeline.prefetch_depth)
        scale = 1.0
        count_frames(t_total, chunk, self.num_cams)
        for start in range(0, t_total, chunk):
            block = repeat_pad(frames[start:start + chunk], chunk)
            states, outputs, scale = self.chunk_step(states, block, src_hw,
                                                     min(chunk, t_total - start))
            fetcher.push(outputs, chunk_done(self._graphs, self.device))
        outputs = concat_host(fetcher.finish(), t_total)
        join(self._graphs, self.device)    # the states are used on the caller's stream
        count_tracks(outputs)
        return states, outputs, scale


def run_context_groups(pipeline: MultiCamPipeline, segments, out_dir: str,
                       fail_after: Optional[int] = None) -> List[dict]:
    """Manifest-resumable multicam driver: per-camera segments grouped into
    contexts; completed (context, camera) keys are recorded in
    ``manifest.jsonl`` and a context whose cameras are all done is skipped on
    rerun.

    fail_after: test hook, raise after N completed contexts.
    """
    from waymo_2d_tracking_tpu_torch.pipeline.manifest import (
        append_manifest,
        load_done_keys,
        segment_key,
    )

    done = load_done_keys(out_dir)
    by_ctx: Dict[str, List] = {}
    for seg in segments:
        by_ctx.setdefault(seg.context_name, []).append(seg)

    all_stats: List[dict] = []
    n_run = 0
    for ctx in sorted(by_ctx):
        segs = by_ctx[ctx]
        assert len(segs) == pipeline.num_cams, (
            f"context {ctx} has {len(segs)} cameras, "
            f"pipeline expects {pipeline.num_cams}"
        )
        if all(segment_key(s.context_name, s.camera_name) in done for s in segs):
            continue
        if fail_after is not None and n_run >= fail_after:
            raise RuntimeError(f"fault injection: stopping after {fail_after} contexts")
        stats = pipeline.run_segments_group(segs, out_dir)
        with span("records"):
            append_manifest(out_dir, stats)
        all_stats.extend(stats)
        n_run += 1
    return all_stats
