"""Per-segment orchestration (counterpart of ``pipeline/run.py``): the
detect -> track hot path.

Per chunk of ``chunk_frames`` frames: ``data/prefetch.py DevicePrefetcher``
copies the next uint8 chunk to the device from a worker thread (pinned
buffers, a side stream) while the device computes on the current one; the
chunk is downscaled by ``decode_scale_denom`` (``area_downscale``, the bytes
of the JAX package's ``cv2`` INTER_AREA resize), letterboxed, run through
the batched detector (NMS kernel inside), and the tracker steps through the
chunk's frames with its state carried across chunks: on the card a CUDA
graph of one step replayed per frame (``tracker/graph.py``), the
counterpart of the JAX package's jitted ``lax.scan``, on the graph cache's
own stream, so that the next chunk's staging and forward, queued on the
driver's stream, run beside it. On the card the frames
cross at their source size and are downscaled there; a CPU pipeline
downscales on the host, in the prefetch worker, as the JAX package does
(``SegmentFrames.chunk_iter`` decides, for every driver).
Outputs come back once per chunk through ``RollingFetch``, which keeps at
most ``prefetch_depth`` chunks in flight and copies each behind its own
chunk's tracker event (``tracker/graph.py to_host``), never behind the
driver's stream; the final table too. Boxes map back to source pixels
through the letterbox scale and the decode scale.

A segment's frames are decoded arrays or JPEG bytes (``jpeg_frames``, e.g.
from ``data/waymo.py iter_segments``); JPEG chunks are decoded in the
prefetch worker by the native batch decoder at ``decode_scale_denom``
(libjpeg's DCT-scaled decode), so they cross already at the scaled size.

Detection goes through ``dispatch_detect``: the plain batched forward, or the
test-time augmentation union (``pipeline/tta.py``) when the preset asks for
it. Under ``detector.quant='int8'`` the first real chunk calibrates the
activation scales (``DetectorRunner.calibrate_once``), as in every driver.
``run_segments`` drives many segments with manifest resume and writes a
``.gallery.npz`` sidecar beside each track file (``pipeline/link.py``).

Under a profiler (``utils/profiling.py``) a segment is the span
``w2t/segment``, holding ``w2t/prefetch_wait`` (the prefetcher's blocked
wait), ``w2t/chunk`` per chunk (in it ``w2t/staging``, ``w2t/detect`` and
``w2t/track``), ``w2t/fetch`` (outputs and the final table to the host) and
``w2t/records``; the tail in ``run_segments`` (track file, sidecar,
manifest) is ``w2t/records`` too. The counters: camera-frames
``frames_real`` and ``frames_pad``, valid detections over real frames
``det_valid`` and those at or above the tracker's birth gate ``det_birth``
(both summed on the device), and valid track slots ``track_live``.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from waymo_2d_tracking_tpu_torch.config import Config
from waymo_2d_tracking_tpu_torch.data.jpeg import BatchJpegDecoder, jpeg_dims
from waymo_2d_tracking_tpu_torch.data.prefetch import DevicePrefetcher
from waymo_2d_tracking_tpu_torch.data.preprocess import area_downscale, letterbox_batch
from waymo_2d_tracking_tpu_torch.io_out import submission as subm
from waymo_2d_tracking_tpu_torch.models.detector import DetectorRunner
from waymo_2d_tracking_tpu_torch.pipeline.tta import detect_tta_batch
from waymo_2d_tracking_tpu_torch.tracker import init_state
from waymo_2d_tracking_tpu_torch.tracker.graph import ChunkDone, chunk_done, to_host, track_chunk
from waymo_2d_tracking_tpu_torch.types import Detections, TrackerState
from waymo_2d_tracking_tpu_torch.utils.profiling import count, span, tracing


@dataclasses.dataclass
class SegmentFrames:
    """A segment's frames for one camera, host-side: ``frames`` (T, H, W, 3)
    uint8, already decoded, or ``jpeg_frames``, a sequence of JPEG bytes
    decoded a chunk at a time in the prefetch worker."""

    context_name: str
    camera_name: int
    timestamps: Sequence[int]
    frames: Optional[np.ndarray] = None
    jpeg_frames: Optional[Sequence[bytes]] = None
    _src_hw: Optional[Tuple[int, int]] = dataclasses.field(default=None, repr=False)

    @property
    def num_frames(self) -> int:
        return len(self.timestamps)

    def source_hw(self) -> Tuple[int, int]:
        """Full-resolution (H, W), cached; for JPEG bytes read from the first
        frame's header (``jpeg_dims``, no decode)."""
        if self._src_hw is None:
            if self.frames is not None:
                self._src_hw = tuple(self.frames.shape[1:3])
            else:
                self._src_hw = jpeg_dims(bytes(self.jpeg_frames[0]))
        return self._src_hw

    def scaled_hw(self, scale_denom: int = 1) -> Tuple[int, int]:
        """(H, W) after a downscale by ``scale_denom``: ceil(src / denom),
        what libjpeg's DCT-scaled decode gives."""
        h, w = self.source_hw()
        return (-(-h // scale_denom), -(-w // scale_denom))

    def chunk_iter(self, chunk: int, scale_denom: int = 1,
                   device="cpu") -> Iterator[np.ndarray]:
        """Yield (chunk, H, W, 3) uint8 host arrays for a pipeline on
        ``device``, which decides where the ``scale_denom`` downscale
        happens: JPEG bytes are decoded by the native batch decoder at
        1/``scale_denom`` on any device; decoded frames for a CUDA device
        stay at the source size (they cross so and the device downscales
        them); decoded frames for the CPU are downscaled here
        (``area_downscale`` on CPU tensors: the bytes of the JAX package's
        ``cv2.resize(..., INTER_AREA)``). The last chunk is padded by
        ``repeat_pad``."""
        decoder = None
        if self.frames is None:
            decoder = BatchJpegDecoder(*self.scaled_hw(scale_denom), scale_denom=scale_denom)
        host_downscale = scale_denom > 1 and torch.device(device).type != "cuda"
        try:
            for start in range(0, self.num_frames, chunk):
                if decoder is not None:
                    block = decoder.decode(self.jpeg_frames[start:start + chunk])
                else:
                    block = self.frames[start:start + chunk]
                    if host_downscale:
                        block = area_downscale(torch.from_numpy(np.ascontiguousarray(block)),
                                               scale_denom).numpy()
                yield repeat_pad(block, chunk)
        finally:
            if decoder is not None:
                decoder.close()


def repeat_pad(block: np.ndarray, chunk: int) -> np.ndarray:
    """``block`` (n <= chunk, ...) padded to ``chunk`` rows by REPEATING its
    last frame, not zeros: the tracker treats pad frames as real ones, and a
    blank tail longer than max_age would age out every live track (and the
    final table the ``.gallery.npz`` sidecars come from). Pad-frame outputs
    are trimmed by the caller."""
    if block.shape[0] < chunk:
        pad = chunk - block.shape[0]
        block = np.concatenate([block, np.repeat(block[-1:], pad, axis=0)])
    return block


class RollingFetch:
    """Bounded window of chunk outputs still on the device: once more than
    ``depth`` chunks are queued, the oldest is copied to the host (which
    waits for it), so the host never runs unboundedly ahead of the card.
    ``done``: the ``ChunkDone`` of the chunk that made the outputs, whose
    copy then waits on that chunk's tracker alone (``to_host``); None:
    the copy waits on the current stream."""

    def __init__(self, depth: int = 2):
        self.depth = max(int(depth), 1)
        self._dev: List = []
        self._host: List = []

    def push(self, outputs, done: Optional[ChunkDone] = None) -> None:
        self._dev.append((outputs, done))
        if len(self._dev) > self.depth:
            with span("fetch"):
                self._host.append(to_host(*self._dev.pop(0)))

    def finish(self) -> List:
        with span("fetch"):
            self._host.extend(to_host(*o) for o in self._dev)
        self._dev = []
        return self._host


def count_frames(t_total: int, chunk: int, cams: int = 1) -> None:
    """The counters of a unit of ``t_total`` frames a camera in chunks of
    ``chunk``: real and repeat-padded camera-frames."""
    count("frames_real", t_total * cams)
    count("frames_pad", (-(-t_total // chunk) * chunk - t_total) * cams)


def count_detections(dets: Detections, real: Optional[int], birth_gate: float) -> None:
    """Valid detections of a chunk's first ``real`` rows (None: all), and
    those of them scored at or above the tracker's ``birth_gate``, summed on
    the device."""
    if tracing():
        valid = dets.valid[:real]
        count("det_valid", valid.sum())
        count("det_birth", (valid & (dets.scores[:real] >= birth_gate)).sum())


def count_tracks(outputs) -> None:
    """Valid track slots of host outputs cut to the real frames."""
    if tracing():
        count("track_live", int(outputs.valid.sum()))


def concat_host(chunks: List, t_total: int):
    """Host chunk outputs (numpy records, leading axis T) joined along T and
    cut to the ``t_total`` real frames."""
    record_type = type(chunks[0])
    return record_type(**{
        f.name: np.concatenate([getattr(o, f.name) for o in chunks])[:t_total]
        for f in dataclasses.fields(record_type)
    })


def tta_active(p) -> bool:
    """True when the preset's TTA knobs ask for a multi-view candidate union."""
    return bool(p.tta_flip) or tuple(p.tta_scales) != (1.0,)


def dispatch_detect(detector: DetectorRunner, cfg: Config, images: torch.Tensor) -> Detections:
    """The one detection dispatch rule: the plain batched forward, or the TTA
    candidate union when the preset enables it."""
    if tta_active(cfg.pipeline):
        return detect_tta_batch(detector, images, scales=tuple(cfg.pipeline.tta_scales),
                                flip=cfg.pipeline.tta_flip)
    return detector.detect(images)


class SegmentPipeline:
    """Detector + tracker on ``device``, reusable across segments.

    ``state_dict``: detector weights (``weights.from_flax_numpy``); None
    draws seeded random weights (``seed``).
    """

    def __init__(self, cfg: Config, state_dict: Optional[Dict[str, torch.Tensor]] = None,
                 device="cuda", seed: int = 0):
        self.cfg = cfg
        self.detector = DetectorRunner(cfg.detector, state_dict, device=device, seed=seed)
        self.device = self.detector.device
        self.last_state = None
        self._graphs: Dict = {}    # captured tracker steps (tracker/graph.py)

    def preprocess(self, frames_u8: np.ndarray, src_hw):
        """Host (N, H, W, 3) uint8 frames at the source size ``src_hw`` ->
        downscaled by ``decode_scale_denom`` and letterboxed on the device;
        returns (images, letterbox scale)."""
        frames = torch.from_numpy(np.ascontiguousarray(frames_u8)).to(self.device)
        sd = self.cfg.pipeline.decode_scale_denom
        frames = area_downscale(frames, sd)
        h, w = src_hw
        return letterbox_batch(frames, (-(-h // sd), -(-w // sd)), self.cfg.detector.image_size)

    def _detect_chunk(self, frames: torch.Tensor, src_hw,
                      real: Optional[int] = None) -> Tuple[Detections, torch.Tensor]:
        """Device (chunk, H, W, 3) uint8 frames -> (detections, letterbox
        scale): downscaled by ``decode_scale_denom`` on the device where they
        are larger than ``src_hw`` (the size after that downscale), letterbox,
        the int8 calibration hook, detect. ``real``: the chunk's real
        frames (the rest repeat the last), for the counters; None: all."""
        with span("staging"):
            if tuple(frames.shape[1:3]) != tuple(src_hw):
                frames = area_downscale(frames, self.cfg.pipeline.decode_scale_denom)
            images, scale = letterbox_batch(frames, src_hw, self.cfg.detector.image_size)
            self.detector.calibrate_once(images)
        with span("detect"):
            dets = dispatch_detect(self.detector, self.cfg, images)
        count_detections(dets, real, self.cfg.tracker.birth_score_threshold)
        return dets, scale

    def chunk_step(self, state: TrackerState, frames: torch.Tensor, src_hw,
                   real: Optional[int] = None):
        """One chunk of the segment path (the JAX package's ``_chunk_step``):
        (state, device (chunk, H, W, 3) uint8 frames, ``src_hw``) -> (state',
        outputs on the device (chunk, S, ...), letterbox scale). The tracker
        steps through the chunk's frames, on the card by the captured step
        (``tracker/graph.py``) this pipeline keeps, on its lane: read the
        state and outputs behind ``chunk_done(self._graphs, self.device)``.
        ``real`` as in ``_detect_chunk``."""
        with span("chunk"):
            dets, scale = self._detect_chunk(frames, src_hw, real)
            with span("track"):
                state, outputs = track_chunk(state, dets, self.cfg.tracker, self._graphs)
        return state, outputs, scale

    def run_segment(
        self, segment: SegmentFrames, detections_only: bool = False,
    ) -> Tuple[List[subm.TrackRecord], dict]:
        """Full detect -> track over one camera's segment. Returns (records,
        stats); the final track table is kept in ``last_state`` (numpy)."""
        with span("segment"):
            return self._run_segment(segment, detections_only)

    def _run_segment(self, segment: SegmentFrames, detections_only: bool):
        cfg = self.cfg
        chunk = cfg.pipeline.chunk_frames
        sd = cfg.pipeline.decode_scale_denom
        t_total = segment.num_frames
        src_hw = segment.scaled_hw(sd)
        count_frames(t_total, chunk)

        state = init_state(cfg.tracker, device=self.device)
        self.last_state = None
        scale = 1.0
        t0 = time.perf_counter()
        fetcher = RollingFetch(depth=cfg.pipeline.prefetch_depth)
        blocks = segment.chunk_iter(chunk, sd, self.device)
        with DevicePrefetcher(blocks, depth=cfg.pipeline.prefetch_depth,
                              device=self.device) as prefetcher:
            for i, frames in enumerate(prefetcher):
                real = min(chunk, t_total - i * chunk)
                if detections_only:
                    dets, scale = self._detect_chunk(frames, src_hw, real)
                    fetcher.push(dets)
                else:
                    state, outputs, scale = self.chunk_step(state, frames, src_hw, real)
                    fetcher.push(outputs, chunk_done(self._graphs, self.device))
        outputs_host = fetcher.finish()
        if not detections_only:
            with span("fetch"):
                self.last_state = to_host(state, chunk_done(self._graphs, self.device))
        wall = time.perf_counter() - t0

        with span("records"):
            stacked = concat_host(outputs_host, t_total)
            total_scale = float(scale) / sd
            if detections_only:
                records = subm.records_from_detections(
                    stacked, segment.context_name, segment.timestamps,
                    segment.camera_name, scale=total_scale,
                )
            else:
                count_tracks(stacked)
                records = subm.records_from_track_outputs(
                    stacked, segment.context_name, segment.timestamps,
                    segment.camera_name, scale=total_scale,
                    interp_max_gap=cfg.pipeline.interp_max_gap,
                )
        stats = {
            "context": segment.context_name,
            "camera": segment.camera_name,
            "frames": t_total,
            "tracks": len({r.object_id for r in records}),
            "records": len(records),
            "wall_s": round(wall, 4),
            "fps": round(t_total / wall, 1) if wall > 0 else None,
        }
        return records, stats



def run_segments(
    pipeline: SegmentPipeline,
    segments: Iterable[SegmentFrames],
    out_dir: str,
    fail_after: Optional[int] = None,
) -> List[dict]:
    """Drive many segments with manifest resume: completed segments are
    recorded in ``manifest.jsonl`` and skipped on rerun; each segment's track
    file is rewritten whole, with its ``.gallery.npz`` sidecar from the
    final track table (``pipeline.last_state``).

    fail_after: test hook, raise after N segments to exercise resume.
    """
    from waymo_2d_tracking_tpu_torch.pipeline.link import write_gallery_sidecar
    from waymo_2d_tracking_tpu_torch.pipeline.manifest import (
        append_manifest,
        load_done_keys,
        segment_key,
    )

    done = load_done_keys(out_dir)
    all_stats = []
    n_run = 0
    for seg in segments:
        if segment_key(seg.context_name, seg.camera_name) in done:
            continue
        if fail_after is not None and n_run >= fail_after:
            raise RuntimeError(f"fault injection: stopping after {fail_after} segments")
        records, stats = pipeline.run_segment(seg)
        with span("records"):
            seg_file = os.path.join(out_dir, f"{seg.context_name}_{seg.camera_name}.jsonl")
            subm.write_jsonl(seg_file, records)
            if pipeline.last_state is not None:
                write_gallery_sidecar(seg_file, pipeline.last_state)
            append_manifest(out_dir, [stats])
        all_stats.append(stats)
        n_run += 1
    return all_stats
