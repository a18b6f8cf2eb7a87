"""Online (streaming) serving: one frame, or one camera-rig tick, at a time
(counterpart of ``pipeline/online.py``).

``SegmentPipeline`` batches ``chunk_frames`` frames per step, which suits
offline work but adds up to a chunk of latency. A live stream needs the
opposite trade, minimum latency per frame: here one frame goes through
letterbox -> ``dispatch_detect`` (NMS kernel inside) -> ``track_step``
(auction kernel inside) on the device and only the tiny (S-slot) outputs
come back. ``OnlineMultiCamTracker`` serves a whole rig per tick: every
camera in one detector batch and the camera-batched tracker step, i.e.
``MultiCamPipeline`` at T = 1.

On the card the tracker step is a CUDA graph (``tracker/graph.py``) that
each session captures for itself at its first step: the session's live track
table lives in the graph's static buffers, so a step copies in one frame of
detections and replays; ``state`` reads a copy of it, and ``reset`` and the
warm-up write into it.

Every step is timed end to end (host frame -> records); ``latency_stats``
gives p50/p90/p99/max in ms over a sliding window. ``warmup`` runs one dummy
step (the kernels build, the tracker step is captured and the allocator
warms) and leaves the live state as it found it.

Frames are decoded uint8 arrays or JPEG bytes; a session's ``_FrameDecoder``
decodes bytes with the native batch decoder at ``decode_scale_denom``
(libjpeg's scaled decode, sized from each batch's headers), and the records
map back to source pixels through that scale too. Under
``detector.quant='int8'`` a session calibrates on its first real frame or
tick (not in ``warmup``, whose all-zero frame would record a zero absmax);
the warm-up runs the int8 forward uncalibrated and throws its outputs away.

Under a profiler (``utils/profiling.py``) a timed step is the span
``w2t/tick``, holding ``w2t/stack`` (decode or stack the frames),
``w2t/staging``, ``w2t/detect``, ``w2t/track`` and ``w2t/fetch`` (the
outputs to the host); a step's records are ``w2t/records``. The counters
are ``pipeline/run.py``'s, every frame real.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from waymo_2d_tracking_tpu_torch.config import Config
from waymo_2d_tracking_tpu_torch.data.jpeg import BatchJpegDecoder, jpeg_dims
from waymo_2d_tracking_tpu_torch.data.preprocess import letterbox_batch
from waymo_2d_tracking_tpu_torch.io_out import submission as subm
from waymo_2d_tracking_tpu_torch.models.detector import DetectorRunner
from waymo_2d_tracking_tpu_torch.pipeline.run import (
    count_detections,
    count_frames,
    count_tracks,
    dispatch_detect,
)
from waymo_2d_tracking_tpu_torch.tracker import init_multicam_state, init_state, track_step
from waymo_2d_tracking_tpu_torch.tracker.graph import CapturedTracker
from waymo_2d_tracking_tpu_torch.types import Detections, TrackerState, TrackOutputs
from waymo_2d_tracking_tpu_torch.utils.profiling import span


Frame = Union[np.ndarray, bytes]


class _FrameDecoder:
    """Session-held JPEG decoder honouring ``decode_scale_denom``, sized from
    the compressed frames' headers (``jpeg_dims``) and re-probed every batch,
    so a stream at another resolution re-sizes it. Mixed resolutions within
    one rig batch raise (the shared detector batch needs equal cameras).
    Decoded arrays pass through untouched, at denom 1."""

    def __init__(self, scale_denom: int):
        self.scale_denom = int(scale_denom)
        self._decoder: Optional[BatchJpegDecoder] = None
        self._full_hw: Optional[Tuple[int, int]] = None

    def decode_batch(self, frames: Sequence[Frame]) -> Tuple[np.ndarray, int]:
        """-> ((N, H, W, 3) uint8, the denom applied)."""
        if all(isinstance(f, (bytes, bytearray)) for f in frames):
            blobs = [bytes(f) for f in frames]
            dims = {jpeg_dims(b) for b in blobs}
            if len(dims) != 1:
                raise ValueError(
                    f"mixed-resolution rig batch: JPEG dims {sorted(dims)}; the shared "
                    "detector batch needs equal-resolution cameras")
            (hw,) = dims
            if hw != self._full_hw:
                self.close()
                sd = self.scale_denom
                self._decoder = BatchJpegDecoder(-(-hw[0] // sd), -(-hw[1] // sd),
                                                 scale_denom=sd)
                self._full_hw = hw
            return self._decoder.decode(blobs), self.scale_denom
        if any(isinstance(f, (bytes, bytearray)) for f in frames):
            raise ValueError("a rig batch mixes JPEG bytes and decoded frames")
        if len(frames) == 1:      # one camera: no stack copy
            return np.asarray(frames[0])[None], 1
        return np.stack([np.asarray(f) for f in frames]), 1

    def close(self) -> None:
        if self._decoder is not None:
            self._decoder.close()
            self._decoder = None
        self._full_hw = None


class _LatencyWindow:
    """Sliding window of per-step wall times (seconds)."""

    def __init__(self, window: int = 1024):
        self._samples: Deque[float] = deque(maxlen=window)

    @property
    def maxlen(self) -> int:
        return self._samples.maxlen

    def add(self, seconds: float) -> None:
        self._samples.append(seconds)

    def last_ms(self) -> float:
        return self._samples[-1] * 1e3 if self._samples else 0.0

    def stats(self) -> dict:
        if not self._samples:
            return {"count": 0}
        ms = np.asarray(self._samples) * 1e3
        return {
            "count": int(ms.size),
            "mean_ms": round(float(ms.mean()), 3),
            "p50_ms": round(float(np.percentile(ms, 50)), 3),
            "p90_ms": round(float(np.percentile(ms, 90)), 3),
            "p99_ms": round(float(np.percentile(ms, 99)), 3),
            "max_ms": round(float(ms.max()), 3),
        }


class _Session:
    """What both sessions share: the detector, the live track state, the
    latency window, and one timed device step; a session says how a fresh
    state looks and which of the step's detections the tracker takes."""

    def __init__(self, cfg: Config, num_cams: int, state_dict, device, seed,
                 context_name: str, latency_window: int):
        self.cfg = cfg
        self.num_cams = num_cams
        self.context_name = context_name
        self.detector = DetectorRunner(cfg.detector, state_dict, device=device, seed=seed)
        self.device = self.detector.device
        self._latency = _LatencyWindow(latency_window)
        self._graph: Optional[CapturedTracker] = None
        self._frame_decoder = _FrameDecoder(cfg.pipeline.decode_scale_denom)
        self.reset()

    def close(self) -> None:
        """Release the JPEG decoder's thread pool (idempotent)."""
        self._frame_decoder.close()

    def _fresh_state(self) -> TrackerState:
        raise NotImplementedError

    def _frame_dets(self, dets: Detections) -> Detections:
        """The detector batch's detections in the tracker's layout."""
        raise NotImplementedError

    @property
    def state(self) -> TrackerState:
        """The live track table; on the card a copy of the captured step's
        buffers, which the next step overwrites."""
        return self._graph.current_state() if self._graph is not None else self._state

    @state.setter
    def state(self, value: TrackerState) -> None:
        if self._graph is not None:
            self._graph.load_state(value)
        else:
            self._state = value

    def _track(self, dets: Detections) -> TrackOutputs:
        """One tracker step on the live state: eager on the CPU, the
        session's captured graph on the card."""
        if self.device.type != "cuda":
            self._state, outputs = track_step(self._state, dets, self.cfg.tracker)
            return outputs
        if self._graph is None:
            self._graph = CapturedTracker(self.cfg.tracker, self._state, dets)
            self._state = None
        return self._graph.step(dets)

    def reset(self, clear_latency: bool = False) -> None:
        """Fresh track table (new stream / scene cut). ``clear_latency``
        also empties the latency window (per-stream percentiles); by default
        the window spans the whole session."""
        self.state = self._fresh_state()
        self.frames_seen = 0
        if clear_latency:
            self._latency = _LatencyWindow(self._latency.maxlen)

    def _device_step(self, frames_u8, src_hw, counted: bool = True):
        """(C, H, W, 3) uint8, a host array or a tensor already on the
        device -> (host TrackOutputs, scale); the live state advances by one
        frame. ``counted``: add the frames, detections and tracks to the
        counters (not for the warm-up's all-zero frames, which, run under
        ``uncalibrated_ok``, calibrate nothing either)."""
        with span("staging"):
            if isinstance(frames_u8, np.ndarray):
                frames_u8 = torch.from_numpy(np.ascontiguousarray(frames_u8))
            frames = frames_u8.to(self.device)
            images, scale = letterbox_batch(frames, src_hw, self.cfg.detector.image_size)
            self.detector.calibrate_once(images)
        with span("detect"):
            dets = dispatch_detect(self.detector, self.cfg, images)
        with span("track"):
            outputs = self._track(self._frame_dets(dets))
        with span("fetch"):
            outputs = outputs.to_numpy()
        if counted:
            count_frames(1, 1, self.num_cams)
            count_detections(dets, None, self.cfg.tracker.birth_score_threshold)
            count_tracks(outputs)
        return outputs, scale

    def _warmup(self, frames_u8: np.ndarray) -> float:
        t0 = time.perf_counter()
        saved = self.state
        with self.detector.uncalibrated_ok():
            self._device_step(frames_u8, tuple(frames_u8.shape[1:3]), False)  # not counted
        self.state = saved
        return time.perf_counter() - t0

    def _timed_step(self, frames: Sequence[Frame]):
        """Decode (JPEG bytes), one device step (int8: calibrated at the first);
        timed from the host frames to the outputs on the host. Returns
        (outputs, scale from network to source pixels)."""
        t0 = time.perf_counter()
        with span("tick"):
            with span("stack"):
                frames_u8, denom = self._frame_decoder.decode_batch(frames)
            outputs, scale = self._device_step(frames_u8, tuple(frames_u8.shape[1:3]))
        self._latency.add(time.perf_counter() - t0)
        self.frames_seen += 1
        return outputs, float(scale) / denom

    def latency_stats(self) -> dict:
        return self._latency.stats()

    def last_latency_ms(self) -> float:
        return self._latency.last_ms()


class OnlineTracker(_Session):
    """Single-camera streaming detect + track session.

    >>> sess = OnlineTracker(cfg, state_dict)
    >>> sess.warmup((1280, 1920))            # build and warm before serving
    >>> for ts, frame in stream:
    ...     records = sess.step(frame, ts)   # List[TrackRecord], this frame
    """

    def __init__(self, cfg: Config, state_dict: Optional[Dict[str, torch.Tensor]] = None,
                 device="cuda", seed: int = 0, context_name: str = "online",
                 camera_name: int = 1, latency_window: int = 1024):
        self.camera_name = camera_name
        super().__init__(cfg, 1, state_dict, device, seed, context_name, latency_window)

    def _fresh_state(self) -> TrackerState:
        return init_state(self.cfg.tracker, device=self.device)

    def _frame_dets(self, dets):
        return dets[0]

    def warmup(self, src_hw: Tuple[int, int]) -> float:
        """One dummy step on ``src_hw``-sized frames; the live state is kept.
        Returns seconds."""
        return self._warmup(np.zeros((1,) + tuple(src_hw) + (3,), np.uint8))

    def step(self, frame: Frame, timestamp_micros: int) -> List[subm.TrackRecord]:
        """One (H, W, 3) uint8 frame or JPEG bytes -> this frame's track
        records, timed from the host frame to the records' arrays on the
        host."""
        outputs, scale = self._timed_step([frame])
        with span("records"):
            return subm.records_from_track_outputs(
                outputs[None], self.context_name, [timestamp_micros], self.camera_name,
                scale=scale)


class OnlineMultiCamTracker(_Session):
    """Streaming session over a fixed camera rig: one ``step`` takes the
    rig's simultaneous frames, one shared detector batch, the camera-batched
    tracker step."""

    def __init__(self, cfg: Config, camera_names: Sequence[int],
                 state_dict: Optional[Dict[str, torch.Tensor]] = None, device="cuda",
                 seed: int = 0, context_name: str = "online", latency_window: int = 1024):
        self.camera_names = list(camera_names)
        super().__init__(cfg, len(self.camera_names), state_dict, device, seed,
                         context_name, latency_window)

    def _fresh_state(self) -> TrackerState:
        return init_multicam_state(self.cfg, self.num_cams, device=self.device)

    def _frame_dets(self, dets):
        return dets

    @property
    def states(self) -> TrackerState:
        """The live per-camera states (leading camera axis; on the card a
        copy)."""
        return self.state

    def warmup(self, src_hw: Tuple[int, int]) -> float:
        """One dummy rig tick on ``src_hw``-sized frames; the live state is
        kept. Returns seconds."""
        return self._warmup(np.zeros((self.num_cams,) + tuple(src_hw) + (3,), np.uint8))

    def step(self, frames: Sequence[Frame], timestamp_micros: int) -> List[subm.TrackRecord]:
        """One rig tick: frames[i] (array or JPEG bytes) belongs to
        ``camera_names[i]``."""
        if len(frames) != self.num_cams:
            raise ValueError(f"expected {self.num_cams} frames, got {len(frames)}")
        outputs, scale = self._timed_step(list(frames))
        records: List[subm.TrackRecord] = []
        with span("records"):
            for i, cam in enumerate(self.camera_names):
                records.extend(subm.records_from_track_outputs(
                    outputs[i][None], self.context_name, [timestamp_micros], cam,
                    scale=scale))
        return records
