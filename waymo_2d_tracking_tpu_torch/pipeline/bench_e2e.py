"""End-to-end detect + track benchmark rows (counterpart of
``pipeline/bench_e2e.py``), on the card unless ``device="cpu"``.

Each function returns one row, ``{"metric", "value", "unit",
"vs_baseline"}``, with the JAX package's metric names and unit strings, so
the two harnesses' lines compare. The method is the JAX package's:

- the frames come from ``np.random.default_rng(0)`` and are staged on the
  device before anything is timed, so a row measures the device work of the
  chunk step, not the host-to-device copy that ``DevicePrefetcher`` overlaps
  in ``run_segment``;
- the int8 calibration hook runs before the timed region;
- every distinct block shape (a trailing partial chunk included) is warmed,
  so no graph capture, cuDNN plan or kernel build lands in the timed region;
- every repeat starts from a fresh tracker state;
- the best of 3 groups counts, the timed region syncing once a group, by the
  host copy of the last outputs.

The online row times one device step a frame (or a rig tick), each ending
in the outputs' host copy, and reports p50 with p90 / p99 / max in ``unit``.
"""
from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from waymo_2d_tracking_tpu_torch import resolve_device
from waymo_2d_tracking_tpu_torch.config import (
    Config,
    DetectorConfig,
    PipelineConfig,
    TrackerConfig,
    load_config,
)

# The JSON contract's reference point: the north star of ``BASELINE.json``
# (1500 frames/s a chip end to end). vs_baseline = value / BASELINE_FPS.
BASELINE_FPS = 1500.0
CONFIGS_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "configs")


def preset_config(preset: str) -> Config:
    """``configs/<preset>.yaml``."""
    return load_config(os.path.join(CONFIGS_DIR, f"{preset}.yaml"))


def _warm(step, state, blocks):
    """One step on each distinct block shape; returns the last outputs."""
    warmed = set()
    outputs = None
    for block in blocks:
        if tuple(block.shape) not in warmed:
            state, outputs, _ = step(state, block)
            warmed.add(tuple(block.shape))
    return outputs


def _best_of_3(run_once, repeats: int) -> float:
    """Seconds of one pass, the best of 3 groups of ``repeats`` passes, each
    group timed to the host copy of its last outputs."""
    best_dt = None
    for _group in range(3):
        t0 = time.perf_counter()
        for _ in range(repeats):
            outputs = run_once()
        outputs.valid.cpu()
        dt = (time.perf_counter() - t0) / repeats
        best_dt = dt if best_dt is None else min(best_dt, dt)
    return best_dt


def run_detect_track_bench(
    num_frames: int = 64,
    repeats: int = 5,
    image_hw=(640, 960),
    chunk: int = 16,
    detector_overrides: dict | None = None,
    tta: bool = False,
    metric: str = "detect_track_frames_per_sec_per_chip",
    config=None,
    src_hw=None,
    device="cuda",
):
    """Time ``SegmentPipeline.chunk_step`` over a seeded clip.

    config: a full ``Config`` (e.g. a ``configs/*.yaml`` preset); it overrides
      ``image_hw`` / ``chunk`` / ``detector_overrides`` / ``tta``.
    src_hw: the frames' size, letterboxed on the device to the network input;
      defaults to the network input size (the letterbox then only pads).
    """
    from waymo_2d_tracking_tpu_torch.pipeline.run import SegmentPipeline
    from waymo_2d_tracking_tpu_torch.tracker import init_state

    if config is not None:
        cfg = config
        chunk = cfg.pipeline.chunk_frames
    else:
        det_cfg = DetectorConfig(image_size=image_hw)
        if detector_overrides:
            det_cfg = dataclasses.replace(det_cfg, **detector_overrides)
        embed_dim = det_cfg.embed_dim
        cfg = Config(
            detector=det_cfg,
            tracker=TrackerConfig(max_tracks=64, max_detections=128, embed_dim=embed_dim,
                                  appearance_weight=0.3 if embed_dim else 0.0),
            pipeline=PipelineConfig(chunk_frames=chunk, tta_flip=tta,
                                    tta_scales=(1.0, 0.75) if tta else (1.0,)),
        )
    dev = resolve_device(device)
    pipeline = SegmentPipeline(cfg, device=dev, seed=0)

    src_hw = tuple(src_hw or cfg.detector.image_size)
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 255, (num_frames,) + src_hw + (3,), dtype=np.uint8)
    blocks = [torch.from_numpy(frames[i:i + chunk]).to(dev)
              for i in range(0, num_frames, chunk)]
    pipeline.ensure_calibrated(blocks[0], src_hw)

    def step(state, block):
        return pipeline.chunk_step(state, block, src_hw)

    _warm(step, init_state(cfg.tracker, device=dev), blocks).valid.cpu()

    def run_once():
        state = init_state(cfg.tracker, device=dev)
        for block in blocks:
            state, outputs, _ = step(state, block)
        return outputs

    fps = num_frames / _best_of_3(run_once, repeats)
    return {
        "metric": metric,
        "value": round(fps, 1),
        "unit": "frames/sec/chip",
        "vs_baseline": round(fps / BASELINE_FPS, 3),
    }


def run_online_latency_bench(
    num_frames: int = 128,
    config=None,
    preset: str = "headline",
    src_hw=None,
    multicam: bool = False,
    num_cams: int = 5,
    device="cuda",
):
    """Per-frame serving latency of the online path (``pipeline/online.py``).

    Times one ``OnlineTracker`` device step a frame (``OnlineMultiCamTracker``
    a rig tick with ``multicam``), from the frame on the device to the
    outputs on the host, and reports the p50 over ``num_frames`` steps
    (p90 / p99 / max in the unit string).

    vs_baseline: the real-time margin against the 10 Hz Waymo camera period
    (100 ms a frame): 100 / p50; >= 1.0 keeps up with the sensor.
    """
    from waymo_2d_tracking_tpu_torch.pipeline.online import (
        OnlineMultiCamTracker,
        OnlineTracker,
    )

    cfg = config if config is not None else preset_config(preset)
    dev = resolve_device(device)
    if multicam:
        sess = OnlineMultiCamTracker(cfg, camera_names=list(range(1, num_cams + 1)),
                                     device=dev, seed=0)
    else:
        sess = OnlineTracker(cfg, device=dev, seed=0)

    src_hw = tuple(src_hw or cfg.detector.image_size)
    rng = np.random.default_rng(0)
    lead = (num_cams,) if multicam else ()
    frames = rng.integers(0, 255, (num_frames,) + lead + src_hw + (3,), dtype=np.uint8)
    # (num_frames, cams, H, W, 3): the session's step takes a camera axis
    dev_frames = torch.from_numpy(frames.reshape((num_frames, -1) + src_hw + (3,))).to(dev)

    sess._ensure_calibrated(dev_frames[0], src_hw)
    sess.warmup(src_hw)
    samples = []
    for f in dev_frames:
        t0 = time.perf_counter()
        sess._device_step(f, src_hw)      # ends in the outputs' host copy
        samples.append(time.perf_counter() - t0)
    ms = np.asarray(samples) * 1e3
    p50 = float(np.percentile(ms, 50))
    what = f"rig tick ({num_cams} cams)" if multicam else "frame"
    return {
        "metric": ("online_multicam_serving_latency_p50_ms" if multicam
                   else "online_serving_latency_p50_ms"),
        "value": round(p50, 3),
        "unit": (
            f"ms/{what} (device step incl. dispatch; n={num_frames}, "
            f"p90={np.percentile(ms, 90):.3f}, "
            f"p99={np.percentile(ms, 99):.3f}, max={ms.max():.3f}; "
            "vs_baseline = 10Hz-camera real-time margin, 100ms/p50)"
        ),
        "vs_baseline": round(100.0 / p50, 3),
    }


def run_multicam_bench(
    num_frames: int = 32,
    repeats: int = 5,
    num_cams: int = 5,
    chunk: int = 8,
    preset: str = "production",
    src_hw=None,
    device="cuda",
):
    """BASELINE config 4: a shared-backbone batch of ``num_cams`` cameras and
    the camera-batched tracker, through ``MultiCamPipeline.chunk_step``. The
    rate counts camera-frames (the detector batch is chunk * num_cams).

    preset: ``configs/<preset>.yaml``, ``chunk_frames`` set to ``chunk``.
    src_hw: the frames' size
    before the device letterbox (e.g. (640, 960), a 1280x1920 frame after
    ``decode_scale_denom`` 2).
    """
    from waymo_2d_tracking_tpu_torch.pipeline.multicam import MultiCamPipeline
    from waymo_2d_tracking_tpu_torch.tracker import init_multicam_state

    cfg = preset_config(preset)
    cfg = dataclasses.replace(cfg, pipeline=dataclasses.replace(cfg.pipeline, chunk_frames=chunk))
    dev = resolve_device(device)
    pipeline = MultiCamPipeline(cfg, num_cams=num_cams, device=dev, seed=0)

    hw = tuple(src_hw or cfg.detector.image_size)
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 255, (num_frames, num_cams) + hw + (3,), dtype=np.uint8)
    blocks = [torch.from_numpy(frames[i:i + chunk]).to(dev)
              for i in range(0, num_frames, chunk)]
    pipeline.ensure_calibrated(blocks[0], hw)

    def step(states, block):
        return pipeline.chunk_step(states, block, hw)

    _warm(step, init_multicam_state(cfg, num_cams, device=dev), blocks).valid.cpu()

    def run_once():
        states = init_multicam_state(cfg, num_cams, device=dev)
        for block in blocks:
            states, outputs, _ = step(states, block)
        return outputs

    fps = num_frames * num_cams / _best_of_3(run_once, repeats)
    # the production row keeps its metric name, the other presets name theirs
    name = ("detect_track_multicam_camframes_per_sec_per_chip" if preset == "production"
            else f"detect_track_multicam_{preset}_camframes_per_sec_per_chip")
    return {
        "metric": name,
        "value": round(fps, 1),
        "unit": "camera-frames/sec/chip",
        "vs_baseline": round(fps / BASELINE_FPS, 3),
    }
