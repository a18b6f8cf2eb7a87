#!/usr/bin/env python3
"""The headline's chunk step on the benchmark's frames against rendered
frames, on the card.

    python3 waymo_2d_tracking_tpu_torch/tools/bench_frames.py

The benchmark rows (``pipeline/bench_e2e.py``) draw uniform noise frames
from ``np.random.default_rng(0)``, as the JAX package's do; ``chip_smoke.py``
phase 3 renders a synthetic scene (``render_video_clip``, 12 objects, seed
3). For one 128-frame chunk of each kind at 640x960, with the headline preset
at ``decode_scale_denom`` 1 and seeded random weights (``chip_smoke.HEADLINE``):
the valid detections and reported tracks a frame, the chunk's detect and
tracker-loop times (CUDA events, median of 5 chunks), ``chunk_step``'s rate
as the benchmark times it (frames on the card, best of 3 groups of 5
passes) and ``run_segment``'s from host frames to records (best of 3). One
JSON line a kind, with the card's name and power limit.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def measure(pipe, frames: np.ndarray) -> dict:
    from waymo_2d_tracking_tpu_torch.pipeline.run import SegmentFrames
    from waymo_2d_tracking_tpu_torch.tracker import init_state
    from waymo_2d_tracking_tpu_torch.tracker.graph import track_chunk

    cfg, n = pipe.cfg, frames.shape[0]
    src_hw = tuple(frames.shape[1:3])
    block = torch.from_numpy(frames).to(pipe.device)

    def fresh():
        return init_state(cfg.tracker, device=pipe.device)

    pipe.chunk_step(fresh(), block, src_hw)[1].valid.cpu()     # warm: capture
    detect_ms, loop_ms = [], []
    for _ in range(5):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        dets, _ = pipe._detect_chunk(block, src_hw)
        ev[1].record()
        _, outs = track_chunk(fresh(), dets, cfg.tracker, pipe._graphs)
        ev[2].record()
        ev[2].synchronize()
        detect_ms.append(ev[0].elapsed_time(ev[1]))
        loop_ms.append(ev[1].elapsed_time(ev[2]))
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(5):
            _, out, _ = pipe.chunk_step(fresh(), block, src_hw)
        out.valid.cpu()
        best = min(best, (time.perf_counter() - t0) / 5)
    seg = SegmentFrames("probe", 1, list(range(n)), frames)
    pipe.run_segment(seg)
    seg_best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        records, _ = pipe.run_segment(seg)
        seg_best = min(seg_best, time.perf_counter() - t0)
    return {
        "detections_per_frame": round(float(dets.valid.sum(-1).float().mean()), 2),
        "tracks_per_frame": round(float(outs.valid.sum(-1).float().mean()), 2),
        "detect_ms": round(statistics.median(detect_ms), 3),
        "tracker_loop_ms": round(statistics.median(loop_ms), 3),
        "chunk_step_frames_per_s": round(n / best, 1),
        "run_segment_frames_per_s": round(n / seg_best, 1),
        "records": len(records),
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_frames: needs a CUDA card", file=sys.stderr)
        return 1
    from waymo_2d_tracking_tpu_torch.config import Config, _update
    from waymo_2d_tracking_tpu_torch.data.synthetic import SyntheticClipConfig, render_video_clip
    from waymo_2d_tracking_tpu_torch.pipeline.run import SegmentPipeline

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    cfg = _update(Config(), {**cs.HEADLINE, "pipeline": {**cs.HEADLINE["pipeline"],
                                                         "decode_scale_denom": 1}})
    chunk = cfg.pipeline.chunk_frames
    pipe = SegmentPipeline(cfg, device="cuda", seed=0)
    kinds = {
        "noise": np.random.default_rng(0).integers(0, 255, (chunk, 640, 960, 3), dtype=np.uint8),
        "rendered": render_video_clip(SyntheticClipConfig(num_frames=chunk, num_objects=12, seed=3),
                                      render_hw=(640, 960))[0],
    }
    for kind, frames in kinds.items():
        print(json.dumps({"frames": kind, "card": card, **measure(pipe, frames)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
