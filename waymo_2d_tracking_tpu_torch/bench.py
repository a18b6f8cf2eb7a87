"""Benchmark harness of the port (counterpart of the root ``bench.py``, which
stays the JAX package's harness). Prints ONE JSON line on stdout:

  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}

  python -m waymo_2d_tracking_tpu_torch.bench              # headline, 640x960 frames
  python -m waymo_2d_tracking_tpu_torch.bench --config1    # tracker only
  python -m waymo_2d_tracking_tpu_torch.bench --config1 --device cpu

The rows and flags are the root ``bench.py``'s; the first that applies, in
this order, runs: ``--host`` (native JPEG decode of 1280x1920 frames),
``--latency`` (``--multicam``: the 5-camera rig tick), ``--fast``,
``--production``, ``--int8`` (without ``--config4``), ``--config4`` (the
production preset; ``--int8`` or ``--headline`` those presets), ``--config5``
(TTA), ``--config1``, else the headline row on 640x960 frames (``--src-full``
1280x1920, ``--src-net`` the network input size). The rows are
``pipeline/bench_e2e.py``'s.

``--device {cuda,cpu}`` (default cuda): without a card the harness exits
non-zero and prints no row unless given ``--device cpu``; it never swaps in
another row or device. An exception ends the run with its traceback and a
non-zero exit. The CUDA kernels are built and found where
``utils/compile_cache.py`` says (``W2T_COMPILE_CACHE``). Each kernel's
launches during the row, and the device, go to stderr.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

# BASELINE config 1: the clip's frames and the timed passes over it
CONFIG1 = {"num_frames": 200, "repeats": 20}

ROW_FLAGS = (
    ("config1", "tracker-only over precomputed detections"),
    ("config4", "5-camera shared-backbone multicam row"),
    ("config5", "TTA e2e row"),
    ("fast", "configs/fast.yaml speed-preset row"),
    ("production", "configs/production.yaml r34 quality row"),
    ("host", "host JPEG-decode ingestion row"),
    ("src_full", "headline row on 1280x1920 frames (device-side resize)"),
    ("src_net", "headline row on frames at the network input size"),
    ("latency", "per-frame online serving latency (p50 ms) on the headline preset; "
                "vs_baseline = 10Hz real-time margin"),
    ("multicam", "with --latency: the 5-camera rig tick"),
    ("headline", "with --config4: the headline preset"),
    ("int8", "configs/headline_int8.yaml row (with --config4: its multicam row)"),
)


def bench_tracker_only(num_frames=200, repeats=20, device="cuda"):
    """BASELINE config 1: SORT-style tracking over precomputed detections,
    ``Tracker.run`` (on the card the captured step replayed a frame)."""
    from waymo_2d_tracking_tpu_torch.config import TrackerConfig
    from waymo_2d_tracking_tpu_torch.data.synthetic import SyntheticClipConfig, generate_clip
    from waymo_2d_tracking_tpu_torch.pipeline.bench_e2e import BASELINE_FPS
    from waymo_2d_tracking_tpu_torch.tracker import Tracker

    dets, _ = generate_clip(SyntheticClipConfig(num_frames=num_frames, num_objects=12, seed=0))
    tracker = Tracker(TrackerConfig(max_tracks=64, max_detections=64, embed_dim=0),
                      device=device)
    dets = dets.to(tracker.device)
    _, outs = tracker.run(dets)      # warm: the captured step is built here
    outs.valid.cpu()
    t0 = time.perf_counter()
    for _ in range(repeats):
        _, outs = tracker.run(dets)
    outs.valid.cpu()
    dt = (time.perf_counter() - t0) / repeats
    fps = num_frames / dt
    return {
        "metric": "tracker_only_frames_per_sec_per_chip",
        "value": round(fps, 1),
        "unit": "frames/sec/chip",
        "vs_baseline": round(fps / BASELINE_FPS, 3),
    }


def bench_detect_track(num_frames=128, repeats=5, preset="headline", src_hw=None, metric=None,
                       device="cuda"):
    """End-to-end detect + track on seeded frames with ``configs/<preset>.yaml``
    (the headline metric). src_hw=(1280, 1920) adds the device-side resize
    of Waymo-native frames."""
    from waymo_2d_tracking_tpu_torch.pipeline.bench_e2e import (
        preset_config,
        run_detect_track_bench,
    )

    return run_detect_track_bench(
        num_frames=num_frames, repeats=repeats, config=preset_config(preset), src_hw=src_hw,
        metric=metric or f"detect_track_{preset}_frames_per_sec_per_chip", device=device,
    )


def bench_tta(num_frames=32, repeats=3, device="cuda"):
    """BASELINE config 5: multi-scale + flip TTA detect + track."""
    from waymo_2d_tracking_tpu_torch.pipeline.bench_e2e import run_detect_track_bench

    return run_detect_track_bench(
        num_frames=num_frames, repeats=repeats, image_hw=(640, 960), chunk=8, tta=True,
        metric="detect_track_tta_frames_per_sec_per_chip", device=device,
    )


def bench_host_ingestion(num_frames=64, hw=(1280, 1920), repeats=5):
    """Host JPEG decode throughput of the native batch decoder
    (``data/jpeg.py``) on Waymo-native-size frames, encoded with cv2 at
    quality 90. The port's decoder is native or raises."""
    import numpy as np

    from waymo_2d_tracking_tpu_torch.data.jpeg import BatchJpegDecoder
    from waymo_2d_tracking_tpu_torch.data.video import import_cv2
    from waymo_2d_tracking_tpu_torch.pipeline.bench_e2e import BASELINE_FPS

    cv2 = import_cv2()
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 255, (num_frames,) + hw + (3,), np.uint8)
    jpegs = [cv2.imencode(".jpg", f[:, :, ::-1], [cv2.IMWRITE_JPEG_QUALITY, 90])[1].tobytes()
             for f in frames]
    dec = BatchJpegDecoder(hw[0], hw[1])
    try:
        dec.decode(jpegs[:4])   # warm the pool
        t0 = time.perf_counter()
        for _ in range(repeats):
            dec.decode(jpegs)
        dt = (time.perf_counter() - t0) / repeats
    finally:
        dec.close()
    per_sec = num_frames / dt
    cores = os.cpu_count() or 1
    return {
        "metric": "host_jpeg_decodes_per_sec",
        "value": round(per_sec, 1),
        "unit": (f"decodes/sec ({hw[0]}x{hw[1]}, native=True, cores={cores}, "
                 f"per_core={per_sec / cores:.1f})"),
        # SURVEY.md section 7: 1500 frames/s a chip on 8 chips needs ~12k
        # decodes a second on the host
        "vs_baseline": round(per_sec / (8 * BASELINE_FPS), 3),
    }


def run_row(args) -> dict:
    """The row the flags select (module docstring)."""
    from waymo_2d_tracking_tpu_torch.pipeline.bench_e2e import (
        run_multicam_bench,
        run_online_latency_bench,
    )

    dev = args.device
    if args.host:
        return bench_host_ingestion()
    if args.latency:
        return run_online_latency_bench(multicam=args.multicam, device=dev)
    if args.fast:
        return bench_detect_track(preset="fast", device=dev)
    if args.production:
        return bench_detect_track(preset="production", device=dev)
    if args.int8 and not args.config4:
        return bench_detect_track(preset="headline_int8", src_hw=(640, 960), device=dev)
    if args.config4:
        # chunk 16: an 80-image shared-backbone batch, on 640x960 frames (a
        # 1280x1920 frame after decode_scale_denom 2)
        preset = "headline_int8" if args.int8 else "headline" if args.headline else "production"
        return run_multicam_bench(num_frames=64, chunk=16, preset=preset, src_hw=(640, 960),
                                  device=dev)
    if args.config5:
        return bench_tta(device=dev)
    if args.config1:
        return bench_tracker_only(device=dev, **CONFIG1)
    src_hw = (1280, 1920) if args.src_full else None if args.src_net else (640, 960)
    return bench_detect_track(src_hw=src_hw, metric="detect_track_frames_per_sec_per_chip",
                              device=dev)


def row_argv(args) -> list:
    """The harness's command-line flags for parsed ``args``."""
    flags = ["--" + name.replace("_", "-") for name, _ in ROW_FLAGS if getattr(args, name)]
    return flags + ["--device", args.device]


def add_arguments(p: argparse.ArgumentParser) -> None:
    """The row flags and ``--device`` (the harness's and ``cli bench``'s)."""
    for name, text in ROW_FLAGS:
        p.add_argument("--" + name.replace("_", "-"), dest=name, action="store_true", help=text)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the row runs (default cuda; exits non-zero without a card)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m waymo_2d_tracking_tpu_torch.bench",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_arguments(p)
    return p


def _counters() -> dict:
    from waymo_2d_tracking_tpu_torch.models.quant import int8_gemm
    from waymo_2d_tracking_tpu_torch.ops import assign, nms, roi_align, topk

    return {"nms_mask": nms.nms_mask_cuda, "auction": assign.auction_kernel_cuda,
            "topk_threshold": topk.topk_threshold_cuda, "roi_align": roi_align.roi_align_cuda,
            "int8_gemm": int8_gemm}


def main(argv=None) -> int:
    import torch

    args = build_parser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("bench: torch.cuda.is_available() is False; this harness measures the card "
              "(pass --device cpu to run the row on the CPU)", file=sys.stderr)
        return 1
    from waymo_2d_tracking_tpu_torch.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    row = run_row(args)
    where = torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu"
    print(f"# device: {where}", file=sys.stderr)
    print("# kernel launches: "
          + json.dumps({k: fn.launches for k, fn in counters.items()}), file=sys.stderr)
    print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
