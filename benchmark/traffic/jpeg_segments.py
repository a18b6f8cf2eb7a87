"""Closed-loop segments of JPEG bytes: the ``segments`` traffic
(``traffic/segments.py``, loaded by path as a private copy whose unit maker
this module replaces) with every frame of the bank JPEG-encoded in set-up by
OpenCV (baseline: sequential, standard Huffman tables; the traffic file's
``jpeg`` quality and chroma subsampling). Each segment reaches the program as
``SegmentFrames(jpeg_frames=...)``, so its prefetch worker decodes each chunk
with the native batch decoder at ``decode_scale_denom`` (libjpeg's
DCT-scaled decode) before the chunk crosses to the card, as the preset's
deployments do with Waymo's camera JPEGs.

The check gets the frames decoded apart from the program, by OpenCV's own
libjpeg with the same DCT-scaled method (``cv2.IMREAD_REDUCED_COLOR_<d>``),
with ``denom`` 1 since they are already at the scaled size. The largest
pixel difference between the two decoders over the checked frames, and the
bank's JPEG bytes a frame, are reported beside the check (``seen``).
"""
from __future__ import annotations

import functools
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from benchmark.harness import spec

_base = spec.load_module(os.path.join(os.path.dirname(os.path.abspath(__file__)), "segments.py"),
                         "_bench_jpeg_segments_base")
setup, window, stretch, close = _base.setup, _base.window, _base.stretch, _base.close
THREADS = min(8, os.cpu_count() or 1)
DIFF = "jpeg decoders' largest pixel difference"


def _segments(ctx, unit: int, frames: int = None):
    from waymo_2d_tracking_tpu_torch.pipeline.run import SegmentFrames
    g = unit % ctx.cellf["bank_groups"]
    ts = _base._timestamps(ctx)[:frames]
    return [SegmentFrames(context_name=f"ctx{unit:05d}", camera_name=c + 1, timestamps=ts,
                          jpeg_frames=ctx.jpegs[g][c][:frames]) for c in range(ctx.cams)]


_base._segments = _segments


def encode(bank: np.ndarray, jpeg: dict, threads: int = THREADS) -> list:
    """(groups, cams, frames, H, W, 3) uint8 RGB -> [group][camera] lists of
    each frame's JPEG bytes."""
    import cv2
    subsampling = {"4:4:4": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
                   "4:2:2": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
                   "4:2:0": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420}[jpeg["subsampling"]]
    params = [cv2.IMWRITE_JPEG_QUALITY, int(jpeg["quality"]),
              cv2.IMWRITE_JPEG_SAMPLING_FACTOR, subsampling,
              cv2.IMWRITE_JPEG_PROGRESSIVE, 0, cv2.IMWRITE_JPEG_OPTIMIZE, 0]

    def one(frame):
        ok, buf = cv2.imencode(".jpg", cv2.cvtColor(frame, cv2.COLOR_RGB2BGR), params)
        if not ok:
            raise RuntimeError("OpenCV could not encode a frame")
        return buf.tobytes()

    with ThreadPoolExecutor(threads) as pool:
        return [[list(pool.map(one, bank[g, c])) for c in range(bank.shape[1])]
                for g in range(bank.shape[0])]


def reference_decode(blobs, denom: int, threads: int = THREADS) -> np.ndarray:
    """JPEG bytes -> (N, ceil(H / denom), ceil(W / denom), 3) uint8 RGB by
    OpenCV's DCT-scaled decode."""
    import cv2
    flag = {1: cv2.IMREAD_COLOR, 2: cv2.IMREAD_REDUCED_COLOR_2, 4: cv2.IMREAD_REDUCED_COLOR_4,
            8: cv2.IMREAD_REDUCED_COLOR_8}[denom]

    def one(blob):
        img = cv2.imdecode(np.frombuffer(blob, np.uint8), flag)
        if img is None:
            raise RuntimeError("OpenCV could not decode a frame")
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)

    with ThreadPoolExecutor(threads) as pool:
        return np.stack(list(pool.map(one, blobs)))


def program_decode(blobs, denom: int, hw) -> np.ndarray:
    """The same bytes through the program's decoder, for the report only."""
    from waymo_2d_tracking_tpu_torch.data.jpeg import BatchJpegDecoder
    dec = BatchJpegDecoder(-(-hw[0] // denom), -(-hw[1] // denom), scale_denom=denom)
    try:
        return dec.decode(blobs)
    finally:
        dec.close()


def plan(ctx):
    """``segments``' plan, after the bank is encoded (set-up: the control,
    which runs no program, decodes the same bytes)."""
    from benchmark.harness.core import log
    t = time.time()
    ctx.jpegs = encode(ctx.bank_np, ctx.traffic["jpeg"])
    ctx.bank = ctx.bank_np = None          # the program gets the bytes alone
    sizes = np.array([len(b) for g in ctx.jpegs for c in g for b in c])
    log(f"set-up: {sizes.size} frames JPEG-encoded in {time.time() - t:.2f} s on {THREADS} "
        f"threads, {sizes.mean() / 1e6:.4f} MB a frame (min {sizes.min() / 1e6:.4f}, max "
        f"{sizes.max() / 1e6:.4f})")
    ctx.seen = {"jpeg bytes a frame": float(sizes.mean()), DIFF: 0}
    return _base.plan(ctx)


def _batch(ctx, g: int, i: int) -> torch.Tensor:
    """Detector batch ``i`` of bank group ``g`` (frames, cameras inner) as
    the reference decodes it; notes the decoders' difference."""
    chunk, frames = ctx.cfg["pipeline"]["chunk_frames"], ctx.traffic["frames"]
    idx = np.minimum(np.arange(i * chunk, (i + 1) * chunk), frames - 1)
    blobs = [ctx.jpegs[g][c][k] for k in idx for c in range(ctx.cams)]
    ref = reference_decode(blobs, ctx.denom)
    prog = program_decode(blobs, ctx.denom, ctx.hw)
    diff = int(np.abs(ref.astype(np.int16) - prog.astype(np.int16)).max())
    ctx.seen[DIFF] = max(ctx.seen[DIFF], diff)
    return torch.from_numpy(ref)


def artifacts(ctx):
    """``segments``' artifacts with every frame source replaced by the
    reference's decode, already at the scaled size (``denom`` 1)."""
    samples, tracks = _base.artifacts(ctx)
    groups = ctx.cellf["bank_groups"]
    for s in samples:
        u, c = s.key
        s.frames, s.denom = functools.partial(_batch, ctx, u % groups, c), 1
    for t in tracks:
        t.frames, t.denom = functools.partial(_batch, ctx, t.key % groups), 1
    return samples, tracks
