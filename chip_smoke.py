#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``waymo_2d_tracking_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failed check raises, and the script exits non-zero):

0. the card (``nvidia-smi`` name and power limit), then ``nvcc`` builds all
   five CUDA kernels from ``waymo_2d_tracking_tpu_torch/csrc/`` in parallel;
1. each kernel against its plain PyTorch version on the card at the main
   path's shapes, timed by CUDA events around a call (``ms``, the measure
   of every run so far; it holds the host's time to reach the launch too)
   and, beside that, by its device time in a ``torch.profiler`` trace
   (``device_ms``): NMS keep-masks bit-equal at (B=128, N=1024) with class
   offsets, on the chain and invalid cases, at N=2048 and N=4096 (B=8), N=33
   and N=1, on an image with nothing valid, on 1024 copies of one box, on a
   chain of 64 boxes that each overlap only their neighbours, on pairs whose
   IoU lies within a few float32 steps of the threshold either side, at a
   negative and a zero threshold and on an unaligned tensor, timed at
   (128, 1024), (8, 1024) and (128, 2048), each beside its bound, with the
   kernel's own ``clock64`` readings of its phases, and past the 8192 boxes
   that fit shared memory at (1, 8193) and (2, 10240), timed beside their
   bounds;
   auction row -> col equal on a batch of 256 tracker-like problems at n=64
   and a few at n = 32, 96, 128 (one warp a problem) and 256, 384 (one CTA a
   problem), and within n * eps_min of scipy on a sample, timed for one
   problem, for the 256 in one launch, at n = 256 and 384 and on config 4's
   launch (5 cameras at n = 128), each beside its bound; the top-k threshold
   bit-equal at the headline's P3 size (N=14112, k=512, one vector and the
   chunk's 128 at once), at N=28800, on ties, on the large-magnitude snap
   case, at k = 1 and k = N, on an all-equal vector, on a geometric spread
   from 1e-30 to 1e30 (six rounds of the plain search), on subnormals, and by
   value on signed zeros at the k-th position, timed beside
   ``torch.kthvalue``; RoIAlign at
   the headline ReID shape (P3 56x84x128, 64 RoIs, 7x7, sampling 2) within
   1e-5 in float32 and one bf16 ulp in bfloat16, on boxes partly outside the
   map, on a 2-row map, at C = 100, 8 and 3 (no 16-byte vector divides them
   all) with zero-width, inverted and wholly outside boxes on an aligned and
   an unaligned feature tensor, timed beside the matmul form for one image
   and for a chunk of 128 images, each beside its bound;
1w. the Swin window-attention kernel (``csrc/window_attention.cu``) in bf16
   against its plain path in float32 on the same inputs, at the 40-image
   shapes of Swin-T's four stages at 640x960 (config 4's chunk in one
   forward), with shift 0 and 3, at ``tests/test_torch_swin.py``'s
   tolerance; each launch timed beside the plain path in bf16 and its bound;
1b. ``area_downscale`` (the ``decode_scale_denom`` downscale) on the card
   byte-equal to the same function on CPU tensors at d = 2 and 4 on
   1280x1920, 886x1920 and 67x99 frames, with the time of a 128-frame
   chunk; the prefetcher's pinned ring under a slow consumer at depth 1 and
   2, every chunk intact;
1c. the tracker's appearance update (``lifecycle.ema_normalize``, XLA's
   arithmetic) and the ReID head's normalization on the card bit-equal to
   the CPU on random inputs (E = 128, 32, 16; 5 cameras), timed; the hostile
   clip ``curved_pan`` through ``Tracker.run`` on the card and the CPU: MOTA /
   IDF1 / IDSW, the first frame whose ids differ, the card's MOTA >= 0.73;
2. the trained fixtures in float32 with TF32 off through the whole slice:
   seed-5 and dense-clip MOTA/IDF1/IDSW floors, the ReID recovery gain, and
   the seed-5 clip with test-time augmentation (flip, scales 1.0 and 0.75)
   against the JAX package's metrics; both clips as two cameras of one
   ``MultiCamPipeline.run_segments_group`` (JSONL read back), each camera
   exactly its single-camera metrics; the seed-5 clip frame by frame through
   ``OnlineTracker``, the chunked run's records; the NMS and auction
   counters rising; with ``quant='int8'`` (scope 'trunk') both clips
   through ``run_segment`` (calibrated on the first chunk) above the JAX
   test's floors and beside the JAX CPU metrics, the seed-5 clip frame by
   frame through an int8 ``OnlineTracker`` (calibrated on its first frame),
   and an uncalibrated int8 detect refused;
2b. ingest: the committed TFRecord fixture through the native scanner
   (index, metadata, JPEG bytes against the Python walk and the committed
   SHA-256), the machine's libjpeg probed, the decoder shim built by the
   route that finds libjpeg (the system's, or Pillow's bundled
   libjpeg-turbo against the vendored headers) with the loaded library
   printed, every frame's decode equal to the committed SHA-256 at denom 1,
   2 and 4, and the JPEG bytes through ``run_segment`` and
   ``OnlineTracker`` under ``headline_int8`` against the same frames
   decoded;
3. eight main paths at full width in bf16 (one with int8 trunk convs) with
   seeded random weights,
   kernel counts set to 0 just before each run and read just after (a
   replay of the captured tracker step counts the launches it recorded):
   after a warm-up chunk, the headline preset (``configs/headline.yaml``) on
   640x960 frames at ``decode_scale_denom`` 1 and, as shipped, at its own
   denom 2 on 1280x1920 frames (the render upscaled 2x: the card's downscale
   must give the render back byte for byte, the records lie in 1280x1920
   pixels), ``headline_int8`` (``configs/headline_int8.yaml``, the w8a8
   trunk, as shipped at denom 2 on the same 1280x1920 frames: int8 GEMMs a
   chunk, which must be 0 on every other path, its forward beside the bf16
   one, and its quantized convs timed alone: the GEMM, the whole int8 conv
   and the bf16 cuDNN conv they replace), its CenterNet twin
   (``configs/headline_centernet.yaml``), 3 runs
   of 2 chunks of 128 frames each, and the headline with TTA, 2 runs of 1
   chunk; for each frames/s, launch counts (exactly 1 NMS a chunk and 1
   auction a stage and frame) and the split of a chunk, already on the card,
   into downscale / letterbox / detector forward / candidates + NMS +
   RoIAlign + ReID / tracker loop (the captured step replayed) / the eager
   loop on the same chunk (CUDA events), the graph's state and outputs
   bit-identical to the eager loop's; for the headline, as a separate
   measurement, the device's busy share of 3 traced chunks
   (``torch.profiler``), each from its own trace, and the auction and NMS
   kernels' device time in each, and the eager loop and the replays under
   ``set_sync_debug_mode('error')``. Then ``config4_multicam``
   (``configs/config4_multicam.yaml``, 5 cameras of 1280x1920 frames
   through ``MultiCamPipeline.run_segments_group``, a warm-up chunk and 2
   runs of 4 chunks of 8 frames: camera-frames/s, peak memory, the split,
   launches per chunk, which must be 1 NMS at B = 40 and 8 auction at P = 5;
   the captured step at P = 5, n = 128 bit-identical to the eager loop),
   ``config4_swin_t`` (the same rig and frames with the Swin-T backbone:
   launches per chunk 1 NMS, 8 auction and 12 window attention, one a
   block of the 40-image forward, which every other path launches 0 times),
   ``online_rig`` (``OnlineMultiCamTracker`` on the same config and frames,
   32 ticks after a warm-up: latency percentiles, 1 NMS and 1 auction
   launch a tick) and ``online_headline`` (``OnlineTracker`` on the
   headline, 64 frames of 640x960 after a warm-up).
P. the shipped presets no other phase runs, each read from ``configs/`` by
   the port's ``load_config`` at full width in bf16 with seeded random
   weights, config 4's lowered tracker gates on the ResNet-50 presets, a
   warm-up chunk then 2 runs of 2 chunks (after config 4, on its rig
   frames): P2 ``config2_detector_iou`` and P3 ``config3_reid_fused`` (one
   1280x1920 camera, chunk 8) and P4 ``robust`` (the headline's frames at
   1280x1920, decoded at its denom 2, three association stages) through
   ``phase_main_path``; P5 ``config5_full_sweep`` (5 cameras, chunk 4, six
   TTA views up to 1600x2400) through ``MultiCamPipeline
   .run_segments_group``, its split timing every view alone. For each:
   frames/s (camera-frames/s), peak memory, the split, NMS and auction
   launches equal to the count the config gives, the captured step equal to
   the eager loop, one chunk's NMS inputs and one frame's benefit tensors
   (every stage) taken from the path through ``csrc/nms.cu`` /
   ``csrc/auction.cu`` and their plain versions, bit-equal, and ``cli track
   --config configs/<preset>`` (``--multicam`` for P5) on a directory
   segment written by ``materialize_directory_segment``, byte-equal to the
   driver called directly; P5 also holds each camera to a single-camera
   ``SegmentPipeline`` on its frames (float32, the rig's batch), byte for
   byte.

T. training (``train/train.py``): T1 one ``train_step`` at the tiny parity
   config (float32, TF32 off) on the card and on the CPU from the same
   weights and batch, AdamW and SGD, accumulation 2, EMA and remat on, the
   loss, gradients, updates, EMA and BatchNorm buffers within stated
   tolerances; T2 the learning proof (slim 64x96, batch 8, 300 steps on one
   batch through ``train_loop`` with validation): loss halved, recall@0.5
   <= 0.2 untrained and >= 0.6 trained through ``detect`` (the NMS kernel),
   and a checkpoint restored and stepped 5 times bit-equal to 5 steps
   without it; T3 the pixel fixture's recipe
   (``tools/train_pixels_fixture.py``, 800 steps at batch 16, and its ReID
   variant) with its recall and separation gates, then the pixel-golden
   clips and the ReID recovery clip on the port-trained weights beside the
   committed fixture's metrics (reported); T4 five timed steps after two
   warm-up steps at the headline width (batch 16, bf16, ReID loss 0.5) and
   config 4 (batch 8; remat off and on; accumulation 2): steps/s, images/s,
   peak memory, the loss, a forward / loss / backward / optimizer split by
   CUDA events and one traced step's busy share and top kernels.

S. the serving daemon (``cli serve`` in a thread, on AF_UNIX sockets in
   ``scratch_dir()``; every reply checked for ``ok: true``): S1 the
   trained fixture (slim, f32) with the seed-5 clip as raw payloads, bit-equal
   to phase 2's direct ``OnlineTracker`` and so its golden metrics; S2 the
   headline at full width (640x960 raw, seeded weights, gates lowered): 64
   frames bit-equal to a direct session, 1 NMS and 2 auction launches a
   frame, latency through the socket beside the direct session's, a snapshot
   after frame 8 restored into a second server traced with ``--profile``
   (both kernels' names in the trace) and a ``--state-file`` restart, each
   continuing as the uninterrupted run, and the ingest fixture's 1280x1920
   JPEGs through a ``headline_denom2`` server warmed with ``--warmup 1280
   1920``; S3 ``serve --multicam`` at config 4, 8 rig ticks of five 1280x1920
   raw frames equal to a direct ``OnlineMultiCamTracker``.
C. the command line on the card: ``track --segments-dir`` on the ingest
   TFRecord against ``run_segments``, ``track --online``, ``detect``;
   ``draw`` into JPEGs and an MJPG video, and ``track --video`` on that
   video against a direct ``OnlineTracker``; ``tune --trials 4`` on the
   card, with 2 workers and on the CPU; ``export --platform cuda`` reloaded
   against ``DetectorRunner.detect``; ``--compile-cache`` (a second process
   runs no ``nvcc``); ``doctor``. Each verb's launches are counted around
   that verb alone.
D. the distributed slice, ranks spawned on cuda:0 by
   ``parallel/launch.py run_ranks`` (``tools/rank_cases.py`` bodies, frames
   mapped from ``.npy`` files, each rank counting its own launches from 0):
   two ranks over gloo run D1-D4, one rank over NCCL their world-1 cases, and
   NCCL on two ranks sharing the card is refused. D1 the headline (denom 1)
   on three 640x960 segments of 150 / 60 / 90 frames through
   ``run_segments_sharded``: JSONL byte-equal and sidecars bit-equal to
   ``run_segments`` on the card, the manifest, a rerun, detections only
   against ``run_segment``, one segment at world 1; D2 config 4, two contexts
   of five 1280x1920 cameras (16 frames, chunk 8) through
   ``run_context_groups_sharded`` against ``run_context_groups``; D3 one
   data-parallel step at the headline's width (batch 16, 8 a rank, ReID on;
   plain, accumulation 2, remat) against the single-device step in float32
   (TF32 off) and in bf16, params and EMA bit-equal across the ranks after 3
   steps, the checkpoint, steps/s of two ranks sharing the card, held-out AP
   of the replicated weights; D4 the ring against JAX's rule written out,
   ties included, at world 2 and 1, and ``link_tracks`` with the mesh on D1's
   and D2's sidecars against the dense scoring; D5 ``track``, ``detect``,
   ``link`` and ``train --steps 1`` with ``--sharded`` as two processes
   through the ``W2T_*`` variables against the unsharded verbs. D's files
   are removed at its end.

The last two lines are the kernels' JSON record and the device record. It
imports no JAX, nothing of the JAX package and no cv2.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import threading
import time

# configs/headline.yaml, as a dict (the card machine need not have pyyaml);
# a CPU test pins it to the yaml file.
HEADLINE = {
    "detector": {
        "image_size": [448, 672],
        "backbone": "resnet18",
        "stem": "s2d",
        "fpn_channels": 128,
        "fpn_levels": [3, 4, 5, 6],
        "head_channels": 128,
        "head_depth": 2,
        "reid_channels": 128,
        "embed_dim": 128,
        "max_detections": 64,
    },
    "tracker": {
        "max_tracks": 64,
        "max_detections": 64,
        "embed_dim": 128,
        "appearance_weight": 0.3,
        "assignment": "auction",
        "reid_recovery": True,
        "max_lost_age": 30,
        "gallery_size": 4,
    },
    "pipeline": {
        "cameras": ["FRONT"],
        "chunk_frames": 128,
        "decode_scale_denom": 2,
    },
}

# configs/headline_centernet.yaml: the headline with the CenterNet head family
HEADLINE_CENTERNET = {
    **HEADLINE,
    "detector": {**HEADLINE["detector"], "head_family": "centernet", "centernet_level": 3},
}

# configs/headline_int8.yaml: the headline with a w8a8 int8 trunk (backbone
# and FPN; quant_scope 'trunk'); a CPU test pins it to the yaml file.
HEADLINE_INT8 = {**HEADLINE, "detector": {**HEADLINE["detector"], "quant": "int8"}}

# configs/config4_multicam.yaml (BASELINE config 4: 5 cameras, one shared
# detector batch, per-camera trackers): the default ResNet-50 / FPN P3-P7
# detector at 640x960 with ReID 128, the auction tracker at S = D = 128,
# chunk 8; a CPU test pins it to the yaml file.
CONFIG4 = {
    "detector": {"image_size": [640, 960], "embed_dim": 128},
    "tracker": {"embed_dim": 128, "appearance_weight": 0.3},
    "pipeline": {
        "cameras": ["FRONT", "FRONT_LEFT", "FRONT_RIGHT", "SIDE_LEFT", "SIDE_RIGHT"],
        "chunk_frames": 8,
    },
}

# Seeded random ResNet-50 weights score at most ~0.23, under config 4's
# tracker gates (score 0.5, birth 0.6): no detection would reach the tracker
# and every auction problem would be empty. The config-4 runs lower these
# two gates so the tracker births, associates and solves real problems; a
# cut of thresholds, not of any width.
CONFIG4_RANDOM_WEIGHT_GATES = {"score_threshold": 0.1, "birth_score_threshold": 0.15}

# Published H100 SXM peaks (dense): HBM bandwidth, and float32 outside the
# tensor cores (every kernel here does scalar f32 / integer work); int8 on
# the tensor cores for the int8 GEMMs of the quantized trunk.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
PEAK_INT8_OPS_PER_S = 1979e12

# tests/golden/test_pixels_to_mota.py and test_reid_recovery.py settings
PIXELS_DET = dict(
    backbone="resnet18slim", image_size=(256, 384), fpn_channels=32,
    fpn_levels=(3, 4, 5), head_depth=2, head_channels=32,
    pre_nms_topk=128, nms_topk=256, max_detections=32, embed_dim=0,
    dtype="float32", score_threshold=0.3,
)
PIXELS_TRK = dict(
    max_tracks=32, max_detections=32, embed_dim=0, n_init=2, max_age=5,
    iou_threshold=0.3, score_threshold=0.55, birth_score_threshold=0.65,
)

# The JAX package's int8 metrics on the two pixel clips (quant_scope 'trunk',
# CPU; tests/golden/test_pixels_to_mota.py test_int8_quality_through_trained_fixture)
# and that test's floors (MOTA >=, IDF1 >=, IDSW <=).
INT8_JAX_REF = {"seed5": {"mota": 0.6912, "idf1": 0.8504, "num_idsw": 8},
                "dense": {"mota": 0.4246, "idf1": 0.6746, "num_idsw": 6}}
INT8_FLOORS = {"seed5": (0.66, 0.82, 10), "dense": (0.40, 0.65, 8)}

# The JAX package's metrics on the seed-5 clip with TTA (flip, scales 1.0 and
# 0.75), chunk 16, on the CPU: tools/jax_reference_seed5_tta.py.
SEED5_TTA_REF = {"mota": 0.45421903052064627, "idf1": 0.7574221578566256, "num_idsw": 9}
SEED5_TTA_TOL = {"mota": 0.01, "idf1": 0.01, "num_idsw": 1}


def log(*args):
    print(*args, flush=True)


def cuda_time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs, in ms."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps: int, per: int = 1):
    """Device time of one call of ``fn`` over ``per``, in ms, from one
    ``torch.profiler`` trace of ``reps`` calls: for each kernel or copy
    name, the mean length of its device intervals times how many of them a
    call makes, summed; None when the trace holds no device interval.
    Unlike ``cuda_time_ms`` it leaves out the host's time to reach the
    launch, which exceeds a short kernel's own time. A trace can lose its
    last few device intervals, so the time is not the recorded total over
    ``reps``, and a call's count is rounded up; a name whose count is not a
    multiple of ``reps`` is logged."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    total = 0.0
    for name, lengths in by_name.items():
        if len(lengths) % reps:
            log(f"[1] note: the trace holds {len(lengths)} device intervals of {name[:60]} "
                f"for {reps} calls")
        total += statistics.fmean(lengths) * math.ceil(len(lengths) / reps)
    if total <= 0:
        log("[1] note: the trace holds no device interval")
        return None
    return total / 1e3 / per


def ms_text(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def bound(bytes_moved: float, ops: float):
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ----------------------------------------------------------------- phase 1

def nms_inputs(torch, b: int, n: int, seed: int):
    """Score-sorted candidate boxes like the detector's: clusters of
    overlapping boxes around objects plus clutter, class offsets 1e5."""
    g = torch.Generator().manual_seed(seed)
    centers = torch.rand(b, 40, 2, generator=g) * torch.tensor([672.0, 448.0])
    sizes = 20 + torch.rand(b, 40, 2, generator=g) * 140
    obj = torch.randint(0, 40, (b, n), generator=g)
    jitter = torch.randn(b, n, 4, generator=g) * 6
    c = torch.gather(centers, 1, obj[..., None].expand(-1, -1, 2))
    s = torch.gather(sizes, 1, obj[..., None].expand(-1, -1, 2))
    boxes = torch.cat([c - s / 2, c + s / 2], dim=-1) + jitter
    boxes[..., 2:] = torch.maximum(boxes[..., 2:], boxes[..., :2] + 1)
    classes = torch.randint(0, 3, (b, n, 1), generator=g).float()
    boxes = boxes + classes * 1e5
    valid = torch.rand(b, n, generator=g) > 0.1
    return boxes.contiguous(), valid.contiguous()


def near_threshold_pairs(torch, thr: float):
    """(M, 64, 4) boxes and (M, 64) valid: in each image a kept box A at slot 0
    and one box B whose IoU with A lies a few float32 steps from ``thr``,
    found by bisection on B's right edge in float32 on the host; B sits at
    slot 1 (A's own block of 32) or at slot 40 (a later block), every other
    slot is invalid. Steps of 1-3 values either side stay inside the band
    where the kernel divides, 16 and 64 leave it."""
    from waymo_2d_tracking_tpu_torch.ops.iou import pairwise_iou

    images = []
    for a, offset in (([10.3, 20.7, 131.9, 97.2], 0.0), ([3.0, 5.0, 61.5, 40.25], 2e5),
                      ([100.1, 50.2, 180.7, 222.9], 1e5)):
        a = torch.tensor(a, dtype=torch.float32) + offset

        def box_b(bits):
            b = a.clone()
            b[2] = torch.tensor(bits, dtype=torch.int32).view(torch.float32)
            return b

        def hit(bits):
            return bool(pairwise_iou(a[None], box_b(bits)[None])[0, 0] > torch.tensor(thr))

        # IoU grows with B's right edge between A's left and right edges
        lo = int((a[0] + 1).view(torch.int32))
        hi = int(a[2].view(torch.int32))
        if hit(lo) or not hit(hi):
            raise AssertionError("near-threshold bisection: the ends do not bracket thr")
        while hi - lo > 1:
            mid = (lo + hi) // 2
            lo, hi = (lo, mid) if hit(mid) else (mid, hi)
        for step in (-64, -16, -3, -2, -1, 0, 1, 2, 3, 16, 64):
            for slot in (1, 40):
                boxes = torch.zeros(64, 4)
                valid = torch.zeros(64, dtype=torch.bool)
                boxes[0], boxes[slot] = a, box_b(hi + step)
                valid[0] = valid[slot] = True
                images.append((boxes, valid))
    return (torch.stack([b for b, _ in images]).contiguous(),
            torch.stack([v for _, v in images]).contiguous())


def nms_edge_cases(torch):
    """(name, boxes (B, N, 4), valid (B, N), thr) on the host."""
    def ones(*shape):
        return torch.ones(*shape, dtype=torch.bool)

    big = [nms_inputs(torch, 8, n, seed=20 + n) for n in (2048, 4096)]
    b1000, _ = nms_inputs(torch, 4, 1000, seed=2)
    sparse = torch.rand(4, 1000, generator=torch.Generator().manual_seed(21)) > 0.6
    b33, v33 = nms_inputs(torch, 4, 33, seed=22)
    same = torch.tensor([7.5, 3.25, 90.0, 61.0]).repeat(1, 1024, 1)
    # 64 boxes 10 wide, 6 apart: each overlaps only its neighbours (IoU 0.25)
    x0 = torch.arange(64, dtype=torch.float32) * 6
    chain = torch.stack([x0, torch.zeros(64), x0 + 10, torch.full((64,), 10.0)], dim=-1)[None]
    near, near_valid = near_threshold_pairs(torch, 0.6)
    neg, neg_valid = nms_inputs(torch, 2, 200, seed=23)
    return [
        ("N=2048 B=8", *big[0], 0.6),
        ("N=4096 B=8", *big[1], 0.6),
        ("N=1000 sparse valid", b1000, sparse, 0.5),
        ("N=33", b33, v33, 0.5),
        ("N=1", b33[:, :1].contiguous(), ones(4, 1), 0.5),
        ("nothing valid", b1000, torch.zeros(4, 1000, dtype=torch.bool), 0.5),
        ("1024 copies of one box", same, ones(1, 1024), 0.6),
        ("chain of 64 neighbours", chain, ones(1, 64), 0.2),
        ("near the threshold", near, near_valid, 0.6),
        ("negative threshold", neg, neg_valid, -0.5),
        ("threshold 0 (always divides)", neg, neg_valid, 0.0),
    ]


def nms_bound(valid, keep):
    """Greedy needs the IoU only of pairs (kept i, valid j > i): a box that is
    removed suppresses nothing. 14 operations per pair: 4 max/min, 2 sub,
    2 clamp, 1 mul, add + sub, 1 max, 1 div, 1 compare. 18 bytes a box."""
    v = valid.int()
    valid_after = v.flip(1).cumsum(1).flip(1) - v
    pairs = float((keep.double() * valid_after.double()).sum())
    return (*bound(valid.numel() * 18, 14 * pairs), pairs)


def phase_nms(torch, nms, card):
    dev = torch.device("cuda")
    # --- the headline shape: B = chunk 128, N = nms_topk 1024
    boxes, valid = nms_inputs(torch, 128, 1024, seed=1)
    boxes, valid = boxes.to(dev), valid.to(dev)
    got = nms.nms_mask_cuda(boxes, valid, 0.6)
    want = nms.nms_mask_reference(boxes, valid, 0.6)
    torch.cuda.synchronize()
    nms_err = float((got.int() - want.int()).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"NMS kernel != plain at (128, 1024): "
                             f"{int((got != want).sum())} entries differ")
    chain = torch.tensor([[[0, 0, 10, 10], [6, 0, 16, 10], [12, 0, 22, 10]]],
                         dtype=torch.float32, device=dev)
    keep = nms.nms_mask_cuda(chain, torch.ones(1, 3, dtype=torch.bool, device=dev), 0.2)
    if keep.tolist() != [[True, False, True]]:
        raise AssertionError(f"NMS chain-revival case: {keep.tolist()}")
    kept_of = {}
    for name, b, v, thr in nms_edge_cases(torch):
        b, v = b.to(dev), v.to(dev)
        k = nms.nms_mask_cuda(b, v, thr)
        w = nms.nms_mask_reference(b, v, thr)
        torch.cuda.synchronize()
        if not torch.equal(k, w) or k[~v].any():
            raise AssertionError(f"NMS kernel != plain on {name}: "
                                 f"{int((k != w).sum())} entries differ")
        nms_err = max(nms_err, float((k.int() - w.int()).abs().max()))
        kept_of[name] = (k, v)
    # what the cases are there for
    k, v = kept_of["near the threshold"]
    second = k[:, 1] | k[:, 40]
    if not (second.any() and not second.all()):
        raise AssertionError("near-threshold case: B falls on one side of thr only")
    k, v = kept_of["negative threshold"]              # every pair a hit: the first valid box
    if int(kept_of["1024 copies of one box"][0].sum()) != 1 \
            or kept_of["nothing valid"][0].any() \
            or kept_of["chain of 64 neighbours"][0][0].tolist() != [True, False] * 32 \
            or not torch.equal(k, v.cumsum(1).eq(1) & v):
        raise AssertionError("an NMS edge case kept the wrong boxes")
    # the full sort -> suppress -> select with 2048 candidates (four levels x
    # pre_nms_topk 512, nms_topk 0 or 2048), on the card against the CPU
    b2048, _ = nms_inputs(torch, 2, 2048, seed=27)
    scores = torch.rand(2, 2048, generator=torch.Generator().manual_seed(28))
    on_card = nms.nms_batched(b2048.to(dev), scores.to(dev), 0.6, max_outputs=64,
                              score_threshold=0.05)
    on_host = nms.nms_batched(b2048, scores, 0.6, max_outputs=64, score_threshold=0.05)
    if not all(torch.equal(c.cpu(), h) for c, h in zip(on_card, on_host)):
        raise AssertionError("nms_batched with 2048 candidates: the card and the CPU differ")
    # an unaligned box tensor (contiguous, one float past a 16-byte boundary)
    flat = torch.empty(boxes[:2].numel() + 1, device=dev)
    shifted = flat[1:].view(2, 1024, 4).copy_(boxes[:2])
    if not torch.equal(nms.nms_mask_cuda(shifted, valid[:2].contiguous(), 0.6), want[:2]):
        raise AssertionError("NMS kernel on an unaligned box tensor differs")

    nms_ms = cuda_time_ms(lambda: nms.nms_mask_cuda(boxes, valid, 0.6), reps=30)
    nms_dev_ms = device_ms(lambda: nms.nms_mask_cuda(boxes, valid, 0.6), reps=30)
    nms_plain_ms = cuda_time_ms(lambda: nms.nms_mask_reference(boxes, valid, 0.6),
                                reps=3, warmup=1)
    nms_bound_ms, nms_by, pairs = nms_bound(valid, want)
    log(f"[1] nms kernel == plain at (B=128, N=1024) with class offsets, the chain, an "
        f"unaligned tensor and on {', '.join(kept_of)} ({card}): kernel {nms_ms:.4f} ms "
        f"(median of 30; device time {ms_text(nms_dev_ms)}, one trace of 30 calls), "
        f"plain {nms_plain_ms:.2f} ms (median of 3), bound {nms_bound_ms:.6f} ms ({nms_by}); "
        f"kept {int(want.sum())} of {int(valid.sum())} valid, {pairs:.0f} (kept, later valid) pairs")
    # the kernel's own clock64 readings at the headline shape
    _, cycles = nms.nms_mask_cuda(boxes, valid, 0.6, with_cycles=True)
    med = cycles.double().median(dim=0).values.tolist()
    blocks = boxes.shape[1] // 32
    log(f"[1] nms kernel clock64 cycles per image at (128, 1024), median over the images "
        f"({card}): whole CTA {med[0]:.0f}, prologue (load + in-block words) {med[1]:.0f}, "
        f"the {blocks} owners' turns summed (a block against the boxes kept in the block "
        f"before, its fixpoint, the publication) {med[2]:.0f}, {med[2] / blocks:.0f} a block, "
        f"with {med[3]:.0f} fixpoint rounds in all; the rest is the barriers, the other "
        f"warps' tests of later boxes against the boxes just kept and the write of the mask")
    # two more shapes: a small batch (most SMs idle) and N = 2048
    for b, n, seed in ((8, 1024, 1), (128, 2048, 24)):
        bx, vd = nms_inputs(torch, b, n, seed=seed)
        bx, vd = bx.to(dev), vd.to(dev)
        k = nms.nms_mask_cuda(bx, vd, 0.6)
        if not torch.equal(k, nms.nms_mask_reference(bx, vd, 0.6)):
            raise AssertionError(f"NMS kernel != plain at ({b}, {n})")
        ms = cuda_time_ms(lambda: nms.nms_mask_cuda(bx, vd, 0.6), reps=30)
        dms = device_ms(lambda: nms.nms_mask_cuda(bx, vd, 0.6), reps=30)
        bnd, by, prs = nms_bound(vd, k)
        log(f"[1] nms kernel == plain at (B={b}, N={n}) ({card}): kernel {ms:.4f} ms (median "
            f"of 30; device time {ms_text(dms)}), bound {bnd:.6f} ms ({by}); kept "
            f"{int(k.sum())} of {int(vd.sum())} valid, {prs:.0f} pairs")
    # past the shared-memory size (8192) the kernel keeps its per-box state in
    # device memory: N = 8193 (one box past it) and 10240 (flip TTA at two
    # scales, 4 views x 2560 candidates, nms_topk 0)
    cases = []
    for b, n, seed in ((1, 8193, 31), (2, 10240, 32)):
        bx, vd = nms_inputs(torch, b, n, seed=seed)
        bx, vd = bx.to(dev), vd.to(dev)
        k = nms.nms_mask_cuda(bx, vd, 0.6)
        w = nms.nms_mask_reference(bx, vd, 0.6)
        torch.cuda.synchronize()
        if not torch.equal(k, w):
            raise AssertionError(f"NMS kernel != plain at ({b}, {n}): "
                                 f"{int((k != w).sum())} entries differ")
        nms_err = max(nms_err, float((k.int() - w.int()).abs().max()))
        ms = cuda_time_ms(lambda: nms.nms_mask_cuda(bx, vd, 0.6), reps=20)
        dms = device_ms(lambda: nms.nms_mask_cuda(bx, vd, 0.6), reps=20)
        bnd, by, prs = nms_bound(vd, k)
        cases.append(dict(shape=f"B={b} N={n}", ms=ms, device_ms=dms, bound_ms=bnd, bound_by=by))
        log(f"[1] nms kernel (device-memory variant) == plain at (B={b}, N={n}) ({card}): kernel "
            f"{ms:.4f} ms (median of 20; device time {ms_text(dms)}), bound {bnd:.6f} ms ({by}); "
            f"kept {int(k.sum())} of {int(vd.sum())} valid, {prs:.0f} pairs")
    return dict(max_abs_err=nms_err, ms=nms_ms, plain_ms=nms_plain_ms,
                bound_ms=nms_bound_ms, bound_by=nms_by, device_ms=nms_dev_ms, cases=cases)


def phase_kernels(torch, nms, assign, card):
    dev = torch.device("cuda")
    nms_record = phase_nms(torch, nms, card)

    # --- auction: tracker-like problems through _build_benefit
    def problems(count, r, c, n, seed):
        g = torch.Generator().manual_seed(seed)
        bens, eps0, costs, valids = [], [], [], []
        for _ in range(count):
            cost = torch.rand(r, c, generator=g) * 1.3
            ok = ((torch.rand(r, generator=g) < 0.8)[:, None]
                  & (torch.rand(c, generator=g) < 0.8)[None, :]
                  & (torch.rand(r, c, generator=g) > 0.5))
            b, e = assign._build_benefit(cost.to(dev), ok.to(dev), n, 1e-2)
            bens.append(b)
            eps0.append(e)
            costs.append(cost)
            valids.append(ok)
        return (torch.stack(bens).contiguous(), torch.stack(eps0).contiguous(),
                torch.tensor([bool(v.any()) for v in valids], device=dev), costs, valids)

    kw = dict(eps_scale=0.2, eps_min=1e-2, max_iters=4096)
    auc_err = 0.0
    cases = []

    def auction_bound(ben, bids):
        # Only unassigned rows bid. Per bid: the row's scan of n entries (1
        # sub, 2 compares each), 2 operations for the bid itself and 2
        # compares where its column takes the highest bid.
        pn, n = ben.shape[0], ben.shape[-1]
        return bound(pn * (n * n * 4 + 4 + 1 + n * 4), (3 * n + 4) * float(bids.double().sum()))

    # n = 256 and 384: past the one-warp kernel's 128, one CTA per problem
    for count, n, seed in ((256, 64, 3), (8, 128, 4), (8, 32, 13), (8, 96, 14),
                           (5, 256, 15), (3, 384, 16)):
        ben, eps0, feas, costs, valids = problems(count, n - 7, n - 20, n, seed)
        feas[0] = False                        # one infeasible problem per batch
        got = assign.auction_kernel_cuda(ben, eps0, feas, **kw)
        want, rounds, bids, bidders = assign.auction_kernel_reference(ben, eps0, feas, **kw)
        torch.cuda.synchronize()
        auc_err = max(auc_err, float((got - want).abs().max()))
        if not torch.equal(got, want):
            raise AssertionError(f"auction kernel != plain at n={n}: "
                                 f"{int((got != want).any(dim=1).sum())} problems differ")
        if not (got[0] == -1).all():
            raise AssertionError("infeasible problem was not skipped")
        import numpy as np
        from scipy.optimize import linear_sum_assignment
        for p in range(1, min(9, count)):     # optimality sample vs scipy
            cost, ok = costs[p].numpy(), valids[p].numpy()
            rtc = got[p, : cost.shape[0]].cpu().numpy()
            pairs_ok = [(i, j) for i, j in enumerate(rtc) if 0 <= j < cost.shape[1] and ok[i, j]]
            sub = np.where(ok, cost, 1e6)
            ri, ci = linear_sum_assignment(sub)
            feasible = sub[ri, ci] < 5e5
            if len(pairs_ok) != int(feasible.sum()):
                raise AssertionError(f"auction cardinality {len(pairs_ok)} != scipy {int(feasible.sum())}")
            total = sum(cost[i, j] for i, j in pairs_ok)
            if total > sub[ri, ci][feasible].sum() + n * 1e-2 + 1e-4:
                raise AssertionError(f"auction cost {total} exceeds scipy + n*eps_min")
        per_round = bidders[1:].sum(dim=0).double() / float(rounds[1:].sum())
        log(f"[1] auction kernel == plain on {count} problems at n={n}; "
            f"scipy bound holds on {min(8, count - 1)}; rounds median {int(rounds[1:].median())}, "
            f"bids median {int(bids[1:].median())}; share of rounds with 1 bidder "
            f"{float(per_round[1]):.3f}, with at most 4 {float(per_round[1:5].sum()):.3f}")
        if n == 64:
            batch = (ben, eps0, feas, rounds, bids)
        if n > 128:
            ms = cuda_time_ms(lambda: assign.auction_kernel_cuda(ben, eps0, feas, **kw), reps=10)
            dms = device_ms(lambda: assign.auction_kernel_cuda(ben, eps0, feas, **kw), reps=5)
            bnd, by = auction_bound(ben, bids)
            cases.append(dict(shape=f"P={count} n={n} (one CTA a problem)", ms=ms, device_ms=dms,
                              bound_ms=bnd, bound_by=by))
            log(f"[1] auction kernel at n={n}, {count} problems in one launch ({card}): "
                f"{ms:.4f} ms (median of 10; device time {ms_text(dms)}), bound {bnd:.7f} ms "
                f"({by}); rounds {rounds.tolist()}")

    # config 4's launch: the 5 cameras' stage-1 problems at S = D = 128 in one
    # launch (one warp each)
    ben, eps0, feas, _, _ = problems(5, 128, 128, 128, 17)
    got = assign.auction_kernel_cuda(ben, eps0, feas, **kw)
    want, rounds, bids, _ = assign.auction_kernel_reference(ben, eps0, feas, **kw)
    if not torch.equal(got, want):
        raise AssertionError("auction kernel != plain on the config-4 launch (P=5, n=128)")
    ms = cuda_time_ms(lambda: assign.auction_kernel_cuda(ben, eps0, feas, **kw), reps=20)
    dms = device_ms(lambda: assign.auction_kernel_cuda(ben, eps0, feas, **kw), reps=10)
    bnd, by = auction_bound(ben, bids)
    cases.append(dict(shape="P=5 n=128 (config 4, one warp a problem)", ms=ms, device_ms=dms,
                      bound_ms=bnd, bound_by=by))
    log(f"[1] auction kernel == plain on the config-4 launch (P=5 cameras, n=128) ({card}): "
        f"{ms:.4f} ms (median of 20; device time {ms_text(dms)}), bound {bnd:.7f} ms ({by}); "
        f"rounds {rounds.tolist()}, bids {bids.tolist()}")

    ben, eps0, feas, rounds, bids = batch
    # the 256 problems in one launch, several warps (problems) per CTA
    batch_ms = cuda_time_ms(lambda: assign.auction_kernel_cuda(ben, eps0, feas, **kw), reps=20)
    batch_dev_ms = device_ms(lambda: assign.auction_kernel_cuda(ben, eps0, feas, **kw), reps=10)
    # the main path launches one n=64 problem at a time: time 20 single launches
    singles = [(ben[p:p + 1], eps0[p:p + 1], feas[p:p + 1]) for p in range(1, 21)]

    def run_singles(fn):
        for args in singles:
            fn(*args, **kw)

    auc_ms = cuda_time_ms(lambda: run_singles(assign.auction_kernel_cuda), reps=20) / 20
    auc_dev_ms = device_ms(lambda: run_singles(assign.auction_kernel_cuda), reps=5, per=20)
    auc_plain_ms = cuda_time_ms(lambda: run_singles(assign.auction_kernel_reference),
                                reps=3, warmup=1) / 20
    bids20 = float(bids[1:21].double().mean())
    auc_bound, auc_by = auction_bound(ben[:1], bids[1:21].double().mean()[None])
    log(f"[1] auction single n=64 launch (main-path shape, mean of 20 problems; {card}): "
        f"kernel {auc_ms:.4f} ms (CUDA events over the 20 launches back to back, median of "
        f"20; device time {ms_text(auc_dev_ms)}), plain {auc_plain_ms:.2f} ms, library none, "
        f"bound {auc_bound:.7f} ms ({auc_by}; {float(rounds[1:21].double().mean()):.1f} rounds, "
        f"{bids20:.1f} bids per problem); batch of 256 in one launch, several problems per "
        f"CTA, {batch_ms:.4f} ms (median of 20; device time {ms_text(batch_dev_ms)})")
    return {
        "nms_mask": nms_record,
        "auction": dict(max_abs_err=auc_err, ms=auc_ms, plain_ms=auc_plain_ms,
                        bound_ms=auc_bound, bound_by=auc_by, device_ms=auc_dev_ms, cases=cases),
    }


def fcos_scores(torch, b: int, n_loc: int, seed: int):
    """(b, n_loc * 3) candidate scores like the detector's per-level ones:
    sqrt(sigmoid(class logit) * sigmoid(centerness logit)), random logits."""
    g = torch.Generator().manual_seed(seed)
    cls = torch.randn(b, n_loc, 3, generator=g) * 1.5 - 3.0
    ctr = torch.randn(b, n_loc, 1, generator=g)
    return torch.sqrt(torch.sigmoid(cls) * torch.sigmoid(ctr)).reshape(b, -1).contiguous()


def topk_edge_cases(torch, p3, dev):
    """(name, (1, N) vector, k, compared by value) edge cases of the top-k
    threshold at the headline's P3 size."""
    n = p3.shape[1]
    one = p3[:1]
    g = torch.Generator().manual_seed(12)
    geo = torch.logspace(-30, 30, n, dtype=torch.float64)[torch.randperm(n, generator=g)]
    sub = (1 + torch.rand(n, generator=g) * 99) * 1e-40      # subnormal f32
    sub[::3] *= -1
    sub[: n // 8] = torch.randn(n // 8, generator=g)         # some normal scores above
    # +-0.0 at the k-th position: two positives and six zeros of either sign
    # in every ten scores
    tile = torch.tensor([0.0, -0.0, 2.0, -0.0, 0.0, -1.0, 3.0, -0.0, 0.0, -2.0])
    zeros = tile.repeat(n // 10 + 1)[:n]
    return [
        ("k=1", one, 1, False),
        ("k=N", one, n, False),
        ("all-equal", torch.full((1, n), 0.37, device=dev), 300, False),
        ("geometric 1e-30..1e30", geo.float()[None].to(dev), n - 1, False),
        ("subnormals", sub.float()[None].to(dev), n // 2, False),
        ("signed zeros", zeros[None].to(dev), int((zeros > 0).sum()) + 100, True),
    ]


def phase_topk(torch, topk, card):
    dev = torch.device("cuda")
    k = 512
    p3 = fcos_scores(torch, 128, 56 * 84, seed=6).to(dev)    # headline P3 of a chunk
    big = fcos_scores(torch, 1, 80 * 120, seed=7).to(dev)    # N=28800 (ops/topk.py)
    ties = (torch.round(p3[:1] * 64) / 64).contiguous()
    snap = torch.tensor([[1e9, -1e9, 0.0, 1e-4, 1e-4, -3e8, 2e8]], device=dev)
    err, rounds = 0.0, {}
    cases = [("P3 N=14112", p3[:1], k, False), ("N=28800", big, k, False),
             ("ties", ties, k, False), ("snap", snap, 3, False)]
    for name, vec, kk, by_value in cases + topk_edge_cases(torch, p3, dev):
        vec = vec.contiguous()
        kth, cnt = topk.topk_threshold_cuda(vec, kk)
        want, want_cnt, rounds[name] = topk.topk_threshold_reference(vec, kk, with_rounds=True)
        lib = torch.kthvalue(vec[0], vec.shape[1] - kk + 1).values
        torch.cuda.synchronize()
        err = max(err, float((kth[0] - want).abs()))
        same = (float(kth[0]) == float(want) if by_value
                else torch.equal(kth.view(torch.int32), want.reshape(1).view(torch.int32)))
        if not (same and int(cnt[0]) == int(want_cnt) and float(kth[0]) == float(lib)):
            raise AssertionError(f"top-k kernel != plain on {name}: {kth.tolist()} {cnt.tolist()} "
                                 f"vs {float(want)!r} {int(want_cnt)} (torch.kthvalue {float(lib)!r})")
        if name == "snap":
            # the 3rd largest is 1e-4, found only after a restarted round
            if float(kth[0]) != float(torch.tensor(1e-4)) or int(cnt[0]) != 2 or rounds[name] < 2:
                raise AssertionError(f"snap case: kth {float(kth[0])!r}, {int(cnt[0])} above, "
                                     f"{rounds[name]} rounds")
    # the chunk's 128 P3 vectors in one launch, each held to the plain version
    kth_b, cnt_b = topk.topk_threshold_cuda(p3, k)
    for i in range(p3.shape[0]):
        want, want_cnt = topk.topk_threshold_reference(p3[i], k)
        if not (torch.equal(kth_b[i:i + 1].view(torch.int32), want.reshape(1).view(torch.int32))
                and int(cnt_b[i]) == int(want_cnt)):
            raise AssertionError(f"top-k kernel != plain on vector {i} of the batch")
    n = p3.shape[1]
    lib_kth = torch.kthvalue(p3, n - k + 1, dim=1).values
    if not torch.equal(lib_kth, kth_b):
        raise AssertionError("torch.kthvalue disagrees with the top-k kernel")

    one = p3[:1]
    ms = cuda_time_ms(lambda: topk.topk_threshold_cuda(one, k), reps=50)
    batch_ms = cuda_time_ms(lambda: topk.topk_threshold_cuda(p3, k), reps=20)
    plain_ms = cuda_time_ms(lambda: topk.topk_threshold_reference(one, k), reps=5, warmup=1)
    lib_ms = cuda_time_ms(lambda: torch.kthvalue(one, n - k + 1, dim=1), reps=50)
    lib_batch_ms = cuda_time_ms(lambda: torch.kthvalue(p3, n - k + 1, dim=1), reps=20)
    dev_ms = device_ms(lambda: topk.topk_threshold_cuda(one, k), reps=50)
    dev_batch_ms = device_ms(lambda: topk.topk_threshold_cuda(p3, k), reps=20)
    lib_dev_ms = device_ms(lambda: torch.kthvalue(one, n - k + 1, dim=1), reps=50)
    lib_dev_batch_ms = device_ms(lambda: torch.kthvalue(p3, n - k + 1, dim=1), reps=20)
    # what the function needs, whatever the method: the vector read once, one
    # compare per score, kth and the count written once
    bnd, by = bound(n * 4 + 8, n)
    log(f"[1] top-k threshold kernel bit-equal to plain at N=14112 (k=512, the chunk's 128 "
        f"vectors too), N=28800, ties, the snap case, k=1, k=N, all-equal, geometric, "
        f"subnormals, and by value on signed zeros; plain version's rounds "
        f"(with_rounds) {json.dumps(rounds)} ({card}): one vector kernel {ms:.4f} ms, plain "
        f"{plain_ms:.3f} ms, torch.kthvalue {lib_ms:.4f} ms, bound {bnd:.7f} ms ({by}); 128 "
        f"vectors in one launch {batch_ms:.4f} ms, torch.kthvalue over (128, {n}) "
        f"{lib_batch_ms:.4f} ms; device time (one trace each) one vector "
        f"kernel {ms_text(dev_ms)}, torch.kthvalue {ms_text(lib_dev_ms)}, 128 vectors kernel "
        f"{ms_text(dev_batch_ms)}, torch.kthvalue {ms_text(lib_dev_batch_ms)}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bnd, bound_by=by,
                library_ms=lib_ms, device_ms=dev_ms)


def roi_boxes(torch, n: int, r: int, hw, seed: int):
    """(n, r, 4) detection-like xyxy boxes in network pixels; boxes near the
    border reach past it."""
    g = torch.Generator().manual_seed(seed)
    h, w = hw
    centers = torch.rand(n, r, 2, generator=g) * torch.tensor([float(w), float(h)])
    sizes = 8 + torch.rand(n, r, 2, generator=g) * 250
    return torch.cat([centers - sizes / 2, centers + sizes / 2], dim=-1).contiguous()


def phase_roi_align(torch, roi, card):
    dev = torch.device("cuda")
    kw = dict(spatial_scale=1.0 / 8, output_size=7, sampling_ratio=2)
    g = torch.Generator().manual_seed(8)
    # the headline's ReID pooling: P3 of a 448x672 input, 128 channels, 64 RoIs
    feats = torch.randn(128, 56, 84, 128, generator=g).to(dev)
    boxes = roi_boxes(torch, 128, 64, (448, 672), seed=9).to(dev)
    outside = int(((boxes[..., :2] < 0).any(-1) | (boxes[..., 2] > 672) | (boxes[..., 3] > 448))
                  .sum())

    one_f, one_b = feats[:1].contiguous(), boxes[:1].contiguous()
    err32 = float((roi.roi_align_cuda(one_f, one_b, **kw)
                   - roi.roi_align_kernel_reference(one_f, one_b, **kw)).abs().max())
    if err32 > 1e-5:
        raise AssertionError(f"RoIAlign kernel f32 max |err| {err32} > 1e-5")
    # bfloat16, the main path's feature dtype, over the whole chunk: both
    # accumulate in f32 and round once, so they may differ by one bf16 ulp
    fb = feats.bfloat16()
    got = roi.roi_align_cuda(fb, boxes, **kw).float()
    want = roi.roi_align_kernel_reference(fb, boxes, **kw).float()
    diff = (got - want).abs()
    err16 = float(diff.max())
    if not (diff <= 2.0 ** -7 * want.abs() + 1e-6).all():
        raise AssertionError(f"RoIAlign kernel bf16 differs by more than one ulp: {err16}")
    equal16 = float((got == want).double().mean())
    # the smallest map the kernel takes: 2 rows, boxes partly outside
    small = torch.randn(3, 2, 5, 32, generator=g).to(dev)
    sboxes = roi_boxes(torch, 3, 16, (16, 40), seed=10).to(dev)
    err_small = float((roi.roi_align_cuda(small, sboxes, **kw)
                       - roi.roi_align_kernel_reference(small, sboxes, **kw)).abs().max())
    if err_small > 1e-5:
        raise AssertionError(f"RoIAlign kernel on a 2-row map: max |err| {err_small}")
    # channel counts no 16-byte vector divides (C=100: 8-byte vectors in bf16,
    # 16 in f32; C=8; C=3: one channel a thread), boxes of zero width, with
    # x2 < x1 and wholly outside the map among them, and a feature tensor one
    # element past a 16-byte boundary
    err_odd = 0.0
    for c in (100, 8, 3):
        base = torch.randn(3, 20, 30, c, generator=g).to(dev)
        oboxes = roi_boxes(torch, 3, 16, (160, 240), seed=30 + c)
        oboxes[:, 0] = torch.tensor([40.0, 30.0, 40.0, 90.0])        # zero width
        oboxes[:, 1] = torch.tensor([120.0, 30.0, 60.0, 90.0])       # x2 < x1
        oboxes[:, 2] = torch.tensor([-300.0, -200.0, -100.0, -50.0])  # outside, above left
        oboxes[:, 3] = torch.tensor([400.0, 300.0, 500.0, 420.0])    # outside, below right
        oboxes = oboxes.to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            aligned = base.to(dtype)
            flat = torch.empty(aligned.numel() + 1, dtype=dtype, device=dev)
            shifted = flat[1:].view(aligned.shape).copy_(aligned)
            if shifted.data_ptr() % 16 == 0 or not shifted.is_contiguous():
                raise AssertionError("the shifted feature tensor is aligned after all")
            want = roi.roi_align_kernel_reference(aligned, oboxes, **kw).float()
            for feats_c in (aligned, shifted):
                diff = (roi.roi_align_cuda(feats_c, oboxes, **kw).float() - want).abs()
                tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7 * want.abs() + 1e-6
                if not (diff <= tol).all():
                    raise AssertionError(f"RoIAlign kernel at C={c} {dtype}: max |err| "
                                         f"{float(diff.max())}")
                err_odd = max(err_odd, float(diff.max()))
            if want[:, 2:4].abs().max() != 0:
                raise AssertionError("boxes wholly outside the map pooled something")
    torch.cuda.synchronize()

    one16, oneb = fb[:1], boxes[:1]
    ms = cuda_time_ms(lambda: roi.roi_align_cuda(one16, oneb, **kw), reps=50)
    plain_ms = cuda_time_ms(lambda: roi.roi_align_kernel_reference(one16, oneb, **kw), reps=10)
    mm_ms = cuda_time_ms(lambda: roi.roi_align_batched(one16, oneb, **kw), reps=20)
    chunk_ms = cuda_time_ms(lambda: roi.roi_align_cuda(fb, boxes, **kw), reps=10)
    chunk_plain_ms = cuda_time_ms(lambda: roi.roi_align_kernel_reference(fb, boxes, **kw),
                                  reps=3, warmup=1)
    chunk_mm_ms = cuda_time_ms(lambda: roi.roi_align_batched(fb, boxes, **kw), reps=5)
    dev_ms = device_ms(lambda: roi.roi_align_cuda(one16, oneb, **kw), reps=50)
    mm_dev_ms = device_ms(lambda: roi.roi_align_batched(one16, oneb, **kw), reps=20)
    chunk_dev_ms = device_ms(lambda: roi.roi_align_cuda(fb, boxes, **kw), reps=10)
    chunk_mm_dev_ms = device_ms(lambda: roi.roi_align_batched(fb, boxes, **kw), reps=5)
    # one image: read the bf16 map and the boxes once, write the bf16 output
    # once; per output 4 s^2 products and sums of the y-blends and 4 s of the
    # x-blend (40 at s = 2)
    s_ = kw["sampling_ratio"]
    outputs = 64 * 7 * 7 * 128
    bnd, by = bound(one16.numel() * 2 + oneb.numel() * 4 + outputs * 2,
                    outputs * s_ * (8 * s_ + 4))
    chunk_bnd, chunk_by = bound(fb.numel() * 2 + boxes.numel() * 4 + 128 * outputs * 2,
                                128 * outputs * s_ * (8 * s_ + 4))
    log(f"[1] RoIAlign kernel vs plain at P3 56x84x128, 64 RoIs ({outside} of the chunk's "
        f"8192 partly outside), 7x7, s=2: f32 max |err| {err32:.2e}, bf16 over the chunk max "
        f"|err| {err16:.2e} ({equal16:.4f} of outputs bit-equal), 2-row map {err_small:.2e}, "
        f"C = 100, 8 and 3 in f32 and bf16 with zero-width, inverted and outside boxes, on an "
        f"aligned and an unaligned tensor, max |err| {err_odd:.2e} "
        f"({card}); one image bf16: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, matmul form "
        f"{mm_ms:.4f} ms, bound {bnd:.6f} ms ({by}); chunk of 128 images x 64 RoIs bf16: kernel "
        f"{chunk_ms:.4f} ms, plain {chunk_plain_ms:.2f} ms, matmul form {chunk_mm_ms:.4f} ms, "
        f"bound {chunk_bnd:.6f} ms ({chunk_by}); "
        f"device time (one trace each) one image kernel {ms_text(dev_ms)}, "
        f"matmul form {ms_text(mm_dev_ms)}, chunk kernel {ms_text(chunk_dev_ms)}, matmul form "
        f"{ms_text(chunk_mm_dev_ms)}")
    return dict(max_abs_err=max(err32, err16, err_small, err_odd), ms=ms, plain_ms=plain_ms,
                bound_ms=bnd, bound_by=by, library_ms=None, device_ms=dev_ms)


# (Hp, Wp, C, heads) of Swin-T's four stages at 640x960: the maps 160x240,
# 80x120, 40x60 and 20x30 padded to multiples of the 7x7 window
SWIN_STAGES = ((161, 245, 96, 3), (84, 126, 192, 6), (42, 63, 384, 12), (21, 35, 768, 24))
SWIN_BATCH = 40         # config 4's chunk, 8 ticks x 5 cameras, in one forward
# Seeded random Swin-T weights score too low for config 4's lowered gates;
# as the presets' CPU tests raise their slim detector's class-logit bias
SWIN_CLASS_BIAS_SHIFT = 2.5


def phase_window_attention(torch, wa, card):
    """Phase 1w. The tolerance is tests/test_torch_swin.py's: the kernel reads
    the bf16 inputs exactly and works in float32, so it stands from the
    plain path in float32 by its one rounding to bf16 (2^-9 relative) plus
    summation order and __expf (some 1e-6 of the largest |v|). The bound
    is of the kernel as built, float32 products on the CUDA cores: q, k and
    v read once and the output written once (8 C bytes a padded token) and
    the table, against 196 C operations a token. Returns stage 1's shifted
    launch as the kernel's ``ms`` / ``plain_ms`` / ``bound_ms``, every launch
    under ``cases`` and a camera-frame's 12 launches under ``per_frame``."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(19)
    cases = []
    for hp, wp, c, heads in SWIN_STAGES:
        qkv = torch.randn((SWIN_BATCH, hp, wp, 3 * c), generator=g, device=dev).bfloat16()
        table = torch.randn((169, heads), generator=g, device=dev)
        scale = float(qkv[..., 2 * c:].float().abs().max())
        tokens = SWIN_BATCH * hp * wp
        bnd, by = bound(8 * c * tokens + 169 * heads * 4, 196 * c * tokens)
        for shift in (0, 3):
            got = wa.window_attention_cuda(qkv, table, heads, 7, shift).float()
            want = wa.window_attention_reference(qkv.float(), table, heads, 7, shift)
            excess = float(((got - want).abs() - 2.0 ** -8 * want.abs() - 1e-5 * scale).max())
            err = float((got - want).abs().max())
            del got, want
            if excess > 0:
                raise AssertionError(f"window attention kernel at {(hp, wp, c, heads)} shift "
                                     f"{shift}: max |err| {err} beyond the tolerance by {excess}")
            ms = cuda_time_ms(lambda: wa.window_attention_cuda(qkv, table, heads, 7, shift),
                              reps=10)
            plain_ms = cuda_time_ms(
                lambda: wa.window_attention_reference(qkv, table, heads, 7, shift), reps=3,
                warmup=1)
            dev_ms = device_ms(lambda: wa.window_attention_cuda(qkv, table, heads, 7, shift),
                               reps=5)
            cases.append(dict(stage=[hp, wp, c, heads], shift=shift, max_abs_err=err,
                              scale=scale, ms=ms, plain_ms=plain_ms, bound_ms=bnd, bound_by=by,
                              device_ms=dev_ms))
            log(f"[1w] window attention kernel vs plain at B={SWIN_BATCH}, map {hp}x{wp}, "
                f"C={c}, {heads} heads, shift {shift}: bf16 max |err| {err:.3e} (max |v| "
                f"{scale:.3f}, within rtol 2^-8 + atol 1e-5 max|v|) ({card}); kernel "
                f"{ms:.4f} ms, plain in bf16 {plain_ms:.3f} ms, bound {bnd:.4f} ms ({by}), "
                f"device time {ms_text(dev_ms)}")
        del qkv
    torch.cuda.empty_cache()
    # a camera-frame's 12 launches: each stage's blocks, half of them shifted
    depth = dict(zip((st[0] for st in SWIN_STAGES), (2, 2, 6, 2)))
    frame = {k: sum(cs[k] * depth[cs["stage"][0]] / 2 for cs in cases) / SWIN_BATCH
             for k in ("ms", "plain_ms", "bound_ms")}
    log(f"[1w] a 640x960 camera-frame's 12 launches, from the 40-image launches: kernel "
        f"{frame['ms']:.4f} ms, plain in bf16 {frame['plain_ms']:.3f} ms, bound "
        f"{frame['bound_ms']:.4f} ms ({card})")
    first = next(cs for cs in cases if cs["stage"][0] == SWIN_STAGES[0][0] and cs["shift"] == 3)
    return dict(max_abs_err=max(cs["max_abs_err"] for cs in cases), ms=first["ms"],
                plain_ms=first["plain_ms"], bound_ms=first["bound_ms"],
                bound_by=first["bound_by"], library_ms=None, device_ms=first["device_ms"],
                cases=cases, per_frame=frame)


def phase_downscale(np, torch, card):
    """Phase 1b: ``area_downscale`` on the card gives the bytes of the same
    function on CPU tensors (the bytes of cv2's INTER_AREA, which the CPU
    tests hold it to) at d = 2 and 4, on the Waymo front (1280x1920) and
    side (886x1920) camera sizes and an odd size; the time of a 128-frame
    1280x1920 chunk; and the prefetcher's pinned ring under a slow consumer
    at depth 1 and 2, every chunk arriving intact."""
    from waymo_2d_tracking_tpu_torch.data.prefetch import DevicePrefetcher
    from waymo_2d_tracking_tpu_torch.data.preprocess import area_downscale

    dev = torch.device("cuda")
    rng = np.random.default_rng(50)
    checked = []
    for h, w in ((1280, 1920), (886, 1920), (67, 99)):
        frames = torch.from_numpy(rng.integers(0, 256, (2, h, w, 3), dtype=np.uint8))
        for d in (2, 4):
            if not torch.equal(area_downscale(frames.to(dev), d).cpu(), area_downscale(frames, d)):
                raise AssertionError(f"area_downscale on the card != CPU at {h}x{w}, d={d}")
            checked.append(f"{h}x{w} d={d}")
    chunk = torch.from_numpy(rng.integers(0, 256, (128, 1280, 1920, 3), dtype=np.uint8)).to(dev)
    times = {d: cuda_time_ms(lambda: area_downscale(chunk, d), reps=5) for d in (2, 4)}
    side = chunk[:, :886].contiguous()
    side_ms = cuda_time_ms(lambda: area_downscale(side, 4), reps=5)
    del chunk, side
    log(f"[1b] area_downscale on the card == on the CPU, byte for byte, at {', '.join(checked)} "
        f"({card}); a 128-frame 1280x1920 chunk {times[2]:.3f} ms at d=2 (integer 2x2 sums), "
        f"{times[4]:.3f} ms at d=4; 128 frames of 886x1920 at d=4 (fractional weights) "
        f"{side_ms:.3f} ms (median of 5, CUDA events)")

    host = [rng.integers(0, 256, (8, 640, 960, 3), dtype=np.uint8) for _ in range(10)]
    for depth in (1, 2):
        seen = 0
        with DevicePrefetcher(iter(host), depth=depth) as pf:
            for i, x in enumerate(pf):
                (x.float() * 2).sum()            # the consumer's stream reads the chunk
                time.sleep(0.02)                 # a slow consumer: the worker refills the ring
                if not torch.equal(x.cpu(), torch.from_numpy(host[i])):
                    raise AssertionError(f"prefetch depth {depth}: chunk {i} arrived corrupted")
                seen += 1
        if seen != len(host):
            raise AssertionError(f"prefetch depth {depth}: {seen} of {len(host)} chunks")
    log(f"[1b] DevicePrefetcher: {len(host)} chunks of 8x640x960x3 through the pinned ring at "
        f"depth 1 and 2 under a slow consumer, each equal to its host source")
    return times


def random_match_inputs(np, torch, rng, cams, s, d, e):
    """A tracker state and detections with unit embeddings, a matching with
    some slots unmatched and an appearance mask with some slots off (CPU)."""
    from waymo_2d_tracking_tpu_torch.config import TrackerConfig
    from waymo_2d_tracking_tpu_torch.tracker.tracker import init_state
    from waymo_2d_tracking_tpu_torch.types import Detections

    def unit(*shape):
        x = rng.normal(size=shape).astype(np.float32)
        return torch.from_numpy(x / np.linalg.norm(x, axis=-1, keepdims=True))

    lead = () if cams is None else (cams,)
    cfg = TrackerConfig(max_tracks=s, max_detections=d, embed_dim=e, gallery_size=4,
                        reid_recovery=True)
    state = init_state(cfg, device="cpu")
    if cams is not None:
        state = type(state).stack([state] * cams)
    state = state.replace(embed=unit(*lead, s, e), gallery=unit(*lead, s, 4, e),
                          status=torch.full(lead + (s,), 2, dtype=torch.int8))
    xy = rng.uniform(0, 500, lead + (d, 2)).astype(np.float32)
    wh = rng.uniform(10, 80, lead + (d, 2)).astype(np.float32)
    dets = Detections(boxes=torch.from_numpy(np.concatenate([xy, xy + wh], -1)),
                      scores=torch.from_numpy(rng.uniform(0, 1, lead + (d,)).astype(np.float32)),
                      classes=torch.zeros(lead + (d,), dtype=torch.int32),
                      embeds=unit(*lead, d, e), valid=torch.ones(lead + (d,), dtype=torch.bool))
    r2c = np.stack([rng.permutation(d)[:s] for _ in range(cams or 1)]).astype(np.int32)
    r2c[rng.random(r2c.shape) < 0.15] = -1
    r2c = torch.from_numpy(r2c if cams else r2c[0])
    upd = torch.from_numpy(rng.random(tuple(r2c.shape)) > 0.2)
    return cfg, state, dets, r2c, upd


def phase_appearance(np, torch, counters, card):
    """Phase 1c: the tracker's appearance update (``lifecycle.apply_matches``
    with ``ema_normalize``, XLA's arithmetic) and the ReID head's
    normalization (``utils/l2norm.py``) on the card give the CPU's bits on
    random inputs, at the headline's (S = 64, E = 128), config 4's (5
    cameras, S = 128) and the fixtures' E = 32 and 16, with no auction in
    between; the update timed against the one-line form it replaced. Then
    ``HOSTILE_CLIPS['curved_pan']`` under the hostile-quality BASE config
    through ``Tracker.run`` on the card (the captured step) and on the CPU:
    MOTA / IDF1 / IDSW and the first frame where the ids differ (the card's
    auction runs the Pallas kernel's schedule, so a near-tie may go the
    other way), the card held to the JAX test's floor (MOTA >= 0.73)."""
    from waymo_2d_tracking_tpu_torch.config import TrackerConfig
    from waymo_2d_tracking_tpu_torch.data.synthetic import HOSTILE_CLIPS, generate_clip
    from waymo_2d_tracking_tpu_torch.eval.mot import (
        evaluate_mot, gt_to_frames, track_outputs_to_frames,
    )
    from waymo_2d_tracking_tpu_torch.tracker import Tracker, lifecycle
    from waymo_2d_tracking_tpu_torch.utils import l2norm

    dev = torch.device("cuda")
    rng = np.random.default_rng(60)
    checked = []
    for cams, s, e in ((None, 64, 128), (5, 128, 128), (None, 64, 32), (None, 16, 16)):
        cfg, state, dets, r2c, upd = random_match_inputs(np, torch, rng, cams, s, s, e)
        outs = [lifecycle.apply_matches(state.to(where), dets.to(where), r2c.to(where),
                                        torch.zeros_like(upd).to(where), cfg,
                                        embed_update=upd.to(where)).embed.cpu()
                for where in ("cpu", dev)]
        if not torch.equal(outs[0].view(torch.int32), outs[1].view(torch.int32)):
            bad = int((outs[0] != outs[1]).sum())
            raise AssertionError(f"appearance update at {(cams, s, e)}: {bad} elements of the "
                                 f"card differ from the CPU")
        checked.append(f"{'' if cams is None else f'{cams}x'}{s}x{e}")
    for r, e in ((8192, 128), (64, 32)):
        x = torch.from_numpy(rng.normal(size=(r, e)).astype(np.float32) * 0.05)
        if not torch.equal(l2norm.l2_normalize(x.to(dev)).cpu(), l2norm.l2_normalize(x)):
            raise AssertionError(f"ReID normalization at {r}x{e}: the card differs from the CPU")
        checked.append(f"ReID {r}x{e}")
    embed = torch.from_numpy(rng.normal(size=(64, 128)).astype(np.float32)).to(dev)
    det_e = torch.from_numpy(rng.normal(size=(64, 128)).astype(np.float32)).to(dev)

    def one_line():
        ema = 0.9 * embed + (1.0 - 0.9) * det_e
        return ema / torch.clamp(torch.linalg.vector_norm(ema, dim=-1, keepdim=True), min=1e-8)

    def graphed(fn):
        """CUDA-event ms of 128 replays (a headline chunk's frames) of ``fn``
        captured alone."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        return cuda_time_ms(lambda: [graph.replay() for _ in range(128)], reps=5)

    new = lambda: lifecycle.ema_normalize(embed, det_e, 0.9)  # noqa: E731
    eager = {k: cuda_time_ms(f, reps=50) for k, f in (("new", new), ("old", one_line))}
    replays = {k: graphed(f) for k, f in (("new", new), ("old", one_line))}
    log(f"[1c] appearance update on the card == CPU bit for bit at {', '.join(checked)} "
        f"({card}); ema_normalize at 64x128 {eager['new']:.4f} ms eager against the one-line "
        f"vector_norm form's {eager['old']:.4f} ms (median of 50); 128 replays of each "
        f"captured alone {replays['new']:.3f} ms against {replays['old']:.3f} ms (median of "
        f"5; CUDA events)")

    clip = HOSTILE_CLIPS["curved_pan"]
    cfg = TrackerConfig(max_tracks=64, max_detections=64, embed_dim=128,
                        appearance_weight=0.3, appearance_gate=0.5, n_init=3, max_age=3,
                        iou_threshold=0.3, reid_recovery=True, max_lost_age=30, gallery_size=4)
    dets, gt = generate_clip(clip)
    runs = {}
    for where in ("cpu", "cuda"):
        zero_counts(counters)
        t0 = time.perf_counter()
        _, out = Tracker(cfg, device=where).run(dets.to(where))
        out = out.to_numpy()
        runs[where] = (out, time.perf_counter() - t0, read_counts(counters))
    (cpu, cpu_s, _), (card_out, card_s, counts) = runs["cpu"], runs["cuda"]
    ids = [np.where(o.valid, o.track_id, -1) for o in (cpu, card_out)]
    differ = np.nonzero((ids[0] != ids[1]).any(1) | (cpu.valid != card_out.valid).any(1))[0]
    first = int(differ[0]) if differ.size else None
    m = {w: evaluate_mot(gt_to_frames(gt), track_outputs_to_frames(o, clip.num_frames))
         for w, o in (("cpu", cpu), ("cuda", card_out))}
    if counts["auction"] <= 0:
        raise AssertionError(f"curved_pan on the card launched no auction: {counts}")
    log(f"[1c] curved_pan BASE ({clip.num_frames} frames, embed 128): card MOTA "
        f"{m['cuda'].mota:.4f} IDF1 {m['cuda'].idf1:.4f} IDSW {m['cuda'].num_idsw} in "
        f"{card_s:.2f} s; CPU {m['cpu'].mota:.4f} / {m['cpu'].idf1:.4f} / {m['cpu'].num_idsw} "
        f"in {cpu_s:.2f} s; first frame whose ids differ from the CPU's: {first}; "
        f"launches {json.dumps(counts)}")
    if m["cuda"].mota < 0.73:
        raise AssertionError(f"curved_pan BASE on the card: MOTA {m['cuda'].mota:.4f} < 0.73")
    return counts


# ----------------------------------------------------------------- phase 2

def records_to_frames(np, records, num_frames):
    ids = {}
    frames = [([], []) for _ in range(num_frames)]
    for r in records:
        ids.setdefault(r.object_id, len(ids))
        frames[r.timestamp_micros][0].append(ids[r.object_id])
        frames[r.timestamp_micros][1].append(list(r.to_xyxy()))
    return [(np.asarray(i, np.int64), np.asarray(b, float).reshape(len(i), 4))
            for i, b in frames]


def scratch_dir() -> str:
    """A directory for the files a phase writes, inside the checkout."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out", "chip_smoke")
    os.makedirs(path, exist_ok=True)
    return path


def phase_fixtures(np, torch, nms, assign):
    import tempfile

    from waymo_2d_tracking_tpu_torch.config import (
        Config, DetectorConfig, PipelineConfig, TrackerConfig,
    )
    from waymo_2d_tracking_tpu_torch.data.synthetic import (
        SyntheticClipConfig, render_video_clip,
    )
    from waymo_2d_tracking_tpu_torch.eval.mot import evaluate_mot, gt_to_frames
    from waymo_2d_tracking_tpu_torch.io_out.submission import read_jsonl
    from waymo_2d_tracking_tpu_torch.pipeline.multicam import MultiCamPipeline
    from waymo_2d_tracking_tpu_torch.pipeline.online import OnlineTracker
    from waymo_2d_tracking_tpu_torch.pipeline.run import SegmentFrames, SegmentPipeline
    from waymo_2d_tracking_tpu_torch.weights import fixture_state_dict

    nms.nms_mask_cuda.launches = 0
    assign.auction_kernel_cuda.launches = 0

    def config(det_kw, pipe_kw=None, **trk_kw):
        return Config(detector=DetectorConfig(**det_kw),
                      tracker=TrackerConfig(**{**PIXELS_TRK, **trk_kw}),
                      pipeline=PipelineConfig(chunk_frames=16, interp_max_gap=0,
                                              **(pipe_kw or {})))

    def run(det_kw, clip, state_dict, pipe_kw=None, **trk_kw):
        frames, gt = render_video_clip(clip)
        cfg = config(det_kw, pipe_kw, **trk_kw)
        pipe = SegmentPipeline(cfg, state_dict, device="cuda")
        records, _ = pipe.run_segment(SegmentFrames(
            "fixture", 1, list(range(clip.num_frames)), frames))
        m = evaluate_mot(gt_to_frames(gt), records_to_frames(np, records, clip.num_frames))
        return m, records, frames, gt

    sd = fixture_state_dict("pixels_detector")
    seed5 = SyntheticClipConfig(num_frames=80, num_objects=8, image_size=(1024, 1536), seed=5)
    dense = SyntheticClipConfig(num_frames=80, num_objects=14, image_size=(1024, 1536), seed=11)
    m5, rec5, frames5, gt5 = run(PIXELS_DET, seed5, sd, birth_iou_threshold=0.3)
    log(f"[2] seed-5 clip: {json.dumps(m5.as_dict())}")
    if not (m5.mota >= 0.78 and m5.idf1 >= 0.87 and m5.num_idsw <= 6 and m5.mostly_tracked >= 7):
        raise AssertionError("seed-5 floors (0.78 / 0.87 / <=6 / >=7) missed")
    m, _, _, _ = run(PIXELS_DET, seed5, sd, pipe_kw=dict(tta_flip=True, tta_scales=(1.0, 0.75)),
                     birth_iou_threshold=0.3)
    got = m.as_dict()
    log(f"[2] seed-5 clip with TTA (flip, scales 1.0 and 0.75): {json.dumps(got)}; JAX "
        f"reference {json.dumps(SEED5_TTA_REF)}, tolerance {json.dumps(SEED5_TTA_TOL)}")
    if any(abs(got[key] - ref) > SEED5_TTA_TOL[key] for key, ref in SEED5_TTA_REF.items()):
        raise AssertionError("seed-5 TTA metrics differ from the JAX reference")
    md, _, frames_d, gt_d = run(PIXELS_DET, dense, sd, birth_iou_threshold=0.3)
    log(f"[2] dense clip: {json.dumps(md.as_dict())}")
    if not (md.mota >= 0.42 and md.idf1 >= 0.66 and md.num_idsw <= 7):
        raise AssertionError("dense-clip floors (0.42 / 0.66 / <=7) missed")

    # config 4's composition of the two clips (tests/golden/test_pixels_to_mota.py
    # test_multicam_pixels_to_mota_floor): seed 5 as camera 1, the dense clip
    # as camera 2, one shared detector batch of 32 images a chunk, the
    # camera-batched tracker, JSONL written and read back; each camera must
    # give exactly its single-camera metrics
    cfg = config(PIXELS_DET, birth_iou_threshold=0.3)
    ts = list(range(seed5.num_frames))
    with tempfile.TemporaryDirectory(dir=scratch_dir()) as out:
        stats = MultiCamPipeline(cfg, num_cams=2, state_dict=sd, device="cuda").run_segments_group(
            [SegmentFrames("mc", 1, ts, frames5), SegmentFrames("mc", 2, ts, frames_d)], out)
        per_cam = {cam: evaluate_mot(gt_to_frames(gt), records_to_frames(
            np, read_jsonl(os.path.join(out, f"mc_{cam}.jsonl")), seed5.num_frames))
            for cam, gt in ((1, gt5), (2, gt_d))}
    keys = ("mota", "idf1", "num_idsw", "mostly_tracked")
    log(f"[2] multicam (seed 5 + dense, chunk 16, one 32-image detector batch): camera 1 "
        f"{json.dumps(per_cam[1].as_dict())}; camera 2 {json.dumps(per_cam[2].as_dict())}; "
        f"stats {json.dumps(stats)}")
    for cam, single in ((1, m5), (2, md)):
        if any(per_cam[cam].as_dict()[k] != single.as_dict()[k] for k in keys):
            raise AssertionError(f"multicam camera {cam} differs from its single-camera run")

    # the seed-5 clip one frame at a time through the online session: the
    # records of the chunked run
    sess = OnlineTracker(cfg, sd, device="cuda", context_name="fixture", camera_name=1)
    sess.warmup(tuple(frames5.shape[1:3]))
    online = []
    for t in range(seed5.num_frames):
        online.extend(sess.step(frames5[t], t))
    key = lambda r: (r.timestamp_micros, r.object_id, r.object_type)   # noqa: E731
    a, b = sorted(online, key=key), sorted(rec5, key=key)
    if [key(r) for r in a] != [key(r) for r in b]:
        raise AssertionError("online seed-5 records (ids, types, frames) differ from the chunked run")
    diff = max((abs(getattr(x, f) - getattr(y, f)) for x, y in zip(a, b)
                for f in ("center_x", "center_y", "length", "width", "score")), default=0.0)
    lat = sess.latency_stats()
    log(f"[2] online seed-5 clip frame by frame: {len(a)} records, the chunked run's ids, types "
        f"and frames; max |box or score difference| {diff:.3e} (detector batch 1 against 16); "
        f"latency {json.dumps(lat)}")
    if diff > 1e-2:
        raise AssertionError(f"online seed-5 records differ from the chunked run by {diff}")

    phase_fixtures_int8(np, torch, run, config, seed5, dense, frames5, gt5, sd)

    reid_det = {**PIXELS_DET, "embed_dim": 32}
    clip = SyntheticClipConfig(num_frames=100, num_objects=6, image_size=(1024, 1536),
                               seed=29, occlusion_gap=(30, 52), texture_amp=0.25)
    sd = fixture_state_dict("pixels_detector_reid")
    base = dict(embed_dim=32, max_lost_age=30, birth_iou_threshold=0.3)
    off = run(reid_det, clip, sd, **base)[0]
    on = run(reid_det, clip, sd, **base, reid_recovery=True, appearance_gate=0.3,
             gallery_size=4)[0]
    log(f"[2] reid recovery off idf1 {off.idf1:.4f} idsw {off.num_idsw}; "
        f"on idf1 {on.idf1:.4f} idsw {on.num_idsw}")
    if not (on.idf1 >= off.idf1 + 0.05 and on.num_idsw <= off.num_idsw):
        raise AssertionError("ReID recovery gain (+0.05 IDF1) missed")
    launches = (nms.nms_mask_cuda.launches, assign.auction_kernel_cuda.launches)
    log(f"[2] kernel launches in the fixture phase: nms {launches[0]}, auction {launches[1]}")
    if min(launches) == 0:
        raise AssertionError("a kernel did not run in the fixture phase")
    return {"seed5": m5.as_dict(), "dense": md.as_dict(),
            "online": {"cfg": cfg, "frames": frames5, "records": online, "gt": gt5}}


def phase_fixtures_int8(np, torch, run, config, seed5, dense, frames5, gt5, sd):
    """The trained fixture with ``quant='int8'`` (scope 'trunk'): both pixel
    clips through ``run_segment``, calibrating on the first chunk, against
    the JAX test's floors and beside the JAX CPU metrics; the seed-5 clip
    frame by frame through an int8 ``OnlineTracker`` (calibrating on its
    first frame); an uncalibrated int8 detector refusing to detect."""
    from waymo_2d_tracking_tpu_torch.config import DetectorConfig
    from waymo_2d_tracking_tpu_torch.eval.mot import evaluate_mot, gt_to_frames
    from waymo_2d_tracking_tpu_torch.models import quant
    from waymo_2d_tracking_tpu_torch.models.detector import DetectorRunner
    from waymo_2d_tracking_tpu_torch.pipeline.online import OnlineTracker

    int8_det = {**PIXELS_DET, "quant": "int8", "quant_scope": "trunk"}
    quant.int8_gemm.launches = 0
    for name, clip in (("seed5", seed5), ("dense", dense)):
        m = run(int8_det, clip, sd, birth_iou_threshold=0.3)[0]
        got, (mota, idf1, idsw) = m.as_dict(), INT8_FLOORS[name]
        log(f"[2] int8 {name} clip: mota {got['mota']:.4f} idf1 {got['idf1']:.4f} idsw "
            f"{got['num_idsw']} (JAX CPU {json.dumps(INT8_JAX_REF[name])}; floors >= {mota} / "
            f">= {idf1} / <= {idsw}); {json.dumps(got)}")
        if not (m.mota >= mota and m.idf1 >= idf1 and m.num_idsw <= idsw):
            raise AssertionError(f"int8 {name} clip misses the JAX test's floors")
    gemms = quant.int8_gemm.launches
    sess = OnlineTracker(config(int8_det, birth_iou_threshold=0.3), sd, device="cuda",
                         context_name="fixture", camera_name=1)
    sess.warmup(tuple(frames5.shape[1:3]))
    online = []
    for t in range(seed5.num_frames):
        online.extend(sess.step(frames5[t], t))
    m = evaluate_mot(gt_to_frames(gt5), records_to_frames(np, online, seed5.num_frames))
    log(f"[2] int8 online seed-5 clip frame by frame (calibrated on its first frame): "
        f"{len(online)} records, {json.dumps(m.as_dict())}; latency "
        f"{json.dumps(sess.latency_stats())}; int8 GEMMs: {gemms} in the two chunked clips, "
        f"{quant.int8_gemm.launches - gemms} online")
    if not (online and quant.is_calibrated(sess.detector.module)
            and quant.int8_gemm.launches > gemms > 0):
        raise AssertionError("int8 online session did not calibrate or serve int8")
    images = torch.zeros((2, 256, 384, 3), device="cuda")
    try:
        DetectorRunner(DetectorConfig(**int8_det), sd, device="cuda").detect(images)
    except RuntimeError as e:
        log(f"[2] an uncalibrated int8 detect raises: {str(e)[:80]}...")
    else:
        raise AssertionError("an uncalibrated int8 detector served detections")


def libjpeg_probe():
    """What the machine has of libjpeg: ``ldconfig -p | grep -i jpeg`` and
    the ``jpeglib.h`` headers on the compiler's usual paths."""
    ldconfig = subprocess.run("ldconfig -p | grep -i jpeg", shell=True, capture_output=True,
                              text=True, timeout=60).stdout.strip()
    headers = [p for p in ("/usr/include/jpeglib.h", "/usr/local/include/jpeglib.h",
                           "/usr/include/x86_64-linux-gnu/jpeglib.h") if os.path.exists(p)]
    return ldconfig, headers


def phase_ingest(np, torch, card, preset, device="cuda"):
    """The committed Waymo-format TFRecord (``waymo_2d_tracking_tpu_torch/
    fixtures/ingest_fixture.tfrecord``: 16 FRONT frames at 1280x1920) through
    the port's ingest: the native scanner (index, metadata, extracted JPEG
    bytes against the pure-Python walk and the committed SHA-256); the JPEG
    shim built by whichever route finds libjpeg (the system's, or Pillow's
    bundled libjpeg-turbo against the vendored headers), its library path
    printed; every frame's decode at each committed denom (1, 2, 4) equal to
    the committed SHA-256; ``run_segment`` on the JPEG bytes at the preset's
    denom exactly the records of the same decoded frames passed as arrays (at
    1/denom of their coordinates), and an ``OnlineTracker`` fed the bytes
    exactly what it gives on the decoded frames. Returns True."""
    import hashlib

    from waymo_2d_tracking_tpu_torch.config import Config, _update
    from waymo_2d_tracking_tpu_torch.data import _native, jpeg, waymo
    from waymo_2d_tracking_tpu_torch.pipeline.online import OnlineTracker
    from waymo_2d_tracking_tpu_torch.pipeline.run import SegmentFrames, SegmentPipeline
    from waymo_2d_tracking_tpu_torch.weights import FIXTURES_DIR

    sha = lambda b: hashlib.sha256(b).hexdigest()   # noqa: E731
    fixture = json.load(open(os.path.join(FIXTURES_DIR, "ingest_fixture.json")))
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), fixture["tfrecord"])
    t0 = time.perf_counter()
    (seg,) = [s for s in waymo.iter_segments(os.path.dirname(path))
              if s.context_name == fixture["context_name"]]
    blobs = seg.jpeg_frames[0:seg.num_frames]
    walked = [waymo.parse_frame(r, want_labels=False)["images"][fixture["camera"]]
              for r in waymo.read_tfrecord(path, verify_crc=True)]
    if blobs != walked or [sha(b) for b in blobs] != fixture["jpeg_sha256"] \
            or list(seg.timestamps) != fixture["timestamps"]:
        raise AssertionError("ingest: the native TFRecord scanner's bytes differ from the "
                             "Python walk or the committed hashes")
    log(f"[2b] ingest: {os.path.basename(path)} ({fixture['bytes']} bytes) indexed, its "
        f"metadata and {len(blobs)} FRONT JPEGs extracted by the native scanner in "
        f"{time.perf_counter() - t0:.3f} s, equal to the Python walk and the committed SHA-256")
    ldconfig, headers = libjpeg_probe()
    log(f"[2b] libjpeg probe: ldconfig -p | grep -i jpeg -> {json.dumps(ldconfig.splitlines())}; "
        f"jpeglib.h {headers or 'absent'}")
    route = _native.jpeg_route()
    jpeg.BatchJpegDecoder(8, 8).close()     # builds, loads and checks the probe JPEG
    with open("/proc/self/maps") as f:
        loaded = sorted({ln.split()[-1] for ln in f if "libjpeg" in ln})
    log(f"[2b] JPEG shim route '{route[0]}' ({' '.join(route[1] + route[2])}): loaded {loaded}, "
        f"the probe JPEG decoded to its committed bytes")
    for denom in sorted(fixture["decoded_sha256"]):
        block = next(seg.chunk_iter(seg.num_frames, scale_denom=int(denom)))
        got = [sha(f.tobytes()) for f in block]
        want = fixture["decoded_sha256"][denom]
        same = sum(a == b for a, b in zip(got, want))
        log(f"[2b] decoded at denom {denom} by {loaded}: {same} of {len(got)} frames' SHA-256 "
            f"equal the committed decode by {fixture['decoded_by']}; first {got[0][:16]}")
        if same != len(want):
            t = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
            raise AssertionError(f"ingest: frame {t} decoded at denom {denom} differs from the "
                                 f"committed bytes")

    # seeded random weights score under the headline tracker's gates (0.5 /
    # 0.6): lower them, as config 4's runs do, unless the preset sets them,
    # so that the tracks the comparison needs are born
    cfg = _update(Config(), {**preset, "tracker": {**CONFIG4_RANDOM_WEIGHT_GATES,
                                                   **preset.get("tracker", {})}})
    sd = cfg.pipeline.decode_scale_denom
    cfg1 = _update(cfg, {"pipeline": {"decode_scale_denom": 1}})
    def scaled(recs, f):
        return [(r.timestamp_micros, r.object_id, r.object_type, r.score,
                 r.center_x * f, r.center_y * f, r.length * f, r.width * f) for r in recs]

    rec_jpeg, _ = SegmentPipeline(cfg, device=device, seed=0).run_segment(seg)
    decoded = next(seg.chunk_iter(seg.num_frames, scale_denom=sd))
    rec_arr, _ = SegmentPipeline(cfg1, device=device, seed=0).run_segment(
        SegmentFrames(seg.context_name, seg.camera_name, seg.timestamps, decoded))
    if not rec_jpeg or scaled(rec_jpeg, 1.0) != scaled(rec_arr, float(sd)):
        raise AssertionError("ingest: run_segment on the JPEG bytes differs from the "
                             "decoded frames")
    online = []
    for frames in (blobs, decoded):
        sess = OnlineTracker(cfg, device=device, seed=0)
        online.append([r for t, f in enumerate(frames) for r in sess.step(f, t)])
        sess.close()
    if scaled(online[0], 1.0) != scaled(online[1], float(sd)):
        raise AssertionError("ingest: the online session on JPEG bytes differs from the "
                             "decoded frames")
    log(f"[2b] ingest at decode_scale_denom {sd} ({card}): run_segment on the JPEG bytes gives "
        f"exactly the {len(rec_jpeg)} records of the decoded frames as arrays, the online "
        f"session on the bytes exactly its {len(online[1])} records on the decoded frames")
    return True


def int8_conv_split(np, torch, pipe, frames, card):
    """Every quantized conv of one headline_int8 chunk, at the shape the
    chunk gives it, timed alone with CUDA events (median of 3) and summed: the
    int8 GEMM (``torch._int_mm`` at the padded (M, K, N)), the whole int8 conv
    (quantize, im2col, GEMM, dequantize) and the bf16 cuDNN conv of the float
    preset that it replaces; the GEMMs' bound at 1979 dense int8 TOP/s and
    3.35 TB/s (A and B read once, the int32 result written once)."""
    import torch.nn.functional as F

    from waymo_2d_tracking_tpu_torch.models import quant

    runner = pipe.detector
    sd = pipe.cfg.pipeline.decode_scale_denom
    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: seen.append((mod, tuple(args[0].shape), args[0].dtype)))
        for m in quant.quant_convs(runner.module)]
    images, _ = pipe.preprocess(frames, frames.shape[1:3])
    runner.forward(images)
    for h in hooks:
        h.remove()
    del images
    tot = {"gemm_ms": 0.0, "int8_conv_ms": 0.0, "bf16_conv_ms": 0.0, "bound_ms": 0.0}
    by = {"bytes": 0, "operations": 0}
    for mod, shape, dtype in seen:
        x = torch.randn(shape, device="cuda", dtype=dtype).contiguous(
            memory_format=torch.channels_last)
        n, c, h, w = shape
        (kh, kw), (sh, sw), (ph, pw) = mod.kernel_size, mod.stride, mod.padding
        ho, wo = (h + 2 * ph - kh) // sh + 1, (w + 2 * pw - kw) // sw + 1
        mp, kp, np_ = quant.gemm_pads(n * ho * wo, kh * kw * c, mod.out_channels)
        a = torch.randint(-127, 128, (mp, kp), dtype=torch.int8, device="cuda")
        b = torch.randint(-127, 128, (np_, kp), dtype=torch.int8, device="cuda")
        tot["gemm_ms"] += cuda_time_ms(lambda: torch._int_mm(a, b.t()), reps=3)
        with torch.no_grad():
            tot["int8_conv_ms"] += cuda_time_ms(lambda: mod(x), reps=3)
            with torch.autocast("cuda", dtype=torch.bfloat16):
                tot["bf16_conv_ms"] += cuda_time_ms(
                    lambda: F.conv2d(x, mod.weight, mod.bias, mod.stride, mod.padding), reps=3)
        t_bytes = (mp * kp + kp * np_ + 4 * mp * np_) / PEAK_BYTES_PER_S * 1e3
        t_ops = 2 * mp * kp * np_ / PEAK_INT8_OPS_PER_S * 1e3
        tot["bound_ms"] += max(t_bytes, t_ops)
        by["bytes" if t_bytes >= t_ops else "operations"] += 1
        del x, a, b
    torch.cuda.empty_cache()
    log(f"[3] headline_int8: {len(seen)} quantized convs in a {frames.shape[0]}-frame chunk "
        f"(denom {sd}), each timed alone at its chunk shape and summed ({card}): "
        f"{json.dumps({k: round(v, 4) for k, v in tot.items()})}; GEMMs bound by "
        f"{json.dumps(by)} (convs)")
    return tot


# ----------------------------------------------------------------- phase 3

def same_records(torch, a, b) -> bool:
    """Every field of two state / output records bit for bit."""
    import dataclasses

    return all(torch.equal(getattr(a, f.name), getattr(b, f.name))
               for f in dataclasses.fields(a))


def chunk_split(torch, pipe, frames, chunk, tta):
    """A chunk's stages with CUDA events, median of 3 chunks, the chunk on
    the device at source size as the prefetcher hands it over: the
    ``decode_scale_denom`` downscale, the letterbox, the detector forward,
    candidates + NMS + RoIAlign + ReID, the tracker loop as the pipeline runs
    it (the captured step replayed per frame) and then the same chunk's eager
    loop (``track_segment``), whose state and outputs the graph's must equal
    bit for bit. A stage's time includes any wait for the host to enqueue
    it. Under TTA the forward stage holds every view's forward and
    candidates, the next the union's NMS, RoIAlign and ReID."""
    from waymo_2d_tracking_tpu_torch.data.preprocess import area_downscale, letterbox_batch
    from waymo_2d_tracking_tpu_torch.pipeline.tta import tta_candidates_batched
    from waymo_2d_tracking_tpu_torch.tracker import init_state, track_segment
    from waymo_2d_tracking_tpu_torch.tracker.graph import join, track_chunk

    cfg, runner = pipe.cfg, pipe.detector
    sd = cfg.pipeline.decode_scale_denom
    block = torch.from_numpy(frames[:chunk]).to("cuda")
    src_hw = tuple(-(-x // sd) for x in frames.shape[1:3])
    stages = ("downscale_ms", "letterbox_ms", "detector_forward_ms",
              "candidates_topk_nms_roi_align_reid_ms", "tracker_loop_ms", "tracker_loop_eager_ms")
    runs = []
    for _ in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
        ev[0].record()
        small = area_downscale(block, sd)
        ev[1].record()
        images, _ = letterbox_batch(small, src_hw, cfg.detector.image_size)
        ev[2].record()
        head_out, p_feats = runner.forward(images)
        if tta:
            cand = tta_candidates_batched(runner, images, scales=tuple(cfg.pipeline.tta_scales),
                                          flip=cfg.pipeline.tta_flip, base_head_out=head_out)
        ev[3].record()
        dets = runner.select(cand, p_feats) if tta else runner.postprocess(head_out, p_feats)
        ev[4].record()
        state, outs = track_chunk(init_state(cfg.tracker, device="cuda"), dets, cfg.tracker,
                                  pipe._graphs)
        join(pipe._graphs, "cuda")
        ev[5].record()
        e_state, e_outs = track_segment(init_state(cfg.tracker, device="cuda"), dets, cfg.tracker)
        ev[6].record()
        ev[6].synchronize()
        runs.append([ev[i].elapsed_time(ev[i + 1]) for i in range(6)])
        if not (same_records(torch, state, e_state) and same_records(torch, outs, e_outs)):
            raise AssertionError("the captured tracker step's state or outputs differ from "
                                 "the eager loop's on a chunk")
    split = {k: statistics.median(r[i] for r in runs) for i, k in enumerate(stages)}
    return split, runs, dets, outs


def device_busy(torch, pipe, frames, chunk, card):
    """Device busy share, 3 chunks, each read from its own trace: the union
    of the device intervals (kernels, copies) over the span from the first
    device event to the last. The chunk goes host -> device (pageable),
    downscale, letterbox, detector and the captured tracker step replayed
    per frame. The profiler's own host cost lengthens the span, so the idle
    share it gives is an upper estimate."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from waymo_2d_tracking_tpu_torch.tracker import init_state
    from waymo_2d_tracking_tpu_torch.tracker.graph import track_chunk

    cfg, runner = pipe.cfg, pipe.detector
    for rep in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            images, _ = pipe.preprocess(frames[:chunk], frames.shape[1:3])
            dets_p = runner.detect(images)
            with record_function("tracker_loop"):
                track_chunk(init_state(cfg.tracker, device="cuda"), dets_p, cfg.tracker,
                            pipe._graphs)
            torch.cuda.synchronize()
        events = prof.events()
        # device work only: record_function's range also shows on the device
        # timeline as a user annotation
        device = [e for e in events if e.device_type == DeviceType.CUDA
                  and e.name != "tracker_loop" and not getattr(e, "is_user_annotation", False)]
        spans = sorted((e.time_range.start, e.time_range.end) for e in device)
        if not spans:
            log("[3] device busy share: not measured (the profiler recorded no device events)")
            return
        busy_us, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
        for s0, e0 in spans[1:]:
            if s0 > cur_e:
                busy_us += cur_e - cur_s
                cur_s = s0
            cur_e = max(cur_e, e0)
        busy_us += cur_e - cur_s
        span_us = max(e0 for _, e0 in spans) - spans[0][0]
        by_name, copies = {}, {}
        for e in device:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
            if "Memcpy" in e.name:
                copies[e.name] = copies.get(e.name, 0) + 1
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        auction = [e for e in device if "auction_kernel" in e.name]
        auction_ms = sum(e.time_range.elapsed_us() for e in auction) / 1e3
        nms_runs = [e for e in device if "nms_mask_kernel" in e.name]
        nms_ms = sum(e.time_range.elapsed_us() for e in nms_runs) / 1e3
        # runtime calls that copy or wait, issued inside the tracker loop
        loop = [e for e in events if e.name == "tracker_loop"
                and e.device_type == DeviceType.CPU][0].time_range
        waits = {}
        for e in events:
            if (e.device_type == DeviceType.CPU and loop.start <= e.time_range.start <= loop.end
                    and ("Synchronize" in e.name or "Memcpy" in e.name)):
                waits[e.name] = waits.get(e.name, 0) + 1
        log(f"[3] traced chunk {rep} ({card}): device busy {busy_us / 1e3:.3f} ms of a "
            f"{span_us / 1e3:.3f} ms device span, idle share {1 - busy_us / span_us:.4f}; "
            f"auction kernel {auction_ms:.3f} ms of device time in {len(auction)} launches; "
            f"nms kernel {nms_ms:.4f} ms in {len(nms_runs)}; "
            f"copy / wait runtime calls inside the tracker loop: {json.dumps(waits)}; "
            f"device copies in the chunk: {json.dumps(copies)}; most device time (ms): "
            + json.dumps([[k[:60], round(v, 3)] for k, v in top]))


def phase_main_path(np, torch, counters, card, name, preset, frames, chunks, runs,
                    trace=False, denom=1, check=None):
    """One main path at full width: warm-up chunk, then ``runs`` runs of
    ``chunks`` chunks with every kernel count set to 0 just before each run
    and read just after (replays of the captured tracker step count their
    launches); the chunk split with the graph held to the eager loop; output
    checks. ``denom`` overrides the preset's ``decode_scale_denom``; None
    keeps the preset's own. ``check(pipe)``, when given, runs last, outside
    the counted runs. Returns the launch counts of the first run
    (``launches``), that run's records, the chunk split, frames/s and peak
    memory and, on an int8 path, its quantized convs' times (``int8_convs``,
    else None)."""
    from waymo_2d_tracking_tpu_torch.config import Config, _update
    from waymo_2d_tracking_tpu_torch.pipeline.run import (
        SegmentFrames, SegmentPipeline, tta_active,
    )
    from waymo_2d_tracking_tpu_torch.tracker import init_state, track_segment
    from waymo_2d_tracking_tpu_torch.tracker.graph import track_chunk

    pipeline = dict(preset["pipeline"])
    if denom is not None:
        pipeline["decode_scale_denom"] = denom
    cfg = _update(Config(), {**preset, "pipeline": pipeline})
    chunk = cfg.pipeline.chunk_frames
    tta = tta_active(cfg.pipeline)
    pipe = SegmentPipeline(cfg, device="cuda", seed=0)
    pipe.run_segment(SegmentFrames("warmup", 1, list(range(chunk)), frames[:chunk]))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # frames/s is the host's wall time per run
    seg = SegmentFrames(name, 1, list(range(chunks * chunk)), frames[chunk:(chunks + 1) * chunk])
    fps_runs, launch_runs, first_records = [], [], None
    for _ in range(runs):
        zero_counts(counters)
        t0 = time.perf_counter()
        records, _ = pipe.run_segment(seg)
        wall = time.perf_counter() - t0
        launch_runs.append(read_counts(counters))
        fps_runs.append(seg.num_frames / wall)
        first_records = first_records or records
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"[3] {name} main path (decode_scale_denom {cfg.pipeline.decode_scale_denom}, "
        f"{frames.shape[1]}x{frames.shape[2]} frames), {runs} runs of {seg.num_frames} frames: "
        f"frames/s {json.dumps(fps_runs)} ({card}); peak device memory {peak_gb:.2f} GB; "
        f"records {len(records)}; launches per run {json.dumps(launch_runs)}")
    # one NMS a chunk, one auction a stage and frame, the replays counted
    want = {"nms_mask": chunks, "auction": chunks * chunk * stages_of(cfg)}
    if any(lr[k] != v for lr in launch_runs for k, v in want.items()):
        raise AssertionError(f"{name}: expected {want} launches a run, got {launch_runs}")
    check_int8_count(name, cfg, launch_runs[0])
    if cfg.detector.quant == "int8":
        log(f"[3] {name}: int8 GEMMs per chunk {launch_runs[0]['int8_gemm'] / chunks:.1f}")

    split, split_runs, dets, outs = chunk_split(torch, pipe, frames, chunk, tta)
    int8_convs = (int8_conv_split(np, torch, pipe, frames[:chunk], card)
                  if cfg.detector.quant == "int8" else None)
    views = (2 if cfg.pipeline.tta_flip else 1) * len(cfg.pipeline.tta_scales)
    log(f"[3] {name}: {chunk}-frame chunk split, median of 3, the chunk on the card at source "
        f"size ({card}" + (f"; {views} views, the forward stage holds every view's forward and "
                           f"candidates" if tta else "")
        + f"): {json.dumps(split)}; each run: {json.dumps(split_runs)}; the captured step's "
        f"state and outputs equal the eager loop's bit for bit in each run")

    if trace:
        device_busy(torch, pipe, frames, chunk, card)
        # no synchronizing call inside the tracker loop, eager or replayed:
        # one that set_sync_debug_mode detects raises
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            track_segment(init_state(cfg.tracker, device="cuda"), dets[:16], cfg.tracker)
            track_chunk(init_state(cfg.tracker, device="cuda"), dets, cfg.tracker, pipe._graphs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        log(f"[3] {name}: 16 eager tracker steps and {chunk} replays of the captured step ran "
            "with torch.cuda.set_sync_debug_mode('error'): no synchronizing call detected")

    d = dets.to_numpy()
    # without a ReID head the detections carry a zero embedding of width 1
    if d.boxes.shape != (chunk, cfg.detector.max_detections, 4) or \
            d.embeds.shape != (chunk, cfg.detector.max_detections, max(cfg.detector.embed_dim, 1)):
        raise AssertionError(f"{name} detections have shapes {d.boxes.shape} {d.embeds.shape}")
    if not (np.isfinite(d.boxes).all() and np.isfinite(d.scores).all()
            and np.isfinite(d.embeds).all()):
        raise AssertionError(f"{name} detections are not finite")
    # random weights: the FCOS heads pass the score threshold; the CenterNet
    # heat may not, and then only the tracker's early exits run
    if cfg.detector.head_family == "fcos" and not d.valid.any():
        raise AssertionError(f"{name}: every detection is invalid")
    norms = np.linalg.norm(d.embeds[d.valid], axis=-1)
    if cfg.detector.embed_dim and not np.allclose(norms, 1.0, atol=1e-3):
        raise AssertionError(f"{name} ReID embeddings are not unit norm")
    if not np.isfinite(outs.to_numpy().boxes).all():
        raise AssertionError(f"{name} track boxes are not finite")
    log(f"[3] {name} outputs finite; valid detections per frame {d.valid.sum(1).mean():.2f}, "
        f"max score {d.scores.max():.3f} (random weights)")
    if check is not None:
        check(pipe)
    del pipe
    torch.cuda.empty_cache()
    return {"launches": launch_runs[0], "records": first_records, "split": split,
            "int8_convs": int8_convs, "fps": fps_runs, "peak_gb": peak_gb}


def check_int8_count(name, cfg, counts):
    """int8 GEMMs ran on a path exactly when its detector is quantized."""
    if (counts["int8_gemm"] > 0) != (cfg.detector.quant == "int8"):
        raise AssertionError(f"{name}: {counts['int8_gemm']} int8 GEMMs with "
                             f"detector.quant={cfg.detector.quant!r}")


def check_denom2(np, torch, card, frames, up, rec1, rec2):
    """The headline at its own ``decode_scale_denom: 2`` on 1280x1920 frames
    (the 640x960 render upscaled 2x by repetition): the card's downscale
    gives back the 640x960 frames byte for byte, so the detector saw what
    the denom-1 run saw; the records are finite and lie in 1280x1920 source
    pixels, twice the denom-1 run's coordinates."""
    from waymo_2d_tracking_tpu_torch.data.preprocess import area_downscale

    for lo in range(0, up.shape[0], 64):
        got = area_downscale(torch.from_numpy(up[lo:lo + 64]).to("cuda"), 2).cpu().numpy()
        if not np.array_equal(got, frames[lo:lo + 64]):
            raise AssertionError("denom 2: the downscale of the upscaled frames is not the render")
    cx = np.array([[r.center_x, r.center_y, r.length, r.width] for r in rec2], float)
    if not (len(rec2) and np.isfinite(cx).all()):
        raise AssertionError("headline_denom2: no records or non-finite records")
    if not (cx[:, 0].max() > 960 and cx[:, 1].max() > 640
            and (np.abs(cx[:, :2]) < 2 * np.array([1920, 1280])).all()):
        raise AssertionError("headline_denom2: record centres are not in 1280x1920 pixels")
    key = lambda r: (r.timestamp_micros, r.object_id)   # noqa: E731
    one = {key(r): r for r in rec1}
    both = [(r, one[key(r)]) for r in rec2 if key(r) in one]
    diff = max((abs(a.center_x - 2 * b.center_x) + abs(a.center_y - 2 * b.center_y)
                for a, b in both), default=float("nan"))
    log(f"[3] headline_denom2: area_downscale of the 2x-upscaled frames equals the 640x960 "
        f"render byte for byte; {len(rec2)} records (denom-1 run {len(rec1)}), centres up to "
        f"{cx[:, 0].max():.1f} x {cx[:, 1].max():.1f} in 1280x1920 pixels; {len(both)} share "
        f"(frame, id) with the denom-1 run, max |centre - 2 x denom-1 centre| {diff:.4f} px "
        f"({card})")


def phase_headlines(np, torch, counters, card):
    from waymo_2d_tracking_tpu_torch.data.synthetic import SyntheticClipConfig, render_video_clip

    chunk = HEADLINE["pipeline"]["chunk_frames"]
    t0 = time.perf_counter()
    frames, _ = render_video_clip(
        SyntheticClipConfig(num_frames=3 * chunk, num_objects=12, seed=3),
        render_hw=(640, 960))
    log(f"[3] rendered {frames.shape[0]} frames at 640x960 on the host in "
        f"{time.perf_counter() - t0:.1f} s ({card})")
    tta = {**HEADLINE, "pipeline": {**HEADLINE["pipeline"], "tta_flip": True,
                                    "tta_scales": [1.0, 0.75]}}
    results = {"headline": phase_main_path(np, torch, counters, card, "headline", HEADLINE,
                                           frames, chunks=2, runs=3, trace=True)}
    # the preset as shipped: decode_scale_denom 2 on source-size frames
    up = frames.repeat(2, axis=1).repeat(2, axis=2)
    results["headline_denom2"] = phase_main_path(np, torch, counters, card, "headline_denom2",
                                                 HEADLINE, up, chunks=2, runs=3, denom=None)
    check_denom2(np, torch, card, frames, up, results["headline"]["records"],
                 results["headline_denom2"]["records"])
    # the repo's committed serving point: headline_int8 as shipped, denom 2
    results["headline_int8"] = phase_main_path(np, torch, counters, card, "headline_int8",
                                               HEADLINE_INT8, up, chunks=2, runs=3, denom=None)
    del up
    bf16, int8 = results["headline_denom2"], results["headline_int8"]
    fwd = {k: r["split"]["detector_forward_ms"] for k, r in (("bf16", bf16), ("int8", int8))}
    convs = int8["int8_convs"]
    log(f"[3] headline_int8 against headline_denom2 on the same chunks ({card}): detector "
        f"forward {fwd['int8']:.3f} ms int8 against {fwd['bf16']:.3f} ms bf16 a chunk; the "
        f"quantized convs alone {convs['int8_conv_ms']:.3f} ms int8 (of which the GEMMs "
        f"{convs['gemm_ms']:.3f}, bound {convs['bound_ms']:.3f}) against "
        f"{convs['bf16_conv_ms']:.3f} ms bf16 cuDNN; {len(int8['records'])} records (bf16 "
        f"{len(bf16['records'])})")
    if not int8["records"]:
        raise AssertionError("headline_int8: no records")
    results["headline_centernet"] = phase_main_path(
        np, torch, counters, card, "headline_centernet", HEADLINE_CENTERNET, frames, chunks=2,
        runs=3)
    results["headline_tta"] = phase_main_path(np, torch, counters, card, "headline_tta", tta,
                                              frames, chunks=1, runs=2)
    paths = {name: r["launches"] for name, r in results.items()}
    return paths, frames


def render_cameras(np, cams: int, frames: int, seed0: int, hw=(640, 960), upscale: int = 2):
    """(frames, cams, H * upscale, W * upscale, 3) uint8: one rendered clip a
    camera (seed0 + camera), upscaled on the host by pixel repetition (a
    1280x1920 render costs about 0.27 s a frame on the host)."""
    from waymo_2d_tracking_tpu_torch.data.synthetic import SyntheticClipConfig, render_video_clip

    out = np.empty((frames, cams, hw[0] * upscale, hw[1] * upscale, 3), np.uint8)
    for c in range(cams):
        clip, _ = render_video_clip(SyntheticClipConfig(num_frames=frames, num_objects=12,
                                                        seed=seed0 + c), render_hw=hw)
        out[:, c] = clip.repeat(upscale, axis=1).repeat(upscale, axis=2)
    return out


def stages_of(cfg) -> int:
    """Association stages a tracker step runs, each one auction launch."""
    t = cfg.tracker
    return 1 + (t.byte_low_threshold > 0) + (t.reid_recovery and t.embed_dim > 0)


def zero_counts(counters):
    for fn in counters.values():
        fn.launches = 0
        fn.last_shape = None


def read_counts(counters):
    return {k: fn.launches for k, fn in counters.items()}


def latency_text(stats) -> str:
    return (f"p50 {stats['p50_ms']:.3f} ms, p90 {stats['p90_ms']:.3f}, p99 "
            f"{stats['p99_ms']:.3f}, max {stats['max_ms']:.3f} over {stats['count']}")


def phase_config4(np, torch, counters, card, frames, name="config4_multicam", backbone=None):
    """BASELINE config 4 at full width: 5 cameras of 1280x1920 frames through
    ``MultiCamPipeline.run_segments_group`` (one 40-image detector batch a
    chunk, the camera-batched tracker, JSONL and gallery sidecars), a warm-up
    chunk, then 2 runs of 4 chunks. ``backbone`` replaces config 4's
    ResNet-50 (``"swin_t"``: 12 window-attention launches a chunk, and the
    class-logit bias raised by ``SWIN_CLASS_BIAS_SHIFT``)."""
    import tempfile

    from waymo_2d_tracking_tpu_torch.config import Config, _update
    from waymo_2d_tracking_tpu_torch.data.preprocess import letterbox_batch
    from waymo_2d_tracking_tpu_torch.pipeline.multicam import MultiCamPipeline, split_cameras
    from waymo_2d_tracking_tpu_torch.pipeline.run import SegmentFrames
    from waymo_2d_tracking_tpu_torch.tracker import init_multicam_state, track_segment
    from waymo_2d_tracking_tpu_torch.tracker.graph import join, track_chunk

    detector = {**CONFIG4["detector"], **({"backbone": backbone} if backbone else {})}
    cfg = _update(Config(), {**CONFIG4, "detector": detector,
                             "tracker": {**CONFIG4["tracker"], **CONFIG4_RANDOM_WEIGHT_GATES}})
    chunk, cams = cfg.pipeline.chunk_frames, len(cfg.pipeline.cameras)
    stages = stages_of(cfg)
    pipe = MultiCamPipeline(cfg, num_cams=cams, device="cuda", seed=0)
    if backbone == "swin_t":
        with torch.no_grad():
            pipe.detector.module.heads.cls_logits.bias.add_(SWIN_CLASS_BIAS_SHIFT)

    def group(lo, hi):
        return [SegmentFrames("config4", cam + 1, list(range(hi - lo)), frames[lo:hi, cam])
                for cam in range(cams)]

    with tempfile.TemporaryDirectory(dir=scratch_dir()) as out:
        pipe.run_segments_group(group(0, chunk), out)                 # warm-up chunk
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        chunks, rates, launch_runs = 4, [], []
        for _ in range(2):
            zero_counts(counters)
            t0 = time.perf_counter()
            stats = pipe.run_segments_group(group(chunk, chunk * (chunks + 1)), out)
            wall = time.perf_counter() - t0
            launch_runs.append(read_counts(counters))
            rates.append(chunks * chunk * cams / wall)
            shapes = (counters["nms_mask"].last_shape, counters["auction"].last_shape)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        side = np.load(os.path.join(out, "config4_3.gallery.npz"))
    per_chunk = {k: v / chunks for k, v in launch_runs[0].items()}
    log(f"[3] {name} main path (5 cameras at 1280x1920, chunk {chunk}), 2 runs of "
        f"{chunks} chunks: camera-frames/s {json.dumps(rates)} ({card}); peak device memory "
        f"{peak_gb:.2f} GB; records per camera {json.dumps([s['records'] for s in stats])}; "
        f"launches per run {json.dumps(launch_runs)}, per chunk {json.dumps(per_chunk)}; last "
        f"NMS launch (B, N) {shapes[0]}, last auction launch (P, n) {shapes[1]}")
    want = {"nms_mask": 1, "auction": chunk * stages,
            "window_attention": 12 if cfg.detector.backbone == "swin_t" else 0}
    check_int8_count(name, cfg, launch_runs[0])
    if any(per_chunk[k] != v for k, v in want.items()) or shapes[0][0] != chunk * cams \
            or shapes[1] != (cams, 128):
        raise AssertionError(f"{name}: expected per chunk {want}, NMS at B={chunk * cams} "
                             f"and the auction at P={cams}, n=128; got {per_chunk}, {shapes}")
    if side["track_id"].shape != (128,) or side["embed"].shape != (128, 128):
        raise AssertionError(f"{name} sidecar shapes {side['embed'].shape}")

    # the split of one chunk, CUDA events, median of 3; the captured step
    # (P = 5 cameras, n = 128) held to the eager loop bit for bit
    runner = pipe.detector
    block = frames[chunk:2 * chunk]
    runs = []
    for _ in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        ev[0].record()
        flat = torch.from_numpy(block.reshape((chunk * cams,) + block.shape[2:])).to("cuda")
        images, _ = letterbox_batch(flat, tuple(block.shape[2:4]), cfg.detector.image_size)
        ev[1].record()
        head_out, p_feats = runner.forward(images)
        ev[2].record()
        dets = runner.postprocess(head_out, p_feats)
        ev[3].record()
        fresh = init_multicam_state(cfg, cams, device="cuda")
        states, outs = track_chunk(fresh, split_cameras(dets, chunk, cams), cfg.tracker,
                                   pipe._graphs)
        join(pipe._graphs, "cuda")
        ev[4].record()
        e_states, e_outs = track_segment(fresh, split_cameras(dets, chunk, cams), cfg.tracker)
        ev[5].record()
        ev[5].synchronize()
        runs.append([ev[i].elapsed_time(ev[i + 1]) for i in range(5)])
        if not (same_records(torch, states, e_states) and same_records(torch, outs, e_outs)):
            raise AssertionError(f"{name}: the captured step differs from the eager loop")
    names = ("letterbox_ms", "detector_forward_ms", "candidates_topk_nms_roi_align_reid_ms",
             "tracker_loop_ms", "tracker_loop_eager_ms")
    split = {k: statistics.median(r[i] for r in runs) for i, k in enumerate(names)}
    log(f"[3] {name}: {chunk}-frame chunk of {cams} cameras ({chunk * cams} images) "
        f"split, median of 3, the letterbox with its pageable copy ({card}): {json.dumps(split)}; "
        f"each run: {json.dumps(runs)}; the captured step's states and outputs equal the eager "
        f"loop's bit for bit in each run")
    d, o = dets.to_numpy(), outs.to_numpy()
    if not (np.isfinite(d.boxes).all() and np.isfinite(d.embeds).all()
            and np.isfinite(o.boxes).all()) or o.valid.shape != (chunk, cams, 128):
        raise AssertionError(f"{name} outputs are not finite or have the wrong shape")
    live = (states.status != 0).sum(-1).tolist()
    log(f"[3] {name} outputs finite; valid detections per image "
        f"{d.valid.sum(1).mean():.2f}, above the lowered tracker gate "
        f"{(d.valid & (d.scores >= cfg.tracker.score_threshold)).sum(1).mean():.2f}, max score "
        f"{d.scores.max():.3f} (random weights); after one chunk ids born per camera "
        f"{json.dumps(states.next_id.tolist())}, live slots per camera {json.dumps(live)}")
    if min(states.next_id.tolist()) == 0:
        raise AssertionError(f"{name}: a camera's tracker never birthed a track")
    del pipe
    torch.cuda.empty_cache()
    return launch_runs[0]


def phase_online(np, torch, counters, card, name, session, frames, ticks, per_tick):
    """``ticks`` steps of an online session after its warm-up, counts set to 0
    just before and read just after; per_tick: the launches one step must
    make."""
    session.warmup(tuple(frames.shape[-3:-1]))
    torch.cuda.synchronize()
    zero_counts(counters)
    records = 0
    for t in range(ticks):
        records += len(session.step(frames[t] if frames.ndim == 4 else list(frames[t]), t))
    counts = read_counts(counters)
    shapes = (counters["nms_mask"].last_shape, counters["auction"].last_shape)
    stats = session.latency_stats()
    log(f"[3] {name}: {ticks} steps after a warm-up ({card}): latency per step "
        f"{latency_text(stats)}; {json.dumps(stats)}; records {records}; launches "
        f"{json.dumps(counts)}, per step {json.dumps({k: v / ticks for k, v in counts.items()})}; "
        f"last NMS launch (B, N) {shapes[0]}, last auction launch (P, n) {shapes[1]}")
    if any(counts[k] != v * ticks for k, v in per_tick.items()):
        raise AssertionError(f"{name}: expected {per_tick} launches per step, got {counts}")
    check_int8_count(name, session.cfg, counts)
    return counts


def phase_new_paths(np, torch, counters, card, headline_frames, plans):
    """Config 4, the online drivers, S3 and phase P (the shipped presets, on
    the same rig frames); saves D2's frames into ``plans``."""
    from waymo_2d_tracking_tpu_torch.config import Config, _update
    from waymo_2d_tracking_tpu_torch.pipeline.online import OnlineMultiCamTracker, OnlineTracker

    t0 = time.perf_counter()
    frames = render_cameras(np, 5, 40, seed0=40)
    log(f"[3] rendered 5 cameras x {frames.shape[0]} frames at 640x960, upscaled to "
        f"{frames.shape[2]}x{frames.shape[3]} on the host in {time.perf_counter() - t0:.1f} s")
    plans["d2"] = save_d2_frames(np, frames)
    paths = {"config4_multicam": phase_config4(np, torch, counters, card, frames)}
    torch.cuda.empty_cache()
    paths["config4_swin_t"] = phase_config4(np, torch, counters, card, frames,
                                            "config4_swin_t", backbone="swin_t")
    torch.cuda.empty_cache()

    cfg4 = _update(Config(), {**CONFIG4, "tracker": {**CONFIG4["tracker"],
                                                     **CONFIG4_RANDOM_WEIGHT_GATES}})
    rig = OnlineMultiCamTracker(cfg4, camera_names=[1, 2, 3, 4, 5], device="cuda", seed=0)
    paths["online_rig"] = phase_online(np, torch, counters, card, "online_rig", rig, frames, 32,
                                       {"nms_mask": 1, "auction": stages_of(cfg4)})
    if counters["auction"].last_shape != (5, 128) or counters["nms_mask"].last_shape[0] != 5:
        raise AssertionError("online_rig: the tick's launches are not one rig-wide launch")
    del rig
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    paths["serve_rig"] = phase_serve_rig(np, torch, counters, card, frames)
    log(f"[S3] done in {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    paths.update(phase_presets(np, torch, counters, card, frames, headline_frames))
    del frames
    torch.cuda.empty_cache()

    cfg = _update(Config(), {**HEADLINE, "pipeline": {**HEADLINE["pipeline"],
                                                      "decode_scale_denom": 1}})
    sess = OnlineTracker(cfg, device="cuda", seed=0)
    paths["online_headline"] = phase_online(np, torch, counters, card, "online_headline", sess,
                                            headline_frames, 64,
                                            {"nms_mask": 1, "auction": stages_of(cfg)})
    return paths


# ----------------------------------------------------------------- phase P

# Phase P runs the shipped presets as shipped but for the tracker gates
# their random weights need: configs 2, 3 and 5 run the default ResNet-50
# detector, which scores at most ~0.23 with seeded random weights, so they
# take config 4's lowered gates (CONFIG4_RANDOM_WEIGHT_GATES). robust runs
# the headline detector, whose random weights score up to ~0.8 (phase 3),
# with its own gates: a score gate of 0.1 would also be refused there, as
# robust's BYTE band starts at 0.1.


def preset_path(file: str) -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", file)


def preset_dict(file: str, gates) -> dict:
    """``configs/<file>`` as a dict with ``gates`` over its tracker section."""
    import yaml

    with open(preset_path(file)) as f:
        data = yaml.safe_load(f)
    data["tracker"] = {**data.get("tracker", {}), **gates}
    return data


@contextlib.contextmanager
def kernel_inputs(module, name):
    """Every call of ``module.<name>`` while the context is open goes through
    to the wrapper, its tensor arguments cloned into the yielded list as
    (args, kwargs): the inputs the path hands the kernel."""
    wrapper = getattr(module, name)
    calls = []

    def record(*args, **kw):
        calls.append(([a.clone() if hasattr(a, "clone") else a for a in args], dict(kw)))
        return wrapper(*args, **kw)

    # the wrapper counts its launch on the module's name for it, ``record``
    # while the context is open: those launches are not a main path's
    record.launches, record.last_shape = 0, None
    setattr(module, name, record)
    try:
        yield calls
    finally:
        setattr(module, name, wrapper)


def preset_kernels(torch, card, name, cfg, detect, init, want_nms, want_auction):
    """NMS and the auction at a preset's own shapes: ``detect()`` gives one
    chunk's detections (its NMS inputs recorded: the candidate union after
    the ``nms_topk`` cut), the eager loop over them from ``init`` records
    every stage's benefit tensors; the frame with the most feasible problems
    goes through each kernel and its plain version on the card, which must
    agree bit for bit, at (B, N) ``want_nms`` and (P, n) ``want_auction``."""
    from waymo_2d_tracking_tpu_torch.ops import assign, nms
    from waymo_2d_tracking_tpu_torch.tracker import track_segment

    with kernel_inputs(nms, "nms_mask_cuda") as nms_calls:
        dets = detect()
    with kernel_inputs(assign, "auction_kernel_cuda") as auction_calls:
        track_segment(init, dets, cfg.tracker)
    torch.cuda.synchronize()
    if len(nms_calls) != 1:
        raise AssertionError(f"{name}: {len(nms_calls)} NMS launches in one chunk's detect")
    (boxes, valid, thr), _ = nms_calls[0]
    keep, plain = nms.nms_mask_cuda(boxes, valid, thr), nms.nms_mask_reference(boxes, valid, thr)
    if tuple(valid.shape) != want_nms or not torch.equal(keep, plain):
        raise AssertionError(f"{name}: NMS at {tuple(valid.shape)} (want {want_nms}) differs "
                             f"from its plain version in {int((keep != plain).sum())} entries")
    nms_ms = cuda_time_ms(lambda: nms.nms_mask_cuda(boxes, valid, thr), reps=20)
    stages = stages_of(cfg)
    frames = [auction_calls[t:t + stages] for t in range(0, len(auction_calls), stages)]
    pick = max(range(len(frames)),
               key=lambda t: (sum(int(args[2].sum()) for args, _ in frames[t]), t))
    report = []
    for stage, ((ben, eps0, feasible), kw) in enumerate(frames[pick]):
        got = assign.auction_kernel_cuda(ben, eps0, feasible, **kw)
        want = assign.auction_kernel_reference(ben, eps0, feasible, **kw)[0]
        if (ben.shape[0], ben.shape[-1]) != want_auction or not torch.equal(got, want):
            raise AssertionError(f"{name}: auction stage {stage} at {tuple(ben.shape)} (want "
                                 f"(P, n) {want_auction}) differs from its plain version")
        ms = cuda_time_ms(lambda: assign.auction_kernel_cuda(ben, eps0, feasible, **kw), reps=10)
        report.append({"stage": stage, "feasible": int(feasible.sum()),
                       "assigned": int((got >= 0).sum()), "ms": round(ms, 4)})
    if not report[0]["feasible"]:
        raise AssertionError(f"{name}: no feasible first-stage problem in any frame of the chunk")
    log(f"[{name}] kernels at the preset's shapes, bit-equal to their plain versions on the "
        f"card ({card}): NMS (B, N) {tuple(valid.shape)}, {int(valid.sum())} valid candidates, "
        f"{int(keep.sum())} kept, {nms_ms:.4f} ms a launch; the auction in frame {pick} of "
        f"{len(frames)} (the most feasible problems), {stages} stage(s) at (P, n) "
        f"{want_auction}: {json.dumps(report)}")


def preset_cli(np, torch, card, name, file, gates, cfg, frames, direct):
    """``cli track --config configs/<file>`` (``--multicam`` for a rig) on a
    directory segment that ``materialize_directory_segment`` writes from
    ``frames`` ((T, H, W, 3), or (T, cams, H, W, 3) for a rig), against
    ``direct(segments, out_dir)``, the driver called directly with the same
    seeded weights: every camera's JSONL byte-equal."""
    from waymo_2d_tracking_tpu_torch.data.waymo import (
        CAMERA_NAMES, iter_segments, materialize_directory_segment,
    )

    root = os.path.join(scratch_dir(), f"preset_{name}")
    shutil.rmtree(root, ignore_errors=True)
    segs, cli_out, direct_out = (os.path.join(root, d) for d in ("segs", "cli", "direct"))
    ts = [100_000 * t for t in range(frames.shape[0])]
    rig = frames.ndim == 5
    cams = cfg.pipeline.cameras if rig else cfg.pipeline.cameras[:1]
    for c, cam in enumerate(cams):
        materialize_directory_segment(segs, name, frames[:, c] if rig else frames, ts,
                                      camera_id=CAMERA_NAMES[cam])
    sets = ["--set"] + [f"tracker.{k}={v}" for k, v in gates.items()] if gates else []
    argv = (["track", "--config", preset_path(file), "--segments-dir", segs, "--out-dir",
             cli_out] + (["--multicam"] if rig else []) + sets)
    code, lines = cli_quiet(argv)
    if code not in (None, 0):
        raise AssertionError(f"{name}: {' '.join(argv)} exited {code}")
    direct(iter_segments(segs, cameras=cfg.pipeline.cameras), direct_out)
    names = sorted(f for f in os.listdir(direct_out) if f.endswith(".jsonl")
                   and f != "manifest.jsonl")
    records = []
    for f in names:
        with open(os.path.join(cli_out, f), "rb") as a, open(os.path.join(direct_out, f),
                                                            "rb") as b:
            got, want = a.read(), b.read()
        if got != want:
            raise AssertionError(f"{name}: cli track wrote other bytes than the driver in {f}")
        records.append(want.count(b"\n"))
    if len(names) != len(cams) or not sum(records):
        raise AssertionError(f"{name}: cli track wrote {names} with {records} records")
    log(f"[{name}] cli track --config configs/{file}{' --multicam' if rig else ''} "
        f"{' '.join(sets)} on a {frames.shape[0]}-frame directory segment "
        f"({len(cams)} camera(s), JPEG) byte-equal to the driver called directly: records per "
        f"camera {records}; stats {lines} ({card})")
    shutil.rmtree(root, ignore_errors=True)


def phase_preset(np, torch, counters, card, name, file, gates, frames, chunks):
    """P2-P4: one shipped single-camera preset through ``phase_main_path``
    (a warm-up chunk, 2 runs of ``chunks`` chunks, the split with the graph
    held to the eager loop, launch counts), then the kernels at its shapes
    and ``cli track`` against the driver."""
    from waymo_2d_tracking_tpu_torch.data.preprocess import area_downscale, letterbox_batch
    from waymo_2d_tracking_tpu_torch.ops.assign import _round_up_128
    from waymo_2d_tracking_tpu_torch.pipeline.run import dispatch_detect, run_segments
    from waymo_2d_tracking_tpu_torch.tracker import init_state

    t0 = time.perf_counter()

    def check(pipe):
        cfg = pipe.cfg
        chunk, sd = cfg.pipeline.chunk_frames, cfg.pipeline.decode_scale_denom
        src_hw = tuple(-(-x // sd) for x in frames.shape[1:3])

        def detect():
            block = area_downscale(torch.from_numpy(frames[:chunk]).to("cuda"), sd)
            images, _ = letterbox_batch(block, src_hw, cfg.detector.image_size)
            return dispatch_detect(pipe.detector, cfg, images)

        n = _round_up_128(max(cfg.tracker.max_tracks, cfg.detector.max_detections))
        preset_kernels(torch, card, name, cfg, detect, init_state(cfg.tracker, device="cuda"),
                       (chunk, cfg.detector.nms_topk), (1, n))
        preset_cli(np, torch, card, name, file, gates, cfg, frames[:min(chunk, 16)],
                   lambda segs, out: run_segments(pipe, segs, out))

    result = phase_main_path(np, torch, counters, card, name, preset_dict(file, gates), frames,
                             chunks=chunks, runs=2, denom=None, check=check)
    if not result["records"]:
        raise AssertionError(f"{name}: the main path wrote no records")
    log(f"[{name}] configs/{file} done in {time.perf_counter() - t0:.1f} s ({card})")
    return result


def tta_split(torch, pipe, block):
    """Config 5's chunk split, CUDA events, the chunk ((chunk, cams, H, W, 3)
    host frames at source size) copied and letterboxed, then each view's
    scale, flip, forward and candidates timed alone (the unflipped 1.0 view
    reuses the base forward, which the first stage holds), then the union's
    NMS, RoIAlign and ReID, the tracker loop graphed and the eager loop on
    the same detections, which must agree bit for bit."""
    from waymo_2d_tracking_tpu_torch.data.preprocess import letterbox_batch
    from waymo_2d_tracking_tpu_torch.models.detector import gather_candidates_batched
    from waymo_2d_tracking_tpu_torch.pipeline.multicam import split_cameras
    from waymo_2d_tracking_tpu_torch.pipeline.tta import flip_image, scale_image, unflip_boxes
    from waymo_2d_tracking_tpu_torch.tracker import init_multicam_state, track_segment
    from waymo_2d_tracking_tpu_torch.tracker.graph import join, track_chunk

    cfg, runner = pipe.cfg, pipe.detector
    chunk, cams = block.shape[:2]
    views = [(s, f) for s in cfg.pipeline.tta_scales for f in (False, True)]
    names = (["letterbox_ms", "base_forward_ms"]
             + [f"view_{s}{'_flip' if f else ''}_ms" for s, f in views]
             + ["union_nms_roi_align_reid_ms", "tracker_loop_ms", "tracker_loop_eager_ms"])
    runs = []
    for _ in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
        ev[0].record()
        flat = torch.from_numpy(block.reshape((chunk * cams,) + block.shape[2:])).to("cuda")
        images, _ = letterbox_batch(flat, tuple(block.shape[2:4]), cfg.detector.image_size)
        ev[1].record()
        base, p_feats = runner.forward(images)
        ev[2].record()
        cand = []
        for i, (s, flipped) in enumerate(views):
            img = scale_image(images, s) if s != 1.0 else images
            head = base if (s == 1.0 and not flipped) else runner.forward(
                flip_image(img) if flipped else img)[0]
            boxes, scores, classes = gather_candidates_batched(head, cfg.detector)
            if flipped:
                boxes = unflip_boxes(boxes, img.shape[2])
            cand.append((boxes / s, scores, classes))
            ev[3 + i].record()
        union = tuple(torch.cat([c[k] for c in cand], dim=1) for k in range(3))
        dets = split_cameras(runner.select(union, p_feats), chunk, cams)
        ev[3 + len(views)].record()
        fresh = init_multicam_state(cfg, cams, device="cuda")
        states, outs = track_chunk(fresh, dets, cfg.tracker, pipe._graphs)
        join(pipe._graphs, "cuda")
        ev[4 + len(views)].record()
        e_states, e_outs = track_segment(fresh, dets, cfg.tracker)
        ev[5 + len(views)].record()
        ev[-1].synchronize()
        runs.append([ev[i].elapsed_time(ev[i + 1]) for i in range(len(names))])
        if not (same_records(torch, states, e_states) and same_records(torch, outs, e_outs)):
            raise AssertionError("P5: the captured step differs from the eager loop")
    return {k: statistics.median(r[i] for r in runs) for i, k in enumerate(names)}, runs, dets


def phase_config5(np, torch, counters, card, frames):
    """P5: ``configs/config5_full_sweep.yaml`` through
    ``MultiCamPipeline.run_segments_group``: 5 cameras of 1280x1920 frames,
    chunk 4, six TTA views (flip x 0.75 / 1.0 / 1.25: a 20-image forward a
    view, up to 1600x2400), ReID recovery, gap fill 5; a warm-up chunk, then
    2 runs of 2 chunks: camera-frames/s, peak memory, launches per chunk (1
    NMS at (20, 1024), 8 auction at P = 5, n = 128), the split with every
    view alone, the kernels at these shapes, each camera against a
    single-camera ``SegmentPipeline`` on its frames (the invariant of the
    JAX package's ``test_multicam_tta.py``, in float32), and ``cli track
    --multicam`` against ``run_context_groups``."""
    import tempfile

    from waymo_2d_tracking_tpu_torch.config import load_config
    from waymo_2d_tracking_tpu_torch.data.preprocess import letterbox_batch
    from waymo_2d_tracking_tpu_torch.io_out import submission as subm
    from waymo_2d_tracking_tpu_torch.pipeline.multicam import (
        MultiCamPipeline, run_context_groups, split_cameras,
    )
    from waymo_2d_tracking_tpu_torch.pipeline.run import (
        SegmentFrames, SegmentPipeline, dispatch_detect,
    )
    from waymo_2d_tracking_tpu_torch.tracker import init_multicam_state

    t0 = time.perf_counter()
    file, gates = "config5_full_sweep.yaml", CONFIG4_RANDOM_WEIGHT_GATES
    cfg = load_config(preset_path(file), {"tracker": gates})
    chunk, cams = cfg.pipeline.chunk_frames, len(cfg.pipeline.cameras)
    views = (2 if cfg.pipeline.tta_flip else 1) * len(cfg.pipeline.tta_scales)
    stages = stages_of(cfg)
    pipe = MultiCamPipeline(cfg, num_cams=cams, device="cuda", seed=0)

    def group(lo, hi):
        return [SegmentFrames("config5", cam + 1, list(range(hi - lo)), frames[lo:hi, cam])
                for cam in range(cams)]

    chunks = 2
    with tempfile.TemporaryDirectory(dir=scratch_dir()) as out:
        pipe.run_segments_group(group(0, chunk), out)                 # warm-up chunk
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rates, launch_runs = [], []
        for _ in range(2):
            zero_counts(counters)
            t1 = time.perf_counter()
            stats = pipe.run_segments_group(group(chunk, chunk * (chunks + 1)), out)
            wall = time.perf_counter() - t1
            launch_runs.append(read_counts(counters))
            rates.append(chunks * chunk * cams / wall)
            shapes = (counters["nms_mask"].last_shape, counters["auction"].last_shape)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        multi = {cam + 1: subm.read_jsonl(os.path.join(out, f"config5_{cam + 1}.jsonl"))
                 for cam in range(cams)}
    per_chunk = {k: v / chunks for k, v in launch_runs[0].items()}
    log(f"[P5] config5_full_sweep main path ({cams} cameras at {frames.shape[2]}x"
        f"{frames.shape[3]}, chunk {chunk}, {views} views), 2 runs of {chunks} chunks: "
        f"camera-frames/s {json.dumps(rates)} ({card}); peak device memory {peak_gb:.2f} GB; "
        f"records per camera {json.dumps([s['records'] for s in stats])}; launches per run "
        f"{json.dumps(launch_runs)}, per chunk {json.dumps(per_chunk)}; last NMS launch (B, N) "
        f"{shapes[0]}, last auction launch (P, n) {shapes[1]}")
    want = {"nms_mask": 1, "auction": chunk * stages}
    check_int8_count("P5", cfg, launch_runs[0])
    if any(lr[k] != v * chunks for lr in launch_runs for k, v in want.items()) \
            or shapes[0] != (chunk * cams, cfg.detector.nms_topk) or shapes[1] != (cams, 128):
        raise AssertionError(f"P5: expected per chunk {want}, NMS at ({chunk * cams}, "
                             f"{cfg.detector.nms_topk}), the auction at (5, 128); got "
                             f"{launch_runs}, {shapes}")
    if not all(multi.values()):
        raise AssertionError("P5: a camera has no records")

    split, split_runs, dets = tta_split(torch, pipe, frames[chunk:2 * chunk])
    log(f"[P5] {chunk}-frame chunk of {cams} cameras ({chunk * cams} images, {views} views) "
        f"split, median of 3, the letterbox with its pageable copy ({card}): "
        f"{json.dumps(split)}; each run: {json.dumps(split_runs)}; the captured step's states "
        f"and outputs equal the eager loop's bit for bit in each run")
    d = dets.to_numpy()
    if not (np.isfinite(d.boxes).all() and np.isfinite(d.embeds).all() and d.valid.any()):
        raise AssertionError("P5: detections are not finite or none is valid")

    def detect():
        block = frames[chunk:2 * chunk]
        flat = torch.from_numpy(block.reshape((chunk * cams,) + block.shape[2:])).to("cuda")
        images, _ = letterbox_batch(flat, tuple(block.shape[2:4]), cfg.detector.image_size)
        return split_cameras(dispatch_detect(pipe.detector, cfg, images), chunk, cams)

    preset_kernels(torch, card, "P5", cfg, detect, init_multicam_state(cfg, cams, device="cuda"),
                   (chunk * cams, cfg.detector.nms_topk), (cams, 128))

    # each camera alone through the single-camera driver, the same seeded
    # weights, against the rig (the JAX package's test_multicam_tta.py
    # invariant), in float32 (TF32 off) with the single camera's chunk the
    # rig's batch (the pad repeats its last frame): on the card an image's
    # bf16 forward rounds by the batch's size and by where the image sits in
    # it (its 0.75 view's P4 logits by up to 0.24 at a 20-image batch's last
    # place, probed), which moves random-weight detections and so the tracks;
    # in float32 a 20-image batch gives each image the same bits anywhere
    batch = chunk * cams
    f32 = dataclasses.replace(cfg, detector=dataclasses.replace(cfg.detector, dtype="float32"))
    rig32 = MultiCamPipeline(f32, num_cams=cams, device="cuda", seed=0)
    solo = SegmentPipeline(dataclasses.replace(
        f32, pipeline=dataclasses.replace(f32.pipeline, chunk_frames=batch)), device="cuda", seed=0)
    agree = []
    with tempfile.TemporaryDirectory(dir=scratch_dir()) as out:
        rig32.run_segments_group(group(0, chunk), out)
        for cam, seg in enumerate(group(0, chunk)):
            records, _ = solo.run_segment(seg)
            subm.write_jsonl(os.path.join(out, "solo.jsonl"), records)
            with open(os.path.join(out, "solo.jsonl"), "rb") as a, \
                    open(os.path.join(out, f"config5_{cam + 1}.jsonl"), "rb") as b:
                agree.append((a.read() == b.read(), len(records)))
    del rig32, solo
    log(f"[P5] each camera of a {chunk}-frame rig run against a single-camera SegmentPipeline "
        f"on its own frames, the same TTA preset in float32 with chunk {batch} (the rig's "
        f"batch): JSONL byte-equal, records {agree} ({card})")
    if not all(ok and n for ok, n in agree):
        raise AssertionError(f"P5: cameras {[c + 1 for c, (ok, _) in enumerate(agree) if not ok]}"
                             " differ from their single-camera runs")
    preset_cli(np, torch, card, "P5", file, gates, cfg, frames[chunk:2 * chunk],
               lambda segs, out: run_context_groups(pipe, segs, out))
    del pipe
    torch.cuda.empty_cache()
    log(f"[P5] configs/{file} done in {time.perf_counter() - t0:.1f} s ({card})")
    return {"launches": launch_runs[0], "fps": rates, "peak_gb": peak_gb, "split": split}


def phase_presets(np, torch, counters, card, rig_frames, headline_frames):
    """P. The shipped presets no earlier phase runs, as shipped apart from
    the gates above, cut in depth only: P2 config 2 and P3 config 3 on
    camera 1 of the config-4 rig's 1280x1920 frames (chunk 8), P4 robust on
    the headline's 640x960 render upscaled to 1280x1920 and decoded at its
    denom 2 (chunk 128, three association stages), P5 config 5 on the rig.
    Returns each path's launches."""
    t0 = time.perf_counter()
    front = np.ascontiguousarray(rig_frames[:, 0])
    paths = {name: phase_preset(np, torch, counters, card, name, file,
                                CONFIG4_RANDOM_WEIGHT_GATES, front, chunks=2)["launches"]
             for name, file in (("P2", "config2_detector_iou.yaml"),
                                ("P3", "config3_reid_fused.yaml"))}
    del front
    up = headline_frames.repeat(2, axis=1).repeat(2, axis=2)
    paths["P4"] = phase_preset(np, torch, counters, card, "P4", "robust.yaml", {}, up,
                               chunks=2)["launches"]
    del up
    paths["P5"] = phase_config5(np, torch, counters, card, rig_frames)["launches"]
    log(f"[P] done in {time.perf_counter() - t0:.1f} s ({card})")
    return paths


# ----------------------------------------------------------------- phase S

def write_config(cfg, name: str) -> str:
    """``cfg`` as a yaml preset for the port's ``--config``, under the
    scratch directory."""
    import yaml

    path = os.path.join(scratch_dir(), name)
    with open(path, "w") as f:
        yaml.safe_dump(dataclasses.asdict(cfg), f)
    return path


def short_path(name: str) -> str:
    """A path under the scratch directory, relative to the working directory
    when that is shorter (an AF_UNIX path has at most 107 bytes)."""
    path = os.path.join(scratch_dir(), name)
    rel = os.path.relpath(path)
    return rel if len(rel) < len(path) else path


class Serving:
    """``cli.main(["serve", "--socket", sock, *argv])`` in a thread: entered
    when the socket exists (after the warm-up), left when the server has
    ended; an exception of the server's is raised on exit."""

    def __init__(self, sock: str, argv):
        self.sock, self.argv, self.error = sock, list(argv), None
        self.thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        from waymo_2d_tracking_tpu_torch import cli

        try:
            cli.main(["serve", "--socket", self.sock] + self.argv)
        except BaseException as e:   # handed to the main thread on exit
            self.error = e

    def __enter__(self):
        self.thread.start()
        while not os.path.exists(self.sock):
            if not self.thread.is_alive():
                raise RuntimeError(f"serve ended before binding: {self.error!r}")
            time.sleep(0.02)
        return self

    def __exit__(self, *exc):
        self.thread.join(timeout=120)
        if self.thread.is_alive():
            raise RuntimeError("serve did not end after close")
        if self.error is not None and exc[0] is None:
            raise self.error


def served_step(client, frame, ts):
    """One frame through the socket; the reply must say ok true."""
    reply = client.step(frame, timestamp_micros=ts)
    if reply.get("ok") is not True:
        raise AssertionError(f"server reply not ok: {reply}")
    return reply


def record_dicts(records):
    return [dataclasses.asdict(r) for r in records]


def percentiles(ms):
    return {f"p{q}_ms": round(float(statistics.quantiles(ms, n=100)[q - 1]), 3)
            for q in (50, 90, 99)} if len(ms) > 1 else {}


def phase_serve_fixture(np, torch, counters, card, fixture):
    """S1: the trained fixture (slim, f32) behind ``serve`` on an AF_UNIX
    socket, the seed-5 clip sent as raw payloads: the records equal phase
    2's direct ``OnlineTracker`` records bit for bit, hence its metrics."""
    from waymo_2d_tracking_tpu_torch.eval.mot import evaluate_mot, gt_to_frames
    from waymo_2d_tracking_tpu_torch.io_out.submission import TrackRecord
    from waymo_2d_tracking_tpu_torch.pipeline.server import TrackingClient
    from waymo_2d_tracking_tpu_torch.weights import FIXTURES_DIR

    cfg, frames, direct, gt = (fixture[k] for k in ("cfg", "frames", "records", "gt"))
    sock = short_path("s1.sock")
    h, w = frames.shape[1:3]
    argv = ["--config", write_config(cfg, "s1.yaml"),
            "--params", os.path.join(FIXTURES_DIR, "pixels_detector.npz"),
            "--warmup", str(h), str(w)]
    served = []
    with Serving(sock, argv):
        zero_counts(counters)
        with TrackingClient(socket_path=sock) as c:
            c.reset(context_name="fixture")
            for t in range(frames.shape[0]):
                served.extend(served_step(c, frames[t], t)["records"])
            stats = c.stats()
            c.close_server()
    counts = read_counts(counters)
    if served != record_dicts(direct):
        raise AssertionError("S1: the records served differ from the direct OnlineTracker's")
    m = evaluate_mot(gt_to_frames(gt), records_to_frames(
        np, [TrackRecord(**r) for r in served], frames.shape[0])).as_dict()
    got = {k: (round(m[k], 4) if isinstance(m[k], float) else m[k])
           for k in FIXTURE_GOLDEN["seed5"]}
    log(f"[S1] serve (fixture, f32, {h}x{w} raw payloads over AF_UNIX, {card}): "
        f"{frames.shape[0]} frames, {len(served)} records bit-equal to the direct session's; "
        f"metrics {json.dumps(got)} (golden {json.dumps(FIXTURE_GOLDEN['seed5'])}); server "
        f"latency {json.dumps(stats['stats'])}; launches {json.dumps(counts)}")
    if got != FIXTURE_GOLDEN["seed5"]:
        raise AssertionError(f"S1: served metrics {got} differ from the golden")
    n = frames.shape[0]
    if counts["nms_mask"] != n or counts["auction"] != n * stages_of(cfg):
        raise AssertionError(f"S1: expected {n} NMS and {n * stages_of(cfg)} auction launches")
    return counts


def gated(preset):
    """A preset with the tracker gates lowered for seeded random weights, as
    phase 2b does."""
    from waymo_2d_tracking_tpu_torch.config import Config, _update

    return _update(Config(), {**preset, "tracker": {**CONFIG4_RANDOM_WEIGHT_GATES,
                                                     **preset.get("tracker", {})}})


def find_trace_names(trace_dir, names):
    """Which of ``names`` occur in the Chrome traces under ``trace_dir``."""
    found = set()
    for f in os.listdir(trace_dir):
        with open(os.path.join(trace_dir, f)) as fh:
            text = fh.read()
        found |= {n for n in names if n in text}
    return found


def phase_serve_headline(np, torch, counters, card, frames):
    """S2: the headline at full width (640x960 raw frames, seeded weights,
    gates lowered): 64 frames through the socket bit-equal to a direct
    ``OnlineTracker``, 1 NMS and 2 auction launches a served frame, latency
    through the socket beside the direct session's; a snapshot after frame 8
    restored into a second server (traced with ``--profile``) and a restart
    through ``--state-file`` each continuing exactly as the uninterrupted
    run; the ingest fixture's 1280x1920 JPEGs through a ``headline_denom2``
    server warmed with ``--warmup 1280 1920``."""
    from waymo_2d_tracking_tpu_torch.config import _update
    from waymo_2d_tracking_tpu_torch.data import waymo
    from waymo_2d_tracking_tpu_torch.pipeline.online import OnlineTracker
    from waymo_2d_tracking_tpu_torch.pipeline.server import TrackingClient
    from waymo_2d_tracking_tpu_torch.weights import FIXTURES_DIR

    n, cut = 64, 8
    cfg = gated({**HEADLINE, "pipeline": {**HEADLINE["pipeline"], "decode_scale_denom": 1}})
    conf = write_config(cfg, "s2.yaml")
    hw = [str(v) for v in frames.shape[1:3]]
    sess = OnlineTracker(cfg, device="cuda", seed=0)
    sess.warmup(tuple(frames.shape[1:3]))
    direct = [record_dicts(sess.step(frames[t], t)) for t in range(n)]
    direct_lat = sess.latency_stats()
    sess.close()
    del sess

    sock = short_path("s2.sock")
    served, rtt = [], []
    with Serving(sock, ["--config", conf, "--warmup", *hw]):
        zero_counts(counters)
        with TrackingClient(socket_path=sock) as c:
            for t in range(n):
                t0 = time.perf_counter()
                served.append(served_step(c, frames[t], t)["records"])
                rtt.append((time.perf_counter() - t0) * 1e3)
                if t == cut - 1:
                    snap = c.snapshot()
            counts = read_counts(counters)
            server_lat = c.stats()["stats"]
            c.close_server()
    if served != direct:
        bad = next(t for t in range(n) if served[t] != direct[t])
        raise AssertionError(f"S2: served records differ from the direct session at frame {bad}")
    if counts["nms_mask"] != n or counts["auction"] != n * stages_of(cfg):
        raise AssertionError(f"S2: expected 1 NMS and {stages_of(cfg)} auction launches a "
                             f"frame, got {counts} over {n} frames")
    log(f"[S2] serve headline (640x960 raw, bf16, seeded weights, gates lowered; {card}): "
        f"{n} frames bit-equal to the direct OnlineTracker, {sum(map(len, served))} records; "
        f"launches {json.dumps(counts)} ({counts['nms_mask'] / n:g} NMS, "
        f"{counts['auction'] / n:g} auction a frame); latency through the socket (client round "
        f"trip, {n} frames incl. the first) {json.dumps(percentiles(rtt))}, server-side "
        f"{latency_text(server_lat)}; direct session {latency_text(direct_lat)}")

    # failover: the snapshot after frame 8 into a second server, traced
    trace_dir = os.path.join(scratch_dir(), "s2_trace")
    sock_b = short_path("s2b.sock")
    with Serving(sock_b, ["--config", conf, "--warmup", *hw, "--profile", trace_dir]):
        with TrackingClient(socket_path=sock_b) as c:
            c.restore(snap["blob"], context_name=snap["context_name"])
            cont = [served_step(c, frames[t], t)["records"] for t in range(cut, 2 * cut)]
            c.close_server()
    if cont != direct[cut:2 * cut]:
        raise AssertionError("S2: the restored server's continuation differs")
    names = find_trace_names(trace_dir, ("nms_mask_kernel", "auction_kernel"))
    if names != {"nms_mask_kernel", "auction_kernel"}:
        raise AssertionError(f"S2: the --profile trace holds {sorted(names)} of the two kernels")

    # planned restart: --state-file written at exit, restored at the next start
    state_file = os.path.join(scratch_dir(), "s2.state")
    if os.path.exists(state_file):
        os.unlink(state_file)
    sock_c = short_path("s2c.sock")
    with Serving(sock_c, ["--config", conf, "--warmup", *hw, "--state-file", state_file]):
        with TrackingClient(socket_path=sock_c) as c:
            for t in range(cut):
                served_step(c, frames[t], t)
            c.close_server()
    with Serving(sock_c, ["--config", conf, "--warmup", *hw, "--state-file", state_file]):
        with TrackingClient(socket_path=sock_c) as c:
            again = [served_step(c, frames[t], t)["records"] for t in range(cut, 2 * cut)]
            c.close_server()
    if again != direct[cut:2 * cut]:
        raise AssertionError("S2: the restarted server's continuation differs")
    log(f"[S2] snapshot after frame {cut} restored into a second server, and a restart through "
        f"--state-file: frames {cut}-{2 * cut - 1} bit-equal to the uninterrupted run; the "
        f"restored server's --profile trace names both kernels {sorted(names)}")

    # compressed payloads: the ingest fixture's JPEGs at the shipped denom 2
    cfg2 = gated(HEADLINE)
    fixture = json.load(open(os.path.join(FIXTURES_DIR, "ingest_fixture.json")))
    (seg,) = [s for s in waymo.iter_segments(FIXTURES_DIR)
              if s.context_name == fixture["context_name"]]
    blobs = seg.jpeg_frames[0:seg.num_frames]
    sess = OnlineTracker(cfg2, device="cuda", seed=0)
    direct2 = [record_dicts(sess.step(b, t)) for t, b in enumerate(blobs)]
    sess.close()
    sock_d = short_path("s2d.sock")
    zero_counts(counters)
    with Serving(sock_d, ["--config", write_config(cfg2, "s2_denom2.yaml"),
                          "--warmup", "1280", "1920"]):
        with TrackingClient(socket_path=sock_d) as c:
            served2 = [served_step(c, b, t)["records"] for t, b in enumerate(blobs)]
            jpeg_lat = c.stats()["stats"]
            c.close_server()
    if served2 != direct2 or not any(served2):
        raise AssertionError("S2: JPEG payloads through the denom-2 server differ from the "
                             "direct session")
    log(f"[S2] headline_denom2 server (--warmup 1280 1920) on the {len(blobs)} ingest JPEGs "
        f"(1280x1920): {sum(map(len, served2))} records bit-equal to the direct session on the "
        f"same bytes; server-side latency {latency_text(jpeg_lat)}")
    return counts


def phase_serve_rig(np, torch, counters, card, frames, ticks=8):
    """S3: ``serve --multicam`` at config 4 (5 cameras of 1280x1920 raw as
    [5, H, W, 3]), ``ticks`` ticks equal to a direct
    ``OnlineMultiCamTracker``."""
    from waymo_2d_tracking_tpu_torch.pipeline.online import OnlineMultiCamTracker
    from waymo_2d_tracking_tpu_torch.pipeline.server import TrackingClient

    cfg = gated(CONFIG4)
    cams = len(cfg.pipeline.cameras)
    hw = [str(v) for v in frames.shape[2:4]]
    rig = OnlineMultiCamTracker(cfg, camera_names=list(range(1, cams + 1)), device="cuda", seed=0)
    rig.warmup(tuple(frames.shape[2:4]))
    direct = [record_dicts(rig.step(list(frames[t]), t)) for t in range(ticks)]
    rig.close()
    del rig
    sock = short_path("s3.sock")
    with Serving(sock, ["--config", write_config(cfg, "s3.yaml"), "--multicam",
                        "--warmup", *hw]):
        zero_counts(counters)
        with TrackingClient(socket_path=sock) as c:
            served = [served_step(c, list(frames[t]), t)["records"] for t in range(ticks)]
            counts = read_counts(counters)
            lat = c.stats()["stats"]
            c.close_server()
    if served != direct or not any(served):
        raise AssertionError("S3: the rig server's records differ from the direct session")
    if counts["nms_mask"] != ticks or counts["auction"] != ticks * stages_of(cfg):
        raise AssertionError(f"S3: expected one NMS and {stages_of(cfg)} auction launch a "
                             f"tick, got {counts}")
    log(f"[S3] serve --multicam at config 4 ({cams} cameras x {hw[0]}x{hw[1]} raw, "
        f"{ticks} ticks; {card}): records bit-equal to the direct OnlineMultiCamTracker "
        f"({sum(map(len, served))}); launches {json.dumps(counts)}; server-side latency a tick "
        f"{latency_text(lat)}")
    return counts


# ----------------------------------------------------------------- phase C

def cli_quiet(argv):
    """``cli.main(argv)`` with its standard output captured; returns (code,
    the output's lines)."""
    from waymo_2d_tracking_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = cli.main(argv)
    return code, buf.getvalue().splitlines()


def same_report(a, b) -> bool:
    """Two ``tune`` reports agree: trials, knobs, counts and ratios exactly,
    MOTP within 1e-6."""
    if {k: a[k] for k in ("objective", "trials", "seed", "best_overrides")} != \
            {k: b[k] for k in ("objective", "trials", "seed", "best_overrides")}:
        return False
    keys = ("trial", "knobs", "records", "mota", "idf1", "num_idsw", "num_fp", "num_fn")
    return all({k: x[k] for k in keys} == {k: y[k] for k in keys}
               and abs(x["motp"] - y["motp"]) <= 1e-6
               for x, y in zip(a["results"], b["results"])) \
        and len(a["results"]) == len(b["results"])


def phase_cli(np, torch, counters, card, fixture, frames):
    """C: the port's command line on the card. ``track --segments-dir`` on
    the ingest TFRecord (``headline_denom2``) against ``run_segments``
    called directly, ``track --online`` and ``detect`` on it; ``draw`` of
    those tracks into JPEGs and an MJPG video, and ``track --video`` on that
    video against a direct ``OnlineTracker`` on its frames; ``tune
    --trials 4`` on the fixture clip's detections, the same report on the
    card and with ``--workers 2``, the same trials and knobs with ``--device
    cpu`` and each trial's agreement with it reported; ``export
    --platform cuda`` loaded again against ``DetectorRunner.detect``;
    ``--compile-cache DIR`` (a second process runs no ``nvcc``);
    ``doctor``. Each verb's launches are counted from 0 around that verb
    alone (and the exported program's around its call); the direct runs
    they are compared with run outside those windows. Returns the launches
    summed over the verbs."""
    from waymo_2d_tracking_tpu_torch.data import waymo
    from waymo_2d_tracking_tpu_torch.data.preprocess import letterbox_batch
    from waymo_2d_tracking_tpu_torch.data.video import iter_video_frames
    from waymo_2d_tracking_tpu_torch.io_out import submission as subm
    from waymo_2d_tracking_tpu_torch.io_out.export import load_program, OUTPUTS
    from waymo_2d_tracking_tpu_torch.io_out.postprocess import interpolate_gaps
    from waymo_2d_tracking_tpu_torch.models.detector import DetectorRunner
    from waymo_2d_tracking_tpu_torch.pipeline.online import OnlineTracker
    from waymo_2d_tracking_tpu_torch.pipeline.run import SegmentFrames, SegmentPipeline, run_segments
    from waymo_2d_tracking_tpu_torch.weights import FIXTURES_DIR, fixture_state_dict

    work = os.path.join(scratch_dir(), "cli")
    if os.path.isdir(work):
        import shutil

        shutil.rmtree(work)
    os.makedirs(work)
    t0 = time.perf_counter()
    verbs = {}

    def verb(name, argv):
        """One verb, the counts zeroed just before it and read just after."""
        zero_counts(counters)
        code, out = cli_quiet(argv)
        verbs[name] = read_counts(counters)
        if code not in (None, 0):
            raise AssertionError(f"C: {name} exited {code}")
        return out

    cfg = gated(HEADLINE)
    conf = write_config(cfg, "c_headline.yaml")
    verb("track", ["track", "--segments-dir", FIXTURES_DIR, "--out-dir", f"{work}/track",
                   "--config", conf])
    run_segments(SegmentPipeline(cfg, device="cuda", seed=0),
                 waymo.iter_segments(FIXTURES_DIR, cameras=cfg.pipeline.cameras),
                 f"{work}/direct")
    files = sorted(f for f in os.listdir(f"{work}/direct") if f.endswith(".jsonl")
                   and f != "manifest.jsonl")
    for f in files:
        if open(f"{work}/track/{f}").read() != open(f"{work}/direct/{f}").read():
            raise AssertionError(f"C: track --segments-dir {f} differs from run_segments")
    online = json.loads(verb("track --online", [
        "track", "--online", "--segments-dir", FIXTURES_DIR, "--out-dir", f"{work}/online",
        "--config", conf])[-1])
    det = json.loads(verb("detect", ["detect", "--segments-dir", FIXTURES_DIR, "--out",
                                     f"{work}/det.jsonl", "--config", conf])[-1])
    n_track = sum(len(subm.read_jsonl(f"{work}/track/{f}")) for f in files)
    if not (files and n_track and online["records"] and det["records"]):
        raise AssertionError("C: track / track --online / detect wrote no records")
    log(f"[C] track --segments-dir (the ingest TFRecord, headline_denom2): {files} equal to "
        f"run_segments byte for byte ({n_track} records); track --online {online['records']} "
        f"records, latency {latency_text(online['latency'])}; detect {det['records']} "
        f"detections ({card})")

    # draw (OpenCV) the tracks into JPEGs and a video, then track that video
    video = f"{work}/drawn.avi"
    drawn = json.loads(verb("draw", ["draw", "--tracks", f"{work}/track/{files[0]}",
                                     "--segments-dir", FIXTURES_DIR, "--out-dir",
                                     f"{work}/draw", "--video", video, "--config", conf])[-1])
    jpegs = [f for f in os.listdir(f"{work}/draw") if f.endswith(".jpg")]
    tracked = json.loads(verb("track --video", ["track", "--video", video, "--out-dir",
                                                f"{work}/video", "--config", conf])[-1])
    stem = os.path.splitext(os.path.basename(video))[0]
    sess = OnlineTracker(cfg, device="cuda", seed=0)
    sess.reset(clear_latency=True)
    sess.context_name = stem
    records, stamps, hw = [], [], None
    for ts, frame in iter_video_frames(video):
        if hw is None:
            hw = tuple(frame.shape[:2])
            sess.warmup(hw)
        records.extend(sess.step(frame, ts))
        stamps.append(ts)
    sess.close()
    subm.write_jsonl(f"{work}/video_direct.jsonl",
                     interpolate_gaps(records, stamps, cfg.pipeline.interp_max_gap))
    if not (drawn["frames"] == len(jpegs) == len(stamps) == tracked["frames"] > 0
            and open(f"{work}/video/{stem}_1.jsonl").read()
            == open(f"{work}/video_direct.jsonl").read()):
        raise AssertionError(f"C: draw wrote {drawn['frames']} frames ({len(jpegs)} JPEGs, "
                             f"{len(stamps)} in the video), track --video read "
                             f"{tracked['frames']}, or its records differ from the direct "
                             f"session on the video's frames")
    log(f"[C] draw: {drawn['frames']} frames with their tracks into JPEGs and an MJPG video "
        f"({hw[0]}x{hw[1]}); track --video on it: {tracked['frames']} frames, "
        f"{tracked['records']} records, byte-equal to a direct OnlineTracker on the frames "
        f"OpenCV reads back ({card})")

    # tune on the fixture clip's detections: card, CPU, two spawned workers
    fcfg, frames5, gt = fixture["cfg"], fixture["frames"], fixture["gt"]
    dets, _ = SegmentPipeline(fcfg, fixture_state_dict("pixels_detector"), device="cuda") \
        .run_segment(SegmentFrames("fixture", 1, list(range(frames5.shape[0])), frames5),
                     detections_only=True)
    subm.write_jsonl(f"{work}/dets.jsonl", dets)
    subm.write_jsonl(f"{work}/gt.jsonl", [
        subm.TrackRecord.from_xyxy("fixture", t, 1, f"gt{k}", 1, gt["boxes"][t, k], 1.0)
        for t in range(gt["boxes"].shape[0]) for k in np.flatnonzero(gt["present"][t])])
    fconf = write_config(fcfg, "c_fixture.yaml")
    tune = ["tune", "--from-detections", f"{work}/dets.jsonl", "--gt", f"{work}/gt.jsonl",
            "--trials", "4", "--config", fconf]
    reports = {}
    for name, extra in (("cuda", []), ("cpu", ["--device", "cpu"]), ("cuda, 2 workers",
                                                                     ["--workers", "2"])):
        t1 = time.perf_counter()
        verb(f"tune ({name})", tune + extra + ["--out", f"{work}/tune_{len(reports)}.json"])
        reports[name] = (json.load(open(f"{work}/tune_{len(reports)}.json")),
                         time.perf_counter() - t1)
    base, cpu = reports["cuda"][0], reports["cpu"][0]
    if not same_report(base, reports["cuda, 2 workers"][0]):
        raise AssertionError("C: tune reports differ between the card and 2 workers on it")
    # the card's auction is the Pallas kernel's schedule, the CPU's the JAX
    # package's while-loop (ROADMAP Queue 3): both eps-optimal, they may
    # choose differently among near-equal assignments, so a trial may differ
    # card against CPU; the trials and knobs may not
    if [(r["trial"], r["knobs"]) for r in sorted(base["results"], key=lambda r: r["trial"])] != \
            [(r["trial"], r["knobs"]) for r in sorted(cpu["results"], key=lambda r: r["trial"])]:
        raise AssertionError("C: tune's trials or knobs differ between the card and the CPU")
    counts = ("records", "mota", "idf1", "num_idsw", "num_fp", "num_fn")
    by_trial = {r["trial"]: r for r in cpu["results"]}
    same = sorted(r["trial"] for r in base["results"]
                  if all(r[k] == by_trial[r["trial"]][k] for k in counts))
    motp = max(abs(r["motp"] - by_trial[r["trial"]]["motp"]) for r in base["results"])
    differ = {r["trial"]: {k: [r[k], by_trial[r["trial"]][k]] for k in ("records", "mota")}
              for r in base["results"] if r["trial"] not in same}
    log(f"[C] tune --trials 4 on the fixture clip's {len(dets)} detections: best trial "
        f"{base['best']['trial']} mota {base['best']['mota']:.4f} ({base['best_overrides']}); "
        f"the same report with --workers 2 on the card; against --device cpu (the while-loop "
        f"auction): the same trials and knobs, best trial {cpu['best']['trial']}, records, "
        f"MOTA, IDF1, IDSW, FP and FN equal in trials {same}, differing in "
        f"{json.dumps(differ)} (card, CPU), MOTP within {motp:.2e} (seconds "
        f"{json.dumps({k: round(v, 1) for k, (_, v) in reports.items()})})")

    # export --platform cuda, loaded again
    cfg1 = _update_pipeline(cfg, decode_scale_denom=1)
    t1 = time.perf_counter()
    out = verb("export", ["export", "--out", f"{work}/det.pt2", "--platform", "cuda",
                          "--batch", "2", "--config", write_config(cfg1, "c_export.yaml")])
    export_s = time.perf_counter() - t1
    program = load_program(f"{work}/det.pt2")
    raw = torch.from_numpy(np.ascontiguousarray(frames[:2])).to("cuda")
    images, _ = letterbox_batch(raw, tuple(frames.shape[1:3]), cfg1.detector.image_size)
    zero_counts(counters)
    got = program(images)
    torch.cuda.synchronize()
    verbs["export: the program's call"] = read_counts(counters)
    nms_runs = verbs["export: the program's call"]["nms_mask"]
    want = DetectorRunner(cfg1.detector, device="cuda", seed=0).detect(images)
    diff = {k: (float((got[k].float() - getattr(want, k).float()).abs().max())
                if got[k].numel() else 0.0) for k in OUTPUTS}
    if nms_runs != 1 or any(diff.values()) or not bool(want.valid.any()):
        raise AssertionError(f"C: the exported program differs from DetectorRunner.detect "
                             f"({diff}) or ran the NMS kernel {nms_runs} times")
    log(f"[C] export --platform cuda ({json.loads(out[-1])['input']}) in {export_s:.1f} s, "
        f"loaded again: equal to DetectorRunner.detect on the card in every field, the NMS "
        f"kernel launched {nms_runs} time by the program")

    # --compile-cache: the second process finds the kernel and runs no nvcc
    cache = os.path.join(work, "kernels")
    probe = ("import json, sys; from waymo_2d_tracking_tpu_torch import cli; "
             "from waymo_2d_tracking_tpu_torch.ops import _cuda; cli.main(sys.argv[1:]); "
             "print(json.dumps({'nvcc_builds': sorted(_cuda.BUILD_LOG)}))")
    builds, outs = [], []
    here = os.path.dirname(os.path.abspath(__file__))
    for i in range(2):
        proc = subprocess.run(
            [sys.executable, "-c", probe, "track", "--from-detections", f"{work}/dets.jsonl",
             "--out", f"{work}/cc_{i}.jsonl", "--config", fconf, "--compile-cache", cache],
            capture_output=True, text=True, timeout=300, cwd=here,
            env={**os.environ, "PYTHONPATH": os.pathsep.join(
                p for p in (here, os.environ.get("PYTHONPATH")) if p)})
        if proc.returncode != 0:
            raise AssertionError(f"C: --compile-cache process {i} failed:\n{proc.stderr[-2000:]}")
        builds.append(json.loads(proc.stdout.strip().splitlines()[-1])["nvcc_builds"])
        outs.append(open(f"{work}/cc_{i}.jsonl").read())
    if builds[0] != ["auction"] or builds[1] != [] or outs[0] != outs[1]:
        raise AssertionError(f"C: --compile-cache builds {builds}; outputs equal {outs[0] == outs[1]}")
    log(f"[C] --compile-cache {os.path.relpath(cache, here)}: the first process built "
        f"{builds[0]} with nvcc, the second loaded it and ran no nvcc; equal outputs; "
        f"the cache holds {sorted(os.listdir(cache))}")

    report = json.loads("\n".join(verb("doctor", ["doctor"])))
    if report["status"] != "ok":
        raise AssertionError(f"C: doctor reports {report}")
    log(f"[C] doctor exits 0: {json.dumps(report, separators=(',', ':'))}")
    total = {k: sum(v[k] for v in verbs.values()) for k in counters}
    log(f"[C] the command-line phase in {time.perf_counter() - t0:.1f} s; launches of each "
        f"verb, counted from 0 around it alone (tune's 2 workers and the --compile-cache "
        f"processes launch in processes of their own, not counted here): "
        f"{json.dumps(verbs)}; their sum {json.dumps(total)}")
    # the verbs that detect launch NMS, those that track the auction
    need = {"nms_mask": ("track", "track --online", "detect", "track --video",
                         "export: the program's call"),
            "auction": ("track", "track --online", "track --video", "tune (cuda)")}
    missing = [(k, v) for k, names in need.items() for v in names if verbs[v][k] == 0]
    if missing:
        raise AssertionError(f"C: no launch of the kernel in these verbs: {missing}")
    return total


def _update_pipeline(cfg, **kw):
    from waymo_2d_tracking_tpu_torch.config import _update

    return _update(cfg, {"pipeline": kw})


# ----------------------------------------------------------------- phase T

# tests/test_torch_train.py's tiny parity config, and
# tests/integration/test_train_to_detect.py's learning-proof detector
TRAIN_TINY = dict(backbone="resnet18slim", image_size=(64, 96), fpn_channels=32,
                  fpn_levels=(3, 4, 5), head_depth=1, pre_nms_topk=64, max_detections=16,
                  embed_dim=16, dtype="float32", score_threshold=0.3)
TRAIN_PROOF_DET = {**TRAIN_TINY, "embed_dim": 0}
# the committed fixture's metrics on the two pixel clips (phase 2 measures
# them again in the same run): tests/golden/test_pixels_to_mota.py
FIXTURE_GOLDEN = {"seed5": {"mota": 0.7971, "idf1": 0.8853, "num_idsw": 5, "mostly_tracked": 8},
                  "dense": {"mota": 0.4352, "idf1": 0.677, "num_idsw": 5}}
# T1 tolerances, card against CPU (the reasons are tests/test_torch_train.py's:
# a ReLU input within the rounding difference of zero flips and carries its
# whole gradient, and Adam's first update is about lr * sign(g))
# (each a relative L2 difference per tensor, the largest over the tensors;
# "param": the parameters after the step, "update": their change; a
# zero-initialised bias after one step is all update, Adam's sign flips
# included, hence "param" well above the gradients' agreement)
T1_TOL = {"loss": 1e-4, "grad": 0.1, "param": 0.05, "update": 0.5, "stats": 1e-4}


def _noise_grad(name: str) -> bool:
    """A conv bias right before a GroupNorm of one channel per group: its
    gradient is zero analytically, rounding noise on any device."""
    return name.endswith(".bias") and ("tower.conv" in name or name == "reid.conv0.bias")


def _rel_l2(torch, got, want) -> float:
    den = float(torch.linalg.vector_norm(want))
    return float(torch.linalg.vector_norm(got - want)) / (den if den > 0 else 1.0)


def tiny_batch(np, n=4, seed=0):
    from waymo_2d_tracking_tpu_torch.data.synthetic import render_detection_batch

    b = render_detection_batch(np.random.default_rng(seed), n, TRAIN_TINY["image_size"], max_gt=6)
    b["gt_track_ids"] = np.where(b["gt_valid"], np.arange(6)[None, :] % 4, -1).astype(np.int32)
    return b


def sync(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def phase_train_parity(np, torch, card, devices=("cpu", "cuda")):
    """T1: one ``train_step`` at the tiny parity config (float32, TF32 off)
    on the card and on the CPU from the same weights and batch, for AdamW
    and SGD with accumulation 2, EMA and remat on."""
    from waymo_2d_tracking_tpu_torch.config import Config, DetectorConfig, TrainConfig
    from waymo_2d_tracking_tpu_torch.train.train import DetectorTrainer, _as_batch

    batch = tiny_batch(np)
    for optimizer in ("adamw", "sgd"):
        cfg = Config(detector=DetectorConfig(**TRAIN_TINY), train=TrainConfig(
            batch_size=4, learning_rate=3e-3, warmup_steps=0, total_steps=10,
            weight_decay=1e-4, ema_decay=0.9, reid_loss_weight=0.5, optimizer=optimizer,
            grad_accum_steps=2, remat=True))
        out = {}
        for dev in devices:
            tr = DetectorTrainer(cfg, device=dev)
            st_g = tr.create_state(torch.Generator().manual_seed(0))
            grads, _, m = tr._grads_and_stats(st_g, _as_batch(batch, tr.device))
            st = tr.create_state(torch.Generator().manual_seed(0))
            start = {k: v.detach().cpu().clone() for k, v in st.params.items()}
            st, m = tr.train_step(st, batch)
            cpu = lambda d: {k: v.detach().float().cpu() for k, v in d.items()}  # noqa: E731
            out[dev] = dict(loss=float(m["loss"]), grads=cpu(grads), params=cpu(st.params),
                            stats=cpu(st.batch_stats), ema=cpu(st.ema_params), start=start)
        a, b = out[devices[1]], out[devices[0]]
        lr = DetectorTrainer(cfg, device="cpu").tx.schedule(0)
        loss_d = abs(a["loss"] - b["loss"]) / abs(b["loss"])
        grad_d = max(_rel_l2(torch, a["grads"][k], b["grads"][k])
                     for k in b["grads"] if not _noise_grad(k))
        upd_d = ema_d = noise = 0.0
        par_d = max(_rel_l2(torch, a["params"][k], b["params"][k]) for k in b["params"]
                    if not _noise_grad(k))
        for k in b["params"]:
            da, db = a["params"][k] - b["start"][k], b["params"][k] - b["start"][k]
            ea, eb = a["ema"][k] - b["start"][k], b["ema"][k] - b["start"][k]
            if _noise_grad(k):
                noise = max(noise, float(da.abs().max()), float(db.abs().max()))
                continue
            upd_d = max(upd_d, _rel_l2(torch, da, db))
            ema_d = max(ema_d, _rel_l2(torch, ea, eb))
        stats_d = max(_rel_l2(torch, a["stats"][k], b["stats"][k]) for k in b["stats"])
        log(f"[T1] {optimizer}, accum 2, EMA 0.9, remat, tiny f32 config, card against CPU "
            f"({card}): loss {a['loss']:.7f} vs {b['loss']:.7f} (rel {loss_d:.2e}); largest "
            f"relative L2 difference of a gradient {grad_d:.2e}, of an updated parameter "
            f"{par_d:.2e}, of a parameter's update {upd_d:.2e}, of an EMA change {ema_d:.2e}, "
            f"of a BatchNorm buffer {stats_d:.2e}; noise-gradient biases moved at most {noise:.2e} "
            f"(lr {lr:.1e}); tolerances {json.dumps(T1_TOL)}")
        if not (loss_d <= T1_TOL["loss"] and grad_d <= T1_TOL["grad"] and par_d <= T1_TOL["param"]
                and upd_d <= T1_TOL["update"] and ema_d <= T1_TOL["update"]
                and stats_d <= T1_TOL["stats"] and noise <= lr * (1 + 1e-4)):
            raise AssertionError(f"T1 {optimizer}: a train step on the card differs from the CPU")


def phase_train_proof(np, torch, card, nms, device="cuda", steps=300):
    """T2: the learning proof (slim 64x96, batch 8, 300 steps on one
    rendered batch) through ``train_loop`` with validation, recall through
    ``DetectorRunner.detect`` before and after, and a checkpoint resume bit
    for bit."""
    import itertools
    import re

    from waymo_2d_tracking_tpu_torch.config import Config, DetectorConfig, TrainConfig
    from waymo_2d_tracking_tpu_torch.data.synthetic import render_detection_batch
    from waymo_2d_tracking_tpu_torch.models.detector import DetectorRunner
    from waymo_2d_tracking_tpu_torch.train.train import DetectorTrainer, train_loop

    ckpt = os.path.join(scratch_dir(), "train_ckpt")
    cfg = Config(detector=DetectorConfig(**TRAIN_PROOF_DET), train=TrainConfig(
        batch_size=8, learning_rate=3e-3, warmup_steps=20, total_steps=steps, weight_decay=1e-5,
        checkpoint_dir=ckpt))
    batch = render_detection_batch(np.random.default_rng(0), 8, TRAIN_PROOF_DET["image_size"])
    images = torch.from_numpy(batch["images"]).to(device)
    tr = DetectorTrainer(cfg, device=device)
    st = tr.create_state(torch.Generator().manual_seed(0))
    nms.nms_mask_cuda.launches = 0
    runner = DetectorRunner(cfg.detector, tr.eval_variables(st), device=device)
    recall_at_iou = _load_tool().recall_at_iou
    r0 = recall_at_iou(runner.detect(images).to_numpy(), batch)
    st, m = tr.train_step(st, batch)
    first = float(m["loss"])
    lines = []
    sync(torch, device)
    t0 = time.perf_counter()
    st = train_loop(tr, itertools.repeat(batch), steps - 1, st, log_every=100,
                    log_fn=lines.append, val_batches=[batch], val_every=steps // 2)
    sync(torch, device)
    secs = time.perf_counter() - t0
    last = float(re.search(rf"step {steps}: loss=([0-9.]+)", "\n".join(lines)).group(1))
    runner.module.load_state_dict(tr.eval_variables(st))
    r1 = recall_at_iou(runner.detect(images).to_numpy(), batch)
    launches = nms.nms_mask_cuda.launches
    vals = [ln for ln in lines if " val " in ln]
    log(f"[T2] learning proof ({card}): loss {first:.4f} -> {last:.4f} in {steps} steps, "
        f"{(steps - 1) / secs:.1f} steps/s through train_loop (validation at {steps // 2} and "
        f"{steps} included); "
        f"recall@0.5 untrained {r0:.3f}, trained {r1:.3f}; NMS launches {launches}; "
        f"best checkpoint {os.path.exists(os.path.join(ckpt, 'best'))}; {vals[-1][:160]}")
    if not (last < 0.5 * first and r0 <= 0.2 and r1 >= 0.6 and len(vals) == 2
            and (launches > 0 or device == "cpu")):
        raise AssertionError("T2: the learning proof failed")

    # checkpoint round trip: 5 more steps from the restored state equal 5
    # steps without it, bit for bit (deterministic kernels for the 10 steps)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        path = tr.save_checkpoint(st)
        restored = tr.restore_checkpoint(path, st)
        for _ in range(5):
            st, _ = tr.train_step(st, batch)
        for _ in range(5):
            restored, _ = tr.train_step(restored, batch)
        a, b = st.to_tree(), restored.to_tree()
    finally:
        torch.use_deterministic_algorithms(False)
    same = a["step"] == b["step"] and all(
        torch.equal(a[part][k], b[part][k]) for part in ("params", "batch_stats")
        for k in a[part]) and all(torch.equal(a["opt_state"][s][k], b["opt_state"][s][k])
                                  for s in ("mu", "nu") for k in a["opt_state"][s])
    log(f"[T2] checkpoint at step {a['step'] - 5} saved, restored and stepped 5 times: "
        f"{'bit-equal' if same else 'DIFFERENT'} to 5 steps without the round trip")
    if not same:
        raise AssertionError("T2: the resumed state differs from the uninterrupted one")

    # COCO input: the ingest fixture's segment converted, batches decoded and
    # resized in a worker thread and copied to the device through the
    # prefetcher's pinned buffers, two steps on them
    from waymo_2d_tracking_tpu_torch.data.coco import coco_batch_iterator, convert_segments_to_coco
    from waymo_2d_tracking_tpu_torch.weights import FIXTURES_DIR

    coco = os.path.join(scratch_dir(), "coco")
    n_images = convert_segments_to_coco(FIXTURES_DIR, coco)
    it = coco_batch_iterator(coco, 2, TRAIN_PROOF_DET["image_size"], num_workers=1,
                             prefetch_depth=2, scale_range=(0.8, 1.2), color_jitter=0.2,
                             device=device)
    try:
        got = []
        for coco_batch in itertools.islice(it, 2):
            got.append(coco_batch["images"].device.type)
            st, m = tr.train_step(st, coco_batch)
    finally:
        it.close()
    log(f"[T2] COCO input: {n_images} images converted from the ingest fixture, 2 batches of 2 "
        f"through coco_batch_iterator (1 worker, prefetch 2) on {got}, 2 steps, loss "
        f"{float(m['loss']):.4f}")
    if got != [torch.device(device).type] * 2 or not math.isfinite(float(m["loss"])):
        raise AssertionError("T2: the COCO batches did not train on the device")


def _load_tool():
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "waymo_2d_tracking_tpu_torch",
                        "tools", "train_pixels_fixture.py")
    spec = importlib.util.spec_from_file_location("train_pixels_fixture", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_train_fixture(np, torch, card, committed, device="cuda", steps=800):
    """T3: the fixture recipe on the card (800 steps, batch 16, 256x384, and
    the ReID variant) with the tool's gates, then the pixel-golden clips and
    the ReID recovery clip through the port on the port-trained weights,
    beside the committed fixture's metrics (reported, not gated: another
    random stream trains other weights)."""
    from waymo_2d_tracking_tpu_torch.config import (
        Config, DetectorConfig, PipelineConfig, TrackerConfig,
    )
    from waymo_2d_tracking_tpu_torch.data.synthetic import SyntheticClipConfig, render_video_clip
    from waymo_2d_tracking_tpu_torch.eval.mot import evaluate_mot, gt_to_frames
    from waymo_2d_tracking_tpu_torch.pipeline.run import SegmentFrames, SegmentPipeline

    tool = _load_tool()
    out = os.path.join(scratch_dir(), "trained_fixtures")

    def run(det_kw, clip, sd, **trk_kw):
        frames, gt = render_video_clip(clip)
        cfg = Config(detector=DetectorConfig(**det_kw),
                     tracker=TrackerConfig(**{**PIXELS_TRK, **trk_kw}),
                     pipeline=PipelineConfig(chunk_frames=16, interp_max_gap=0))
        records, _ = SegmentPipeline(cfg, sd, device=device).run_segment(
            SegmentFrames("fixture", 1, list(range(clip.num_frames)), frames))
        return evaluate_mot(gt_to_frames(gt), records_to_frames(np, records, clip.num_frames))

    for reid in (False, True):
        t0 = time.perf_counter()
        meta = tool.main(out, steps=steps, batch_size=16, seed=0, reid=reid, device=device,
                         log=lambda s: log(f"[T3] {'reid ' if reid else ''}{s}"))
        log(f"[T3] {'ReID ' if reid else ''}fixture recipe trained and checked in "
            f"{time.perf_counter() - t0:.1f} s ({card}): held-out recall@0.5 "
            f"{meta['held_out_recall_at_0.5']}" + (f", separation {json.dumps(meta['reid_separation'])}"
                                                   if reid else ""))
        sd = {k: v.detach().cpu() for k, v in meta["state_dict"].items()}
        if not reid:
            seed5 = SyntheticClipConfig(num_frames=80, num_objects=8, image_size=(1024, 1536),
                                        seed=5)
            dense = SyntheticClipConfig(num_frames=80, num_objects=14, image_size=(1024, 1536),
                                        seed=11)
            keys = ("mota", "idf1", "num_idsw", "mostly_tracked")
            for name, clip in (("seed5", seed5), ("dense", dense)):
                got = run(PIXELS_DET, clip, sd, birth_iou_threshold=0.3).as_dict()
                log(f"[T3] {name} clip on the port-trained weights: "
                    f"{json.dumps({k: got[k] for k in keys})}; committed fixture in this run "
                    f"{json.dumps({k: committed[name][k] for k in keys})}, its golden "
                    f"{json.dumps(FIXTURE_GOLDEN[name])}")
        else:
            clip = SyntheticClipConfig(num_frames=100, num_objects=6, image_size=(1024, 1536),
                                       seed=29, occlusion_gap=(30, 52), texture_amp=0.25)
            det = {**PIXELS_DET, "embed_dim": 32}
            base = dict(embed_dim=32, max_lost_age=30, birth_iou_threshold=0.3)
            off = run(det, clip, sd, **base)
            on = run(det, clip, sd, **base, reid_recovery=True, appearance_gate=0.3,
                     gallery_size=4)
            log(f"[T3] ReID recovery clip on the port-trained ReID weights: off idf1 "
                f"{off.idf1:.4f} idsw {off.num_idsw}; on idf1 {on.idf1:.4f} idsw {on.num_idsw}")


def profile_step(torch, step):
    """Device busy share of one traced call of ``step`` and its top device
    kernels: the union of device intervals over the span from the first
    device event to the last."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    spans = sorted((e.time_range.start, e.time_range.end) for e in device)
    if not spans:
        return None, []
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s0, e0 in spans[1:]:
        if s0 > cur_e:
            busy += cur_e - cur_s
            cur_s = s0
        cur_e = max(cur_e, e0)
    busy += cur_e - cur_s
    span = max(e0 for _, e0 in spans) - spans[0][0]
    by_name = {}
    for e in device:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return busy / span, [[k[:60], round(v, 3)] for k, v in top]


T4_RUNS = [("headline", HEADLINE["detector"], 16, {"reid_loss_weight": 0.5}, True),
           ("config4", CONFIG4["detector"], 8, {"remat": False}, False),
           ("config4 remat", CONFIG4["detector"], 8, {"remat": True}, False),
           ("config4 accum 2", CONFIG4["detector"], 8, {"grad_accum_steps": 2}, False)]


def phase_train_full_width(np, torch, card, device="cuda", runs=T4_RUNS):
    """T4: a few timed train steps at full width after a warm-up: the
    headline (ResNet-18 s2d, FPN 128 P3-P6, FCOS 128x2, ReID 128, 448x672,
    bf16) at batch 16 with the ReID loss at 0.5 on rendered identity
    batches; config 4 (ResNet-50, FPN 256 P3-P7, FCOS 4x256, 640x960) at
    batch 8 with remat off and on and with 2 accumulation steps. A fixed
    batch each, warm-up 2 steps of the schedule so the loss moves."""
    from waymo_2d_tracking_tpu_torch.config import Config, _update
    from waymo_2d_tracking_tpu_torch.data.synthetic import (
        random_rect_batch,
        random_rect_batch_reid,
    )
    from waymo_2d_tracking_tpu_torch.train.train import DetectorTrainer, _as_batch

    cuda = torch.device(device).type == "cuda"
    for name, det, bs, train_kw, reid in runs:
        cfg = _update(Config(), {"detector": det, "train": {
            "batch_size": bs, "learning_rate": 1e-3, "warmup_steps": 2, "total_steps": 1000,
            **train_kw}})
        hw = tuple(cfg.detector.image_size)
        rng = np.random.default_rng(0)
        host = (random_rect_batch_reid(rng, bs, image_hw=hw) if reid
                else random_rect_batch(rng, bs, image_hw=hw))
        tr = DetectorTrainer(cfg, device=device)
        st = tr.create_state(torch.Generator().manual_seed(0))
        batch = _as_batch(host, tr.device)
        losses = []
        for _ in range(2):
            st, m = tr.train_step(st, batch)
            losses.append(m["loss"])
        sync(torch, device)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        steps = 5
        t0 = time.perf_counter()
        for _ in range(steps):
            st, m = tr.train_step(st, batch)
            losses.append(m["loss"])
        sync(torch, device)
        secs = (time.perf_counter() - t0) / steps
        peak = torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else float("nan")
        losses = [float(v) for v in losses]
        split = None
        if cfg.train.grad_accum_steps == 1 and cuda:
            split = train_step_split(torch, tr, st, batch)
        busy, top = (profile_step(torch, lambda: tr.train_step(st, batch)) if cuda
                     else (None, []))
        log(f"[T4] {name} train step, batch {bs} at {hw[0]}x{hw[1]} {cfg.detector.dtype} "
            f"({card}): {1 / secs:.2f} steps/s, {bs / secs:.1f} images/s ({secs * 1e3:.1f} ms a "
            f"step, host clock over {steps} steps); peak device memory {peak:.2f} GiB; loss "
            f"{losses[0]:.4f} -> {losses[-1]:.4f} over {len(losses)} steps on a fixed batch; "
            + (f"split (CUDA events, median of 3) forward {split[0]:.2f} / loss {split[1]:.2f} / "
               f"backward {split[2]:.2f} / optimizer {split[3]:.2f} ms; " if split else "")
            + ("device busy share of one traced step "
               + ("not measured" if busy is None else f"{busy:.4f}")
               + f", most device time (ms) {json.dumps(top)}"))
        if not (all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]):
            raise AssertionError(f"T4 {name}: the loss is not finite and falling")
        del tr, st, batch
        if cuda:
            torch.cuda.empty_cache()


def train_step_split(torch, tr, st, batch):
    """Median over 3 steps of (forward, loss, backward, optimizer) ms by CUDA
    events around the trainer's own pieces of a step."""
    from waymo_2d_tracking_tpu_torch.models.detector import _no_tf32

    reid_on = tr.reid_on(batch)
    tr._bind(st)
    leaves = list(st.params.values())
    splits = []
    for _ in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        with _no_tf32():
            ev[0].record()
            head_out, embeds = tr._forward(batch, reid_on)
            ev[1].record()
            loss, _ = tr._objective(head_out, embeds, batch, reid_on)
            ev[2].record()
            grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
            ev[3].record()
            tr.tx.update(st.params, dict(zip(st.params, grads)), st.opt_state)
            ev[4].record()
        ev[4].synchronize()
        splits.append([ev[i].elapsed_time(ev[i + 1]) for i in range(4)])
    return [statistics.median(s[i] for s in splits) for i in range(4)]


def phase_train(np, torch, counters, card, nms, committed):
    """The training slice: T1 parity, T2 learning proof, T3 fixture recipe,
    T4 full width. Returns the kernel launches of T2 and T3 (validation
    detects and the tracker runs on the trained weights)."""
    t0 = time.perf_counter()
    phase_train_parity(np, torch, card)
    log(f"[T1] done in {time.perf_counter() - t0:.1f} s")
    zero_counts(counters)
    t0 = time.perf_counter()
    phase_train_proof(np, torch, card, nms)
    log(f"[T2] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_train_fixture(np, torch, card, committed)
    log(f"[T3] done in {time.perf_counter() - t0:.1f} s")
    counts = read_counts(counters)
    log(f"[T] kernel launches in T2 and T3: {json.dumps(counts)}")
    if counts["nms_mask"] == 0 or counts["auction"] == 0:
        raise AssertionError("the NMS or the auction kernel did not run in the training phases")
    t0 = time.perf_counter()
    phase_train_full_width(np, torch, card)
    log(f"[T4] done in {time.perf_counter() - t0:.1f} s")
    return counts

# ----------------------------------------------------------------------------
# D: the distributed slice. Ranks are spawned processes on cuda:0 (one card),
# two of them over gloo (NCCL takes one rank a card), one over NCCL; each
# rank maps its frames from .npy files and counts its own kernel launches.

D1_LENGTHS = (150, 60, 90)      # the 150-frame segment spans two 128-frame chunks
D2_FRAMES = 16
D_WORLD = 2


def dist_dir(*parts) -> str:
    """D's working directory: inside the checkout (gitignored) but outside
    ``scratch_dir()``, whose files are kept, since D's frames and outputs
    run to gigabytes."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".scratch", "chip_smoke_dist",
                        *parts)
    os.makedirs(path, exist_ok=True)
    return path


def save_d1_frames(np, frames):
    """D1's three segments of unequal length, cut from the headline's
    640x960 render and saved for the ranks to map. Returns their plan."""
    plan, lo = [], 0
    for i, t in enumerate(D1_LENGTHS):
        path = os.path.join(dist_dir("frames"), f"d1_seg{i}.npy")
        np.save(path, frames[lo:lo + t])
        plan.append({"context": f"d1seg{i}", "camera": 1, "path": path,
                     "timestamps": [100_000 * k for k in range(t)]})
        lo += t
    return plan


def save_d2_frames(np, frames):
    """D2's two contexts of 5 cameras at 1280x1920, 16 frames each, cut from
    config 4's render (frames (T >= 32, 5, H, W, 3)). Returns their plan."""
    plan = []
    for i in range(2):
        for cam in range(frames.shape[1]):
            path = os.path.join(dist_dir("frames"), f"d2_ctx{i}_{cam + 1}.npy")
            np.save(path, frames[i * D2_FRAMES:(i + 1) * D2_FRAMES, cam])
            plan.append({"context": f"d2ctx{i}", "camera": cam + 1, "path": path,
                         "timestamps": [100_000 * k for k in range(D2_FRAMES)]})
    return plan


def d_configs():
    """D1's headline at decode_scale_denom 1 on 640x960 frames, D2's config 4,
    both with the tracker gates lowered for random weights; D3's headline
    training cases at batch 16 with ReID (plain, accumulation 2, remat; in
    float32 with TF32 off and in bf16) and its steps config (bf16)."""
    from waymo_2d_tracking_tpu_torch.config import Config, _update

    d1 = gated({**HEADLINE, "pipeline": {**HEADLINE["pipeline"], "decode_scale_denom": 1}})
    d2 = _update(Config(), {**CONFIG4, "tracker": {**CONFIG4["tracker"],
                                                    **CONFIG4_RANDOM_WEIGHT_GATES}})
    train = {"batch_size": 16, "learning_rate": 1e-3, "warmup_steps": 2, "total_steps": 1000,
             "reid_loss_weight": 0.5}
    mk = lambda dtype, **kw: _update(Config(), {  # noqa: E731
        "detector": {**HEADLINE["detector"], "dtype": dtype}, "train": {**train, **kw}})
    d3 = {f"{name} {dtype}": mk(dtype, **kw) for dtype in ("float32", "bfloat16")
          for name, kw in (("reid", {}), ("reid accum 2", {"grad_accum_steps": 2}),
                           ("reid remat", {"remat": True}))}
    return d1, d2, d3, mk("bfloat16", ema_decay=0.999)


# D3's bounds, data parallel against the single-device step on the card. The
# ranks' convolutions see 8 images where the single device sees 16, and
# cuDNN picks its algorithms by shape, so the forward differs by rounding
# (BatchNorm statistics within 6.7e-7 to 2.5e-6 in float32 with TF32 off,
# 3.7e-4 to 4.7e-4 in bf16), and a ReLU input near zero changes side and
# carries its whole gradient: the whole gradient differs by 2.1e-3 to
# 2.3e-3 in float32 and 0.088 to 0.138 in bf16, the size of the
# single-device step's own difference when its batch's images are reordered
# (1.7e-3 to 1.9e-3 and 0.095 to 0.110), which each run prints beside; the
# loss by 0 and at most 2.4e-4 (H100 80GB HBM3, 700 W).
D3_TOL = {"float32": {"loss": 1e-5, "whole": 1e-2, "stats": 1e-5},
          "bfloat16": {"loss": 1e-3, "whole": 0.3, "stats": 1e-3}}


def same_outputs(np, got_dir, want_dir, names, what):
    """Track or detection JSONL byte-equal; the gallery sidecars' arrays
    bit-equal where the reference has them."""
    for name in names:
        with open(os.path.join(got_dir, name), "rb") as g, \
                open(os.path.join(want_dir, name), "rb") as w:
            if g.read() != w.read():
                raise AssertionError(f"{what}: {name} differs from the unsharded driver's")
        gal = name[: -len(".jsonl")] + ".gallery.npz"
        if os.path.exists(os.path.join(want_dir, gal)):
            zg, zw = np.load(os.path.join(got_dir, gal)), np.load(os.path.join(want_dir, gal))
            for k in zw.files:
                if zg[k].dtype != zw[k].dtype or not np.array_equal(zg[k], zw[k]):
                    raise AssertionError(f"{what}: {gal}:{k} differs from the unsharded driver's")


def ring_model(np, q, g, v, n):
    """JAX's ring on n shards, written out: block o visits shards o, o+1, ...;
    a strictly larger score takes over; -2 scores invalid entries, -1 when
    nothing valid was seen."""
    s = (q @ g.T).astype(np.float32)
    s[:, ~v] = -2.0
    qs, gs = q.shape[0] // n, g.shape[0] // n
    best = np.full(q.shape[0], -2.0, np.float32)
    idx = np.full(q.shape[0], -1, np.int64)
    for o in range(n):
        rows = slice(o * qs, (o + 1) * qs)
        for k in range(n):
            sh = (o + k) % n
            blk = s[rows, sh * gs:(sh + 1) * gs]
            lb, la = blk.max(axis=1), blk.argmax(axis=1) + sh * gs
            take = lb > best[rows]
            best[rows] = np.where(take, lb, best[rows])
            idx[rows] = np.where(take, la, idx[rows])
    return best, np.where(best <= -2.0, -1, idx)


def d4_cases(np):
    """The headline's gallery shape (1024 entries of 128, 20 % invalid, 64
    queries) and exact ties (basis vectors: equal rows in every shard)."""
    rng = np.random.default_rng(4)
    norm = lambda x: (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)  # noqa: E731
    eye = np.eye(8, dtype=np.float32)
    return [(norm(rng.normal(size=(64, 128))), norm(rng.normal(size=(1024, 128))),
             rng.uniform(size=1024) > 0.2),
            (eye[np.arange(8) % 3], eye[np.arange(16) % 3], np.ones(16, bool))]


def sum_launches(results):
    """The kernel launches of the ranks' bodies, summed."""
    return {k: sum(r["launches"][k] for r in results) for k in results[0]["launches"]}


def write_dir_segment(np, root, ctx, frames, cameras):
    """A directory segment (``data/waymo.py``'s format: JPEG frames and a
    meta.json), one camera for each entry of ``cameras`` (a name and a
    (T, H, W, 3) uint8 array), written with Pillow."""
    from PIL import Image

    seg = os.path.join(root, ctx)
    os.makedirs(os.path.join(seg, "frames"), exist_ok=True)
    from waymo_2d_tracking_tpu_torch.data.waymo import CAMERA_NAMES

    for name, arr in cameras:
        for t in range(arr.shape[0]):
            Image.fromarray(arr[t]).save(os.path.join(seg, "frames", f"{t}_{CAMERA_NAMES[name]}.jpg"),
                                         quality=90)
    with open(os.path.join(seg, "meta.json"), "w") as f:
        json.dump({"context_name": ctx, "timestamps": [100_000 * t for t in range(frames)],
                   "cameras": {name: CAMERA_NAMES[name] for name, _ in cameras}}, f)


def phase_distributed(np, torch, card, d1_plan, d2_plan):
    """D1-D4 in one spawn of two ranks on cuda:0 over gloo, their world-1
    counterparts in one spawn over NCCL, NCCL refused for two ranks on one
    card, then D5. Returns the launches of each new path, summed over the
    ranks (each rank's counts set to 0 just before each body)."""
    from waymo_2d_tracking_tpu_torch.parallel.launch import run_ranks
    from waymo_2d_tracking_tpu_torch.tools import rank_cases

    cfg1, cfg2, d3, steps_cfg = d_configs()
    cases4 = d4_cases(np)
    out = {k: dist_dir(k) for k in ("d1", "d2", "d3", "d1_nccl", "d3_nccl")}
    links = [(os.path.join(out["d1"], "tracks"), os.path.join(out["d1"], "linked_ring"), 0.6),
             (os.path.join(out["d2"], "contexts"), os.path.join(out["d2"], "linked_ring"), 0.6)]
    calls = [("fanout_case", ("cuda", cfg1, out["d1"], d1_plan)),
             ("fanout_case", ("cuda", cfg1, out["d2"], (), (), cfg2, d2_plan)),
             ("train_case", ("cuda", d3, 16, os.path.join(out["d3"], "ckpt"), steps_cfg, 3, 5, 3,
                             True)),
             ("ring_case", ("cuda", cases4, (), links))]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = run_ranks(rank_cases.run_all, D_WORLD, calls, device="cuda", backend="gloo",
                      timeout=700, workdir=dist_dir("w2"))
    wall2 = time.perf_counter() - t0
    calls1 = [("fanout_case", ("cuda", cfg1, out["d1_nccl"], d1_plan[1:2])),
              ("train_case", ("cuda", {k: d3[k] for k in ("reid float32", "reid bfloat16")}, 16,
                              os.path.join(out["d3_nccl"], "c"))),
              ("ring_case", ("cuda", cases4))]
    t0 = time.perf_counter()
    (one,) = run_ranks(rank_cases.run_all, 1, calls1, device="cuda", backend="nccl", timeout=400,
                       workdir=dist_dir("w1"))
    wall1 = time.perf_counter() - t0
    secs = [[round(x, 2) for x in r["seconds"]] for r in ranks]
    log(f"[D] {D_WORLD} ranks on cuda:0 over gloo ran D1-D4 in {wall2:.1f} s of wall time, each "
        f"rank's bodies (D1, D2, D3, D4) {json.dumps(secs)} s; one rank over NCCL ran D1, D3 and "
        f"D4's world-1 cases in {wall1:.1f} s, bodies {json.dumps([round(x, 2) for x in one['seconds']])} s "
        f"({card})")
    t0 = time.perf_counter()
    try:
        run_ranks(rank_cases.run_all, 2, [], device="cuda", backend="nccl", timeout=120,
                  workdir=dist_dir("refused"))
        raise AssertionError("NCCL with two ranks on one card was not refused")
    except torch.multiprocessing.ProcessRaisedException as e:
        if "NCCL takes one rank a device" not in str(e):
            raise
    log(f"[D] NCCL with two ranks on cuda:0 refused by both ranks before any communicator "
        f"({time.perf_counter() - t0:.1f} s)")
    res = lambda i: [r["results"][i] for r in ranks]   # noqa: E731
    paths = {"sharded_track": phase_d1(np, torch, card, cfg1, d1_plan, out, res(0),
                                       one["results"][0]),
             "sharded_multicam": phase_d2(np, torch, card, cfg2, d2_plan, out, res(1)),
             "train_dp": phase_d3(np, torch, card, d3, res(2), one["results"][1])}
    phase_d4(np, torch, card, cases4, res(3), one["results"][2], links)
    paths["cli_sharded"] = phase_d5(np, torch, card, cfg1, d1_plan)
    return paths


def phase_d1(np, torch, card, cfg, plan, out, ranks, one):
    """D1: the headline's segments through ``run_segments_sharded`` against
    ``run_segments`` and ``run_segment(detections_only=True)`` on the card."""
    from waymo_2d_tracking_tpu_torch.io_out import submission as subm
    from waymo_2d_tracking_tpu_torch.pipeline.run import SegmentFrames, SegmentPipeline, run_segments

    segs = [SegmentFrames(p["context"], 1, p["timestamps"], frames=np.load(p["path"], mmap_mode="r"))
            for p in plan]
    pipe = SegmentPipeline(cfg, device="cuda", seed=0)
    ref = dist_dir("d1_ref")
    t0 = time.perf_counter()
    want = run_segments(pipe, segs, ref)
    t_ref = time.perf_counter() - t0
    names = [f"{p['context']}_1.jsonl" for p in plan]
    same_outputs(np, os.path.join(out["d1"], "tracks"), ref, names, "D1 tracks")
    for seg, name in zip(segs, names):
        records, _ = pipe.run_segment(seg, detections_only=True)
        subm.write_jsonl(os.path.join(ref, "det_" + name), records)
        with open(os.path.join(out["d1"], "detect", name), "rb") as g, \
                open(os.path.join(ref, "det_" + name), "rb") as w:
            if g.read() != w.read():
                raise AssertionError(f"D1 detections_only: {name} differs from run_segment's")
    same_outputs(np, os.path.join(out["d1_nccl"], "tracks"), ref, names[1:2], "D1 world 1 NCCL")
    keys = ("context", "camera", "frames", "tracks", "records")
    for r in ranks:
        if [{k: x[k] for k in keys} for x in r["tracks"]] != [{k: w[k] for k in keys} for w in want] \
                or [x["shard"] for x in r["tracks"]] != [0, 1, 0] or r["rerun"] != []:
            raise AssertionError(f"D1 stats {r['tracks']} / rerun {r['rerun']}")
    with open(os.path.join(out["d1"], "tracks", "manifest.jsonl")) as f:
        manifest = [json.loads(line)["key"] for line in f if line.strip()]
    if manifest != [f"{p['context']}/1" for p in plan]:
        raise AssertionError(f"D1 manifest {manifest}")
    launches = sum_launches(ranks)
    log(f"[D1] sharded_track: headline (denom 1) on 3 segments of 640x960 frames "
        f"{list(D1_LENGTHS)} over {D_WORLD} ranks (gloo): records {[w['records'] for w in want]} "
        f"and gallery sidecars equal to run_segments on the card, detections_only equal to "
        f"run_segment's, manifest {manifest}, rerun empty; world 1 over NCCL equal on "
        f"{plan[1]['context']}; the ranks' tracks {[round(r['seconds']['tracks'], 2) for r in ranks]} s "
        f"and detect {[round(r['seconds']['detect'], 2) for r in ranks]} s, run_segments in this "
        f"process {t_ref:.2f} s; launches (both ranks) {json.dumps(launches)} ({card})")
    if launches["nms_mask"] == 0 or launches["auction"] == 0:
        raise AssertionError("D1: a kernel did not run in the ranks")
    del pipe
    torch.cuda.empty_cache()
    return launches


def phase_d2(np, torch, card, cfg, plan, out, ranks):
    """D2: two config-4 contexts through ``run_context_groups_sharded``
    against ``run_context_groups`` on the card."""
    from waymo_2d_tracking_tpu_torch.pipeline.multicam import MultiCamPipeline, run_context_groups
    from waymo_2d_tracking_tpu_torch.pipeline.run import SegmentFrames

    segs = [SegmentFrames(p["context"], p["camera"], p["timestamps"],
                          frames=np.load(p["path"], mmap_mode="r")) for p in plan]
    mc = MultiCamPipeline(cfg, num_cams=len(cfg.pipeline.cameras), device="cuda", seed=0)
    ref = dist_dir("d2_ref")
    t0 = time.perf_counter()
    want = run_context_groups(mc, segs, ref)
    t_ref = time.perf_counter() - t0
    names = [f"{p['context']}_{p['camera']}.jsonl" for p in plan]
    same_outputs(np, os.path.join(out["d2"], "contexts"), ref, names, "D2 contexts")
    for r in ranks:
        if [{k: v for k, v in x.items() if k != "shard"} for x in r["contexts"]] != want \
                or r["contexts_rerun"] != [] or "pipeline expects 5" not in r["short_context"]:
            raise AssertionError(f"D2 stats {r['contexts']}")
    launches = sum_launches(ranks)
    log(f"[D2] sharded_multicam: config 4, 2 contexts of 5 cameras at 1280x1920, "
        f"{D2_FRAMES} frames, chunk {cfg.pipeline.chunk_frames}, over {D_WORLD} ranks (gloo): "
        f"records {[w['records'] for w in want]} and sidecars equal to run_context_groups on the "
        f"card; rerun empty; a context short of a camera refused; the ranks "
        f"{[round(r['seconds']['contexts'], 2) for r in ranks]} s, run_context_groups in this "
        f"process {t_ref:.2f} s; launches (both ranks) {json.dumps(launches)} ({card})")
    if launches["nms_mask"] == 0 or launches["auction"] == 0:
        raise AssertionError("D2: a kernel did not run in the ranks")
    del mc
    torch.cuda.empty_cache()
    return launches


def phase_d3(np, torch, card, cfgs, ranks, one):
    """D3: one data-parallel step against this process's single-device step
    on the same global batch, for each case, beside the single-device step's
    own spread (its batch's images reversed within each micro-batch); params
    and EMA bit-equal across the ranks after 3 steps; the checkpoint;
    steps/s of two ranks on one card; the world-1 NCCL step."""
    from waymo_2d_tracking_tpu_torch.tools.rank_cases import digest, train_batch
    from waymo_2d_tracking_tpu_torch.train.train import DetectorTrainer, _as_batch

    def single(cfg, perm=None):
        tr = DetectorTrainer(cfg, device="cuda")
        st = tr.create_state(torch.Generator().manual_seed(0))
        batch = train_batch(3, 16, cfg.detector.image_size, True)
        if perm is not None:
            batch = {k: v[perm] for k, v in batch.items()}
        grads, stats, metrics = tr._grads_and_stats(st, _as_batch(batch, tr.device))
        keys = [k for k in grads if not _noise_grad(k)]
        return ({k: grads[k].detach().float().cpu() for k in keys},
                {k: v.float().cpu() for k, v in stats.items()}, float(metrics["loss"]),
                digest(grads))

    def diff(a, b):
        keys = sorted(b[0])
        return {"loss": abs(a[2] - b[2]) / abs(b[2]),
                "tensor": max(_rel_l2(torch, a[0][k], b[0][k]) for k in keys),
                "whole": _rel_l2(torch, torch.cat([a[0][k].reshape(-1) for k in keys]),
                                 torch.cat([b[0][k].reshape(-1) for k in keys])),
                "stats": max(_rel_l2(torch, a[1][k], b[1][k]) for k in b[1])}

    fmt = lambda d: ", ".join(f"{k} {v:.2e}" for k, v in d.items())  # noqa: E731
    for name, cfg in cfgs.items():
        want = single(cfg)
        micro = 16 // cfg.train.grad_accum_steps
        floor = diff(single(cfg, np.concatenate([np.arange(i + micro - 1, i - 1, -1)
                                                 for i in range(0, 16, micro)])), want)
        got = ranks[0]["cases"][name]
        dp = diff(({k: got["grads"][k] for k in want[0]}, got["stats"], got["metrics"]["loss"]),
                  want)
        extra = ""
        if name in one["cases"]:
            o = one["cases"][name]
            extra = (f"; the world-1 NCCL step's gradients "
                     f"{'bit-equal to' if o['grads_digest'] == want[3] else 'differ from'} "
                     f"this process's")
        tol = D3_TOL[cfg.detector.dtype]
        log(f"[D3] train_dp {name}: headline, batch 16 (8 a rank), {D_WORLD} ranks over gloo "
            f"against the single-device step on the card (relative; largest tensor, whole "
            f"gradient): {fmt(dp)}; the single-device step against itself with its images "
            f"reordered: {fmt(floor)}; T1 (card against CPU, float32): 1.1e-5; bounds "
            f"{json.dumps(tol)}{extra} ({card})")
        if len({r["cases"][name]["grads_digest"] for r in ranks}) != 1 or any(
                dp[k] > tol[k] for k in tol):
            raise AssertionError(f"D3 {name}: the data-parallel step differs beyond {tol}")
        torch.cuda.empty_cache()
    if len({r["params_digest"] for r in ranks}) != 1 or len({r["ema_digest"] for r in ranks}) != 1:
        raise AssertionError("D3: params or EMA differ across the ranks after 3 steps")
    if any(r["restored_digest"] != r["params_digest"] + r["ema_digest"] for r in ranks):
        raise AssertionError("D3: the checkpoint saved under the mesh did not restore")
    launches = sum_launches(ranks)
    log(f"[D3] train_dp: params and EMA bit-equal across the ranks after 3 steps; checkpoint "
        f"restored on both; {1 / ranks[0]['step_s']:.3f} steps/s of the global batch of 16, "
        f"bf16 ({ranks[0]['step_s'] * 1e3:.1f} ms a step) with both ranks sharing one card over "
        f"gloo, not a scaling figure; held-out AP of the replicated weights "
        f"{ranks[0]['val']['mAP']:.4f}, the same on both ranks: {ranks[0]['val'] == ranks[1]['val']}; "
        f"launches (validation detects) {json.dumps(launches)} ({card})")
    if launches["nms_mask"] == 0:
        raise AssertionError("D3: the validation detect did not run the NMS kernel")
    return launches


def phase_d4(np, torch, card, cases, ranks, one, links):
    """D4: the ring at world 2 (gloo) and 1 (NCCL) against JAX's rule
    written out (``ring_model``), ties included; ``link_tracks`` with the
    mesh on D1's and D2's sidecars against the dense scoring."""
    from waymo_2d_tracking_tpu_torch.pipeline.link import link_tracks

    for world, got in ((D_WORLD, ranks[0]["rings"]), (D_WORLD, ranks[1]["rings"]),
                       (1, one["rings"])):
        for (q, g, v), (sim, idx) in zip(cases, got):
            wsim, widx = ring_model(np, q, g, v, world)
            if not np.array_equal(idx, widx) or np.abs(sim - wsim).max() > 1e-5:
                raise AssertionError(f"D4 ring at world {world} differs from JAX's rule")
    q, g, _ = cases[1]
    ties = int((ranks[0]["rings"][1][1] != (q @ g.T).argmax(axis=1)).sum())
    merges = []
    for (src, dst, th), rep in zip(links, ranks[0]["reports"]):
        dense = os.path.join(os.path.dirname(dst), "linked_dense")
        want = link_tracks(src, linked_dir=dense, threshold=th)
        if {k: v for k, v in want.items() if k != "out"} != \
                {k: v for k, v in rep.items() if k != "out"}:
            raise AssertionError(f"D4 link report {rep} != {want}")
        for name in os.listdir(dense):
            with open(os.path.join(dense, name), "rb") as a, open(os.path.join(dst, name), "rb") as b:
                if a.read() != b.read():
                    raise AssertionError(f"D4 linked {name} differs from the dense scoring")
        merges.append(rep["cross_camera_merges"])
    log(f"[D4] link_ring: 64 queries against 1024 gallery entries of 128 and the tie case, at "
        f"world 2 (gloo) and 1 (NCCL), equal to JAX's rule (indices exact, similarities within "
        f"1e-5); on ties {ties} of 8 queries take the first shard visited, not the lowest index; "
        f"link_tracks with the mesh on D1's and D2's sidecars equal to the dense scoring "
        f"(cross-camera merges {merges}) ({card})")


def phase_d5(np, torch, card, cfg, d1_plan):
    """D5: ``track``, ``detect``, ``link`` and ``train`` with ``--sharded``
    as two processes started through the ``W2T_*`` variables (gloo on
    cuda:0), against the same verbs unsharded in this process."""
    import socket

    from waymo_2d_tracking_tpu_torch.config import _update
    from waymo_2d_tracking_tpu_torch.parallel.launch import run_ranks
    from waymo_2d_tracking_tpu_torch.tools import rank_cases

    root = dist_dir("d5")
    segs = os.path.join(root, "segs")
    for i, ctx in enumerate(("d5ctxA", "d5ctxB")):
        a = np.load(d1_plan[0]["path"], mmap_mode="r")
        write_dir_segment(np, segs, ctx, 16, [("FRONT", a[32 * i:32 * i + 16]),
                                              ("FRONT_LEFT", a[32 * i + 16:32 * i + 32])])
    yaml_path = write_config(_update(cfg, {
        "pipeline": {"cameras": ["FRONT", "FRONT_LEFT"], "chunk_frames": 16},
        "train": {"batch_size": 8, "warmup_steps": 2, "total_steps": 1000,
                  "reid_loss_weight": 0.5}}), "d5.yaml")

    def verbs(out):
        base = ["--config", yaml_path, "--device", "cuda"]
        return [["track", "--sharded", "--segments-dir", segs, "--out-dir", f"{out}/track"] + base,
                ["detect", "--sharded", "--segments-dir", segs, "--out", f"{out}/det.jsonl"] + base,
                ["link", "--sharded", "--out-dir", f"{out}/track", "--linked-dir",
                 f"{out}/linked", "--device", "cuda"],
                ["train", "--sharded", "--steps", "1"] + base
                + ["--set", f"train.checkpoint_dir={out}/ckpt"]]

    socks = [socket.socket() for _ in range(5)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    shd, plain = os.path.join(root, "shd"), os.path.join(root, "plain")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = run_ranks(rank_cases.cli_case, D_WORLD, "cuda", ports, verbs(shd), device="cuda",
                      timeout=500, workdir=dist_dir("w5"), join=False)
    wall = time.perf_counter() - t0
    if any(r["total"] != 3.0 or not r["joined"] for r in ranks):
        raise AssertionError("D5: the W2T_* processes did not all-reduce to 3")
    t0 = time.perf_counter()
    printed = [cli_quiet([a for a in argv if a != "--sharded"])[1] for argv in verbs(plain)]
    t_plain = time.perf_counter() - t0
    lines = lambda text: [json.loads(x) for x in text if x.startswith("{")]  # noqa: E731
    got = [lines(o.splitlines()) for o in ranks[0]["outs"]]
    want = [lines(p) for p in printed]
    if any(o.strip() for o in ranks[1]["outs"]):
        raise AssertionError("D5: process 1 printed")
    keys = ("context", "camera", "frames", "tracks", "records")
    if [{k: x[k] for k in keys} for x in got[0]] != [{k: x[k] for k in keys} for x in want[0]]:
        raise AssertionError(f"D5 track stats {got[0]} != {want[0]}")
    names = sorted(f for f in os.listdir(f"{plain}/track") if f.endswith(".jsonl")
                   and f != "manifest.jsonl")
    same_outputs(np, f"{shd}/track", f"{plain}/track", names, "D5 track --sharded")
    with open(f"{shd}/det.jsonl", "rb") as a, open(f"{plain}/det.jsonl", "rb") as b:
        if a.read() != b.read():
            raise AssertionError("D5 detect --sharded differs from detect")
    if {k: v for k, v in got[2][0].items() if k != "out"} != \
            {k: v for k, v in want[2][0].items() if k != "out"}:
        raise AssertionError(f"D5 link {got[2]} != {want[2]}")
    same_outputs(np, f"{shd}/linked", f"{plain}/linked", sorted(os.listdir(f"{plain}/linked")),
                 "D5 link --sharded")
    eg = torch.load(got[3][0]["export"], weights_only=True)
    ew = torch.load(want[3][0]["export"], weights_only=True)
    stats_d = max(_rel_l2(torch, eg[k].float(), ew[k].float()) for k in ew
                  if k.endswith(("running_mean", "running_var")))
    params_equal = all(torch.equal(eg[k], ew[k]) for k in ew
                       if not k.endswith(("running_mean", "running_var", "num_batches_tracked")))
    launches = sum_launches(ranks)
    tol = D3_TOL[cfg.detector.dtype]["stats"]
    log(f"[D5] cli_sharded: track, detect, link and train --steps 1 with --sharded as {D_WORLD} "
        f"processes through W2T_* (gloo on cuda:0; all-reduce of pid + 1 gave 3 in both) in "
        f"{wall:.1f} s, the same verbs unsharded in this process in {t_plain:.1f} s: tracks, "
        f"sidecars, merged detections and linked files equal; train's export parameters "
        f"{'bit-equal' if params_equal else 'DIFFER'} (the first update's rate is 0), its "
        f"BatchNorm statistics within {stats_d:.2e} (bound {tol}, D3's); launches (both processes) "
        f"{json.dumps(launches)} ({card})")
    if not params_equal or stats_d > tol:
        raise AssertionError("D5: train --sharded differs from train")
    if launches["nms_mask"] == 0 or launches["auction"] == 0:
        raise AssertionError("D5: a kernel did not run in the processes")
    return launches



def main() -> int:
    # cuBLAS's deterministic workspace, read when its handle is made: T2's
    # checkpoint resume is compared bit for bit
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import numpy as np

    from waymo_2d_tracking_tpu_torch.models import quant
    from waymo_2d_tracking_tpu_torch.ops import _cuda, assign, nms, roi_align, topk
    from waymo_2d_tracking_tpu_torch.ops import window_attention as wa

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(f"[0] {smi}")
    log(f"[0] torch {torch.__version__} cuda {torch.version.cuda}; device {name}; "
        f"count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    _cuda.build_all()
    log(f"[0] built {', '.join(_cuda.KERNELS)} with nvcc in "
        f"{time.perf_counter() - t0:.1f} s ({smi})")
    for kname, text in _cuda.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "smem" in line or "error" in line.lower():
                log(f"[0] ptxas {kname}: {line.strip()}")

    counters = {"nms_mask": nms.nms_mask_cuda, "auction": assign.auction_kernel_cuda,
                "topk_threshold": topk.topk_threshold_cuda, "roi_align": roi_align.roi_align_cuda,
                "int8_gemm": quant.int8_gemm, "window_attention": wa.window_attention_cuda}
    kern = {k: {**v, "library_ms": None} for k, v in phase_kernels(torch, nms, assign, smi).items()}
    kern["topk_threshold"] = phase_topk(torch, topk, smi)
    kern["roi_align"] = phase_roi_align(torch, roi_align, smi)
    kern["window_attention"] = phase_window_attention(torch, wa, smi)
    log(f"[1] launches in phase 1 (comparisons and timing, not a main path): "
        f"{json.dumps({k: fn.launches for k, fn in counters.items()})}")
    phase_downscale(np, torch, smi)
    curved_pan = phase_appearance(np, torch, counters, smi)
    committed = phase_fixtures(np, torch, nms, assign)
    t0 = time.perf_counter()
    serve_fixture = phase_serve_fixture(np, torch, counters, smi, committed["online"])
    log(f"[S1] done in {time.perf_counter() - t0:.1f} s")
    phase_ingest(np, torch, smi, HEADLINE_INT8)
    paths, headline_frames = phase_headlines(np, torch, counters, smi)
    plans = {"d1": save_d1_frames(np, headline_frames)}
    paths.update(phase_new_paths(np, torch, counters, smi, headline_frames, plans))
    paths["serve_fixture"] = serve_fixture
    paths["curved_pan"] = curved_pan
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    paths["serve_headline"] = phase_serve_headline(np, torch, counters, smi, headline_frames)
    log(f"[S2] done in {time.perf_counter() - t0:.1f} s")
    paths["cli"] = phase_cli(np, torch, counters, smi, committed["online"], headline_frames)
    del headline_frames
    torch.cuda.empty_cache()
    paths["train"] = phase_train(np, torch, counters, smi, nms, committed)
    t0 = time.perf_counter()
    try:
        paths.update(phase_distributed(np, torch, smi, plans["d1"], plans["d2"]))
    finally:
        # the frames, outputs and checkpoints of D (gigabytes) are not kept
        shutil.rmtree(dist_dir(), ignore_errors=True)
    log(f"[D] done in {time.perf_counter() - t0:.1f} s")
    # neither the top-k threshold nor the RoIAlign kernel is on a main path
    # (the JAX package runs them only through their own entry points); their
    # counts are 0 there and are reported as they are; the window-attention
    # kernel runs on the Swin-T paths alone (config4_swin_t)
    log(f"[3] launches on the main paths (first run of each): {json.dumps(paths)}")

    sources = {
        "nms_mask": ("waymo_2d_tracking_tpu_torch/csrc/nms.cu",
                     "waymo_2d_tracking_tpu/ops/nms.py:38"),
        "auction": ("waymo_2d_tracking_tpu_torch/csrc/auction.cu",
                    "waymo_2d_tracking_tpu/ops/assign.py:112"),
        "topk_threshold": ("waymo_2d_tracking_tpu_torch/csrc/topk.cu",
                           "waymo_2d_tracking_tpu/ops/topk.py:35"),
        "roi_align": ("waymo_2d_tracking_tpu_torch/csrc/roi_align.cu",
                      "waymo_2d_tracking_tpu/ops/roi_align.py:187"),
        "window_attention": ("waymo_2d_tracking_tpu_torch/csrc/window_attention.cu",
                             "none: the JAX package has no attention backbone"),
    }
    # launches: the headline's first run; launches_by_path: every main path's
    record = {"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": rep,
         "launches": paths["headline"][k],
         "launches_by_path": {path: counts[k] for path, counts in paths.items()}, **kern[k]}
        for k, (src, rep) in sources.items()
    ]}
    log(smi)
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
