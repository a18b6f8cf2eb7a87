"""Deterministic synthetic data, numpy only (counterpart of
``data/synthetic.py``).

- ``generate_clip``: a scripted multi-object clip (constant-velocity objects
  with detection noise, crossings, occlusion gaps, missed and false
  detections, and the hostile-regime knobs) as time-stacked ``Detections``
  plus the clean ground truth, drawing from ``default_rng(seed)`` in the JAX
  package's order, so the same seed gives the same clip;
- ``render_video_clip``: the scripted trajectories drawn as class-coloured
  rectangles on a noise background, pixel for pixel the JAX package's;
- ``render_detection_batch``, ``random_rect_batch`` and
  ``random_rect_batch_reid``: detector-training batches (numpy arrays) from
  a ``np.random.Generator``, the same draws as the JAX package's batch maker
  and its fixture recipe's (``tools/train_pixels_fixture.py``);
- ``scripted_detections``: hand-written per-frame detection lists.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from waymo_2d_tracking_tpu_torch.types import Detections


@dataclasses.dataclass(frozen=True)
class SyntheticClipConfig:
    """The JAX package's clip config: the same fields, names and defaults."""

    num_frames: int = 200
    num_objects: int = 12
    image_size: Tuple[int, int] = (1280, 1920)  # (H, W): Waymo front cam
    max_detections: int = 64
    embed_dim: int = 128
    det_noise_px: float = 2.0       # box center/size jitter
    miss_prob: float = 0.05         # random per-frame missed detection
    false_pos_per_frame: float = 0.5
    occlusion_gap: Tuple[int, int] = (60, 90)   # frames [a, b): objects 0,1 hidden
    embed_noise: float = 0.05
    # frames [a, b): the first dip_objects objects detected at a low score
    dip_window: Tuple[int, int] = (0, 0)
    dip_objects: int = 2
    dip_score_range: Tuple[float, float] = (0.15, 0.4)
    accel: float = 0.0              # per-object |acceleration| <= accel px/frame^2
    pan_amplitude: float = 0.0      # sinusoidal camera pan, px
    pan_period: float = 60.0
    # an object overlapped by a larger present box at IoU > occlusion_dip_iou:
    # low score, 3x box noise, miss probability + occlusion_miss_boost
    occlusion_dip: bool = False
    occlusion_dip_iou: float = 0.25
    occlusion_miss_boost: float = 0.25
    lifespan_frac: Tuple[float, float] = (1.0, 1.0)  # random object lifespans
    distance_noise: bool = False    # noise scaled by 160 / box side in [0.5, 4]
    # per object-frame probability of a high-score ghost twin offset by
    # ghost_offset_frac * box height in place of the true detection
    ghost_prob: float = 0.0
    ghost_offset_frac: Tuple[float, float] = (0.35, 0.5)
    texture_amp: float = 0.0        # identity-bearing grating on each rectangle
    seed: int = 0


def _trajectories(cfg: SyntheticClipConfig):
    """Clean scripted trajectories, drawn from ``default_rng(seed)`` in the
    clip generator's order: (rng after the draws, boxes (T, K, 4) float64,
    present (T, K), canonical embeddings (K, E), widths, heights)."""
    rng = np.random.default_rng(cfg.seed)
    t_total, k = cfg.num_frames, cfg.num_objects
    h_img, w_img = cfg.image_size

    cx0 = rng.uniform(0.1 * w_img, 0.9 * w_img, k)
    cy0 = rng.uniform(0.1 * h_img, 0.9 * h_img, k)
    vx = rng.uniform(-6, 6, k)
    vy = rng.uniform(-3, 3, k)
    bw = rng.uniform(60, 180, k)
    bh = rng.uniform(60, 180, k)
    emb_true = rng.normal(0, 1, (k, max(cfg.embed_dim, 1)))
    emb_true /= np.linalg.norm(emb_true, axis=1, keepdims=True)

    t_axis = np.arange(t_total)
    ax = rng.uniform(-cfg.accel, cfg.accel, k) if cfg.accel else np.zeros(k)
    ay = rng.uniform(-cfg.accel, cfg.accel, k) if cfg.accel else np.zeros(k)
    tt = t_axis[:, None].astype(np.float64)
    cx = cx0[None, :] + vx[None, :] * tt + 0.5 * ax[None, :] * tt**2
    cy = cy0[None, :] + vy[None, :] * tt + 0.5 * ay[None, :] * tt**2
    if cfg.pan_amplitude:
        pan = cfg.pan_amplitude * np.sin(2.0 * np.pi * t_axis / cfg.pan_period)
        cx = cx + pan[:, None]
        cy = cy + 0.5 * pan[:, None]
    gt_boxes = np.stack(
        [cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], axis=-1
    )

    present = (cx > -bw) & (cx < w_img + bw) & (cy > -bh) & (cy < h_img + bh)
    a, b = cfg.occlusion_gap
    if k >= 2 and b > a:
        present[a:b, 0] = False
        present[a:b, 1] = False
    lo, hi = cfg.lifespan_frac
    if hi < 1.0 or lo < 1.0:
        life = rng.uniform(lo, hi, k)
        start = rng.uniform(0, 1.0 - life, k)
        s_f = np.round(start * t_total).astype(int)
        e_f = np.round((start + life) * t_total).astype(int)
        present &= (t_axis[:, None] >= s_f[None, :]) & (t_axis[:, None] < e_f[None, :])
    return rng, gt_boxes, present, emb_true, bw, bh


def _ground_truth(cfg: SyntheticClipConfig) -> dict:
    """Clean ground truth: boxes (T, K, 4) float32, present (T, K), ids,
    classes."""
    _, gt_boxes, present, _, _, _ = _trajectories(cfg)
    k = cfg.num_objects
    return {
        "boxes": gt_boxes.astype(np.float32),
        "present": present,
        "ids": np.arange(k, dtype=np.int32),
        "classes": (np.arange(k) % 3).astype(np.int32),
    }


def _occluded(cfg: SyntheticClipConfig, gt_boxes, present, bw, bh) -> np.ndarray:
    """(T, K): overlapped by a larger present box at IoU > occlusion_dip_iou."""
    t_total, k = present.shape
    occluded = np.zeros((t_total, k), bool)
    if not cfg.occlusion_dip:
        return occluded
    areas = bw * bh
    for t in range(t_total):
        live = np.where(present[t])[0]
        for i in live:
            for j in live:
                if j == i or areas[j] <= areas[i]:
                    continue
                bi, bj = gt_boxes[t, i], gt_boxes[t, j]
                ix1, iy1 = max(bi[0], bj[0]), max(bi[1], bj[1])
                ix2, iy2 = min(bi[2], bj[2]), min(bi[3], bj[3])
                inter = max(ix2 - ix1, 0.0) * max(iy2 - iy1, 0.0)
                union = areas[i] + areas[j] - inter
                if union > 0 and inter / union > cfg.occlusion_dip_iou:
                    occluded[t, i] = True
                    break
    return occluded


def generate_clip(cfg: SyntheticClipConfig = SyntheticClipConfig()):
    """Returns (dets: ``Detections`` stacked (T, D, ...) on the CPU, gt: dict
    of numpy arrays: boxes (T, K, 4), present (T, K), ids (K,), classes
    (K,)), the clean ground truth before noise and misses."""
    rng, gt_boxes, present, emb_true, bw, bh = _trajectories(cfg)
    t_total, k, d = cfg.num_frames, cfg.num_objects, cfg.max_detections
    h_img, w_img = cfg.image_size
    occluded = _occluded(cfg, gt_boxes, present, bw, bh)

    boxes = np.zeros((t_total, d, 4), np.float32)
    scores = np.zeros((t_total, d), np.float32)
    classes = np.zeros((t_total, d), np.int32)
    embeds = np.zeros((t_total, d, max(cfg.embed_dim, 1)), np.float32)
    valid = np.zeros((t_total, d), bool)
    for t in range(t_total):
        rows = []
        for obj in range(k):
            miss_p = cfg.miss_prob
            if occluded[t, obj]:
                miss_p = min(miss_p + cfg.occlusion_miss_boost, 0.95)
            if not present[t, obj] or rng.uniform() < miss_p:
                continue
            if cfg.ghost_prob > 0.0 and rng.uniform() < cfg.ghost_prob:
                # the true detection replaced by an offset twin carrying the
                # object's own appearance
                frac = rng.uniform(*cfg.ghost_offset_frac)
                ang = rng.uniform(0, 2 * np.pi)
                off = frac * bh[obj] * np.array(
                    [np.cos(ang), np.sin(ang), np.cos(ang), np.sin(ang)])
                e = emb_true[obj] + rng.normal(0, cfg.embed_noise, emb_true.shape[1])
                e /= np.linalg.norm(e)
                rows.append((gt_boxes[t, obj] + off, rng.uniform(0.85, 0.95), obj % 3, e))
                continue
            noise_px = cfg.det_noise_px
            if cfg.distance_noise:
                side = float(np.sqrt(bw[obj] * bh[obj]))
                noise_px *= float(np.clip(160.0 / max(side, 1.0), 0.5, 4.0))
            if occluded[t, obj]:
                noise_px *= 3.0
            box = gt_boxes[t, obj] + rng.normal(0, noise_px, 4)
            e = emb_true[obj] + rng.normal(0, cfg.embed_noise, emb_true.shape[1])
            e /= np.linalg.norm(e)
            da, db = cfg.dip_window
            if (da <= t < db and obj < cfg.dip_objects) or occluded[t, obj]:
                score = rng.uniform(*cfg.dip_score_range)
            else:
                score = rng.uniform(0.8, 1.0)
            rows.append((box, score, obj % 3, e))
        # false positives: 80 px boxes with a middling score
        for _ in range(rng.poisson(cfg.false_pos_per_frame)):
            x = rng.uniform(0, w_img - 80)
            y = rng.uniform(0, h_img - 80)
            e = rng.normal(0, 1, emb_true.shape[1])
            e /= np.linalg.norm(e)
            rows.append((np.array([x, y, x + 80, y + 80]), rng.uniform(0.5, 0.7), 0, e))
        rows.sort(key=lambda r: -r[1])      # score order, like NMS output
        for i, (box, sc, cl, e) in enumerate(rows[:d]):
            boxes[t, i] = box
            scores[t, i] = sc
            classes[t, i] = cl
            embeds[t, i] = e
            valid[t, i] = True

    dets = Detections(boxes=torch.from_numpy(boxes), scores=torch.from_numpy(scores),
                      classes=torch.from_numpy(classes), embeds=torch.from_numpy(embeds),
                      valid=torch.from_numpy(valid))
    gt = {
        "boxes": gt_boxes.astype(np.float32),
        "present": present,
        "ids": np.arange(k, dtype=np.int32),
        "classes": (np.arange(k) % 3).astype(np.int32),
    }
    return dets, gt


RENDER_COLORS = np.array(
    [[0.9, 0.2, 0.2], [0.2, 0.9, 0.2], [0.2, 0.2, 0.9]], np.float32
)


def draw_rect_objects(image, boxes, classes, brightness=None,
                      tex_theta=None, tex_lambda=None, tex_amp=0.0):
    """Draw class-coloured rectangles onto a float (H, W, 3) image IN PLACE.

    boxes (N, 4) xyxy pixels (clipped here); later boxes draw on top. With
    ``tex_amp > 0`` each rectangle carries an object-anchored sinusoidal
    grating of orientation ``tex_theta`` and wavelength ``tex_lambda`` --
    an identity-bearing texture that survives the ReID tower's GroupNorm.
    """
    h, w = image.shape[:2]
    for i in range(len(boxes)):
        x1, y1, x2, y2 = boxes[i]
        fx1, fy1 = float(boxes[i][0]), float(boxes[i][1])
        x1 = int(max(x1, 0)); y1 = int(max(y1, 0))
        x2 = int(min(x2, w)); y2 = int(min(y2, h))
        if x2 <= x1 or y2 <= y1:
            continue
        color = RENDER_COLORS[int(classes[i]) % len(RENDER_COLORS)]
        if brightness is not None:
            color = np.clip(color * float(brightness[i]), 0.0, 1.0)
        if tex_amp > 0.0 and tex_theta is not None:
            yy, xx = np.mgrid[y1:y2, x1:x2].astype(np.float32)
            xx -= fx1
            yy -= fy1
            th = float(tex_theta[i])
            lam = max(float(tex_lambda[i]), 2.0)
            phase = 2.0 * np.pi * (xx * np.cos(th) + yy * np.sin(th)) / lam
            mod = 1.0 + tex_amp * np.sin(phase)
            image[y1:y2, x1:x2] = np.clip(
                color[None, None, :] * mod[:, :, None], 0.0, 1.0
            )
        else:
            image[y1:y2, x1:x2] = color
    return image


def render_video_clip(
    cfg: SyntheticClipConfig,
    render_hw: Tuple[int, int] = (256, 384),
    bg_mean: float = 0.45,
    bg_noise: float = 0.08,
):
    """Render a temporally consistent RGB clip of the scripted trajectories.

    Returns (frames_u8 (T, H, W, 3), gt) with gt boxes in RENDER pixels,
    clipped to the frame; ``present`` also requires >= 40% of the box area
    inside the frame.
    """
    gt = _ground_truth(cfg)
    t_total, k = gt["boxes"].shape[:2]
    hr, wr = render_hw
    hc, wc = cfg.image_size
    sxy = np.array([wr / wc, hr / hc, wr / wc, hr / hc], np.float32)
    boxes = gt["boxes"] * sxy

    rng = np.random.default_rng(cfg.seed + 7777)
    brightness = rng.uniform(0.75, 1.15, k)
    tex_theta = tex_lambda = None
    if cfg.texture_amp > 0.0:
        tex_theta = rng.uniform(0.0, np.pi, k)
        tex_lambda = rng.uniform(4.0, 12.0, k)

    clipped = boxes.copy()
    clipped[..., 0::2] = np.clip(clipped[..., 0::2], 0, wr)
    clipped[..., 1::2] = np.clip(clipped[..., 1::2], 0, hr)
    area = np.maximum(boxes[..., 2] - boxes[..., 0], 0) * np.maximum(
        boxes[..., 3] - boxes[..., 1], 0
    )
    area_in = np.maximum(clipped[..., 2] - clipped[..., 0], 0) * np.maximum(
        clipped[..., 3] - clipped[..., 1], 0
    )
    present = gt["present"] & (area_in >= 0.4 * np.maximum(area, 1e-6))

    frames = np.empty((t_total, hr, wr, 3), np.uint8)
    for t in range(t_total):
        img = rng.normal(bg_mean, bg_noise, (hr, wr, 3)).astype(np.float32)
        live = np.where(present[t])[0]
        draw_rect_objects(
            img, clipped[t, live], gt["classes"][live], brightness[live],
            tex_theta=None if tex_theta is None else tex_theta[live],
            tex_lambda=None if tex_lambda is None else tex_lambda[live],
            tex_amp=cfg.texture_amp,
        )
        frames[t] = (np.clip(img, 0, 1) * 255).astype(np.uint8)

    gt_render = {
        "boxes": clipped.astype(np.float32),
        "present": present,
        "ids": gt["ids"],
        "classes": gt["classes"],
    }
    return frames, gt_render


def render_detection_batch(rng: np.random.Generator, batch_size: int,
                           image_hw: Tuple[int, int], max_gt: int = 8,
                           num_classes: int = 3) -> dict:
    """Detector-training batch: solid coloured rectangles on noise with the
    padded GT. Returns numpy images (N,H,W,3) f32, gt_boxes (N,G,4),
    gt_classes (N,G), gt_valid (N,G)."""
    h, w = image_hw
    images = rng.normal(0.45, 0.08, (batch_size, h, w, 3)).astype(np.float32)
    gt_boxes = np.zeros((batch_size, max_gt, 4), np.float32)
    gt_classes = np.zeros((batch_size, max_gt), np.int32)
    gt_valid = np.zeros((batch_size, max_gt), bool)
    colors = np.array([[0.9, 0.2, 0.2], [0.2, 0.9, 0.2], [0.2, 0.2, 0.9]])
    for n in range(batch_size):
        for g in range(rng.integers(1, max_gt + 1)):
            bw = rng.uniform(0.1 * w, 0.4 * w)
            bh = rng.uniform(0.1 * h, 0.4 * h)
            x1 = rng.uniform(0, w - bw)
            y1 = rng.uniform(0, h - bh)
            cls = int(rng.integers(0, num_classes))
            images[n, int(y1): int(y1 + bh), int(x1): int(x1 + bw)] = colors[cls]
            gt_boxes[n, g] = [x1, y1, x1 + bw, y1 + bh]
            gt_classes[n, g] = cls
            gt_valid[n, g] = True
    return {"images": images, "gt_boxes": gt_boxes, "gt_classes": gt_classes,
            "gt_valid": gt_valid}


# the grating amplitude of the ReID recipe's identities (and of the recovery
# clip's SyntheticClipConfig.texture_amp)
TEX_AMP = 0.25


def random_rect_batch(rng: np.random.Generator, batch_size: int,
                      image_hw: Tuple[int, int] = (256, 384), max_gt: int = 16) -> dict:
    """The pixel fixture's training batch: 1-10 rectangles of 12-56 px (some
    clipping the edge) on a noise background, the palette and per-object
    brightness of ``draw_rect_objects``, GT clipped to the frame."""
    h, w = image_hw
    images = np.empty((batch_size, h, w, 3), np.float32)
    gt_boxes = np.zeros((batch_size, max_gt, 4), np.float32)
    gt_classes = np.zeros((batch_size, max_gt), np.int32)
    gt_valid = np.zeros((batch_size, max_gt), bool)
    for n in range(batch_size):
        img = rng.normal(0.45, 0.08, (h, w, 3)).astype(np.float32)
        n_obj = int(rng.integers(1, 11))
        boxes = np.zeros((n_obj, 4), np.float32)
        classes = rng.integers(0, 3, n_obj)
        for g in range(n_obj):
            bw = rng.uniform(12, 56)
            bh = rng.uniform(12, 56)
            x1 = rng.uniform(-0.2 * bw, w - 0.8 * bw)
            y1 = rng.uniform(-0.2 * bh, h - 0.8 * bh)
            boxes[g] = [x1, y1, x1 + bw, y1 + bh]
        draw_rect_objects(img, boxes, classes, rng.uniform(0.75, 1.15, n_obj))
        images[n] = img
        boxes[:, 0::2] = np.clip(boxes[:, 0::2], 0, w)
        boxes[:, 1::2] = np.clip(boxes[:, 1::2], 0, h)
        gt_boxes[n, :n_obj] = boxes
        gt_classes[n, :n_obj] = classes
        gt_valid[n, :n_obj] = True
    return {"images": images, "gt_boxes": gt_boxes, "gt_classes": gt_classes,
            "gt_valid": gt_valid}


def random_rect_batch_reid(rng: np.random.Generator, batch_size: int, n_ids: int = 24,
                           image_hw: Tuple[int, int] = (256, 384), max_gt: int = 16) -> dict:
    """Identity-aware batch for the ReID losses: a pool of ``n_ids``
    identities (class colour, brightness on an evenly spaced grid per class,
    texture grating orientation and wavelength), 4-8 of them drawn per image
    at random positions and sizes, ``gt_track_ids`` the identity index."""
    h, w = image_hw
    per_class = (n_ids + 2) // 3
    id_class = np.repeat(np.arange(3), per_class)[:n_ids]
    grid = np.linspace(0.75, 1.15, per_class)
    id_bright = np.concatenate([rng.permutation(grid) for _ in range(3)])[:n_ids] \
        + rng.uniform(-0.008, 0.008, n_ids)
    id_theta = rng.uniform(0.0, np.pi, n_ids)
    id_lambda = rng.uniform(4.0, 12.0, n_ids)
    images = np.empty((batch_size, h, w, 3), np.float32)
    gt_boxes = np.zeros((batch_size, max_gt, 4), np.float32)
    gt_classes = np.zeros((batch_size, max_gt), np.int32)
    gt_valid = np.zeros((batch_size, max_gt), bool)
    gt_track_ids = np.full((batch_size, max_gt), -1, np.int32)
    for n in range(batch_size):
        img = rng.normal(0.45, 0.08, (h, w, 3)).astype(np.float32)
        n_obj = int(rng.integers(4, 9))
        ids = rng.choice(n_ids, size=n_obj, replace=False)
        boxes = np.zeros((n_obj, 4), np.float32)
        for g in range(n_obj):
            bw = rng.uniform(12, 56)
            bh = rng.uniform(12, 56)
            x1 = rng.uniform(-0.2 * bw, w - 0.8 * bw)
            y1 = rng.uniform(-0.2 * bh, h - 0.8 * bh)
            boxes[g] = [x1, y1, x1 + bw, y1 + bh]
        draw_rect_objects(img, boxes, id_class[ids], id_bright[ids],
                          tex_theta=id_theta[ids], tex_lambda=id_lambda[ids], tex_amp=TEX_AMP)
        images[n] = img
        boxes[:, 0::2] = np.clip(boxes[:, 0::2], 0, w)
        boxes[:, 1::2] = np.clip(boxes[:, 1::2], 0, h)
        gt_boxes[n, :n_obj] = boxes
        gt_classes[n, :n_obj] = id_class[ids]
        gt_valid[n, :n_obj] = True
        gt_track_ids[n, :n_obj] = ids
    return {"images": images, "gt_boxes": gt_boxes, "gt_classes": gt_classes,
            "gt_valid": gt_valid, "gt_track_ids": gt_track_ids}


def scripted_detections(frames) -> Detections:
    """Hand-written per-frame detection lists -> stacked ``Detections``.
    frames: list of lists of (box4, score, cls); embeds are zeros."""
    d = max(max((len(f) for f in frames), default=1), 1)
    t_total = len(frames)
    boxes = np.zeros((t_total, d, 4), np.float32)
    scores = np.zeros((t_total, d), np.float32)
    classes = np.zeros((t_total, d), np.int32)
    valid = np.zeros((t_total, d), bool)
    for t, frame in enumerate(frames):
        for i, (box, sc, cl) in enumerate(frame):
            boxes[t, i] = box
            scores[t, i] = sc
            classes[t, i] = cl
            valid[t, i] = True
    return Detections(boxes=torch.from_numpy(boxes), scores=torch.from_numpy(scores),
                      classes=torch.from_numpy(classes),
                      embeds=torch.zeros((t_total, d, 1), dtype=torch.float32),
                      valid=torch.from_numpy(valid))
